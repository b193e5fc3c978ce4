// Unbanded Smith-Waterman scoring over the whole window, with the window
// gather fused in, for Hopper (sm_90a).  Built by ema_tpu_torch/ops/_build.py
// with nvcc into a plain-C shared library.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_kernel (behind
// sw_score_batch_pallas, the drop-in for the XLA sw.sw_score_batch that
// serves EMA_TPU_SW_IMPL=scan), whose lanes are read rows 0..m and whose
// loop runs the anti-diagonals d = 1..m+n.  Its plain PyTorch twin is
// ema_tpu_torch/ops/sw.py:sw_score_batch_ref.  Cell (i, j), read row i
// against window column j, both from 1:
//   Hdiag = max(H[i-1][j-1], fresh) + sub    fresh = 0 at i == 1 else -clip
//   V = max(H[i-1][j] - go - ge, V[i-1][j] - ge)
//   D = max(H[i][j-1] - go - ge, D[i][j-1] - ge)
//   H = max(Hdiag, D, V), start rows merged diag >= D >= V.
// A cell's value and start row do not depend on the sweep order; only the
// pick does: per row the first strict improvement in ascending d = i + j,
// across rows the max score, then min d, then min row.  This kernel folds
// every valid cell into that order directly (max score, min d, min i).
//
// Layout: one warp per candidate.  Thread t owns R consecutive read rows
// (R = 32 covers reads up to 1024 bp) with their H, D and start rows in
// registers, and sweeps the window columns one step behind thread t - 1:
// at step s it scores column s - t + 1 for all its rows, top to bottom,
// taking the row above its first from thread t - 1 by one __shfl_up_sync
// per value (this column's H, V and starts, and the previous column's H
// and start for the diagonal).
//
// What bounds it on this card: integer ALU work and latency over rl x nl
// cells, the whole window, some 25 integer operations per cell, plus a
// fill of one step per active thread.  One text byte is read per thread
// and step; the read row stays in registers.

#include "sw_common.cuh"

namespace {

using sw::Best;
using sw::kFull;
using sw::NEG;

constexpr int kMaxRows = 32 * 32;   // 32 threads x 32 rows

template <int R>
__global__ void __launch_bounds__(128)
sw_batch_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                const uint8_t *__restrict__ oriented, int64_t L,
                const int32_t *__restrict__ olens,
                const int32_t *__restrict__ owners,
                const int64_t *__restrict__ win_lo,
                const int32_t *__restrict__ win_len, int64_t N,
                sw::Scoring p, int32_t *__restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t b = (int64_t)blockIdx.x * 4 + (threadIdx.x >> 5);
    if (b >= N) return;  // b is uniform over the warp: it exits as a whole

    const int32_t owner = owners[b];
    const int32_t rl = olens[owner];
    const int64_t lo = win_lo[b];
    const int32_t nl = win_len[b];
    const uint8_t *read = oriented + (int64_t)owner * L;
    const int32_t goe = p.gap_open + p.gap_extend;
    const int32_t ge = p.gap_extend;
    const int32_t i0 = lane * R + 1;          // this thread's first row

    // this thread's read bases (4 past the read) and row state at the
    // previous column: H, D (the gap along the window) and their starts
    int32_t rc[R], H[R], D[R], SH[R], SD[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int32_t i = i0 + r;
        rc[r] = i <= rl ? (int32_t)read[i - 1] : 4;
        H[r] = NEG; D[r] = NEG; SH[r] = 0; SD[r] = 0;
    }
    // the row above this thread's first (from thread t - 1; read row 0,
    // all NEG, for thread 0): u at this column, g at the previous one
    int32_t uH = NEG, uV = NEG, uSH = 0, uSV = 0, gH = NEG, gSH = 0;
    // this thread's last row at the last column it scored
    int32_t oH = NEG, oV = NEG, oSH = 0, oSV = 0;
    Best best{NEG, 0, 0, 0, 0};   // x unused: ref_end = d - i

    const int32_t active = (rl + R - 1) / R;  // threads holding read rows
    const int32_t steps = (rl > 0 && nl > 0) ? nl + active - 1 : 0;
    for (int32_t s = 0; s < steps; ++s) {
        const int32_t j = s - lane + 1;
        if (j >= 1 && j <= nl && lane < active) {
            const int32_t fc = sw::text_at(text, text_n, lo + j - 1);
            int32_t upH = uH, upV = uV, upSH = uSH, upSV = uSV;
            int32_t dgH = gH, dgSH = gSH;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int32_t i = i0 + r;
                const bool valid = i <= rl;
                const int32_t fresh = (i == 1) ? 0 : -p.clip;
                const int32_t hdg = (dgH >= fresh ? dgH : fresh)
                    + sw::sub_score(rc[r], fc, p);
                const int32_t sdg = dgH >= fresh ? dgSH : i - 1;
                const int32_t vo = upH - goe, ve = upV - ge;
                const int32_t v = vo >= ve ? vo : ve;
                const int32_t sv = vo >= ve ? upSH : upSV;
                const int32_t dopen = H[r] - goe, dext = D[r] - ge;
                const int32_t dd = dopen >= dext ? dopen : dext;
                const int32_t sdd = dopen >= dext ? SH[r] : SD[r];
                const int32_t dv = dd >= v ? dd : v;
                const int32_t h = hdg >= dv ? hdg : dv;
                const int32_t sh = hdg >= dv ? sdg : (dd >= v ? sdd : sv);
                // this row at the previous column is the next row's diagonal
                dgH = H[r];
                dgSH = SH[r];
                H[r] = valid ? h : NEG;
                D[r] = valid ? dd : NEG;
                SH[r] = sh;
                SD[r] = sdd;
                upH = H[r];
                upV = valid ? v : NEG;
                upSH = sh;
                upSV = sv;
                if (valid) {
                    const int32_t cand = h + (i == rl ? 0 : -p.clip);
                    best.offer(Best{cand, i + j, i, 0, sh});
                }
            }
            oH = upH; oV = upV; oSH = upSH; oSV = upSV;
        }
        // hand this thread's last row to the next thread
        gH = uH;
        gSH = uSH;
        uH = __shfl_up_sync(kFull, oH, 1);
        uV = __shfl_up_sync(kFull, oV, 1);
        uSH = __shfl_up_sync(kFull, oSH, 1);
        uSV = __shfl_up_sync(kFull, oSV, 1);
        if (lane == 0) { uH = NEG; uV = NEG; uSH = 0; uSV = 0; }
    }

    best = sw::reduce_best<32>(best);
    if (lane == 0) {
        int32_t *o = out + b * 4;
        o[0] = best.v;
        o[1] = best.s;
        o[2] = best.i;
        o[3] = best.d - best.i;
    }
}

template <int R>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len, int64_t N,
            sw::Scoring p, int32_t *out, cudaStream_t stream) {
    const int64_t blocks = (N + 3) / 4;
    sw_batch_kernel<R><<<(unsigned)blocks, 128, 0, stream>>>(
        text, text_n, oriented, L, olens, owners, win_lo, win_len, N, p,
        out);
}

}  // namespace

extern "C" {

// Scores N candidates over their whole windows into out (int32 [N, 4]:
// score, qb, qe, ref_end) on `stream`.  Read rows are oriented[owner] of
// width L <= 1024, which picks the rows per thread; wl and max_wl are not
// read (the corridor is the window).  Returns the launch's
// cudaGetLastError(); does not synchronise.
int sw_batch_launch(const void *text, int64_t text_n, const void *oriented,
                    int64_t L, const void *olens, const void *owners,
                    const void *win_lo, const void *win_len, const void *wl,
                    int64_t N, int32_t max_wl, int32_t match,
                    int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                    int32_t clip, void *out, void *stream) {
    (void)wl;
    (void)max_wl;
    if (N <= 0) return 0;
    if (L < 0 || L > kMaxRows) return (int)cudaErrorInvalidValue;
    const sw::Scoring p{match, mismatch, gap_open, gap_extend, clip};
    const auto *t = static_cast<const uint8_t *>(text);
    const auto *o = static_cast<const uint8_t *>(oriented);
    const auto *ol = static_cast<const int32_t *>(olens);
    const auto *ow = static_cast<const int32_t *>(owners);
    const auto *lo = static_cast<const int64_t *>(win_lo);
    const auto *ln = static_cast<const int32_t *>(win_len);
    auto *res = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const int64_t rows = (L + 31) / 32;       // rows per thread
    if (rows <= 1)
        launch<1>(t, text_n, o, L, ol, ow, lo, ln, N, p, res, s);
    else if (rows <= 2)
        launch<2>(t, text_n, o, L, ol, ow, lo, ln, N, p, res, s);
    else if (rows <= 4)
        launch<4>(t, text_n, o, L, ol, ow, lo, ln, N, p, res, s);
    else if (rows <= 8)
        launch<8>(t, text_n, o, L, ol, ow, lo, ln, N, p, res, s);
    else if (rows <= 16)
        launch<16>(t, text_n, o, L, ol, ow, lo, ln, N, p, res, s);
    else
        launch<32>(t, text_n, o, L, ol, ow, lo, ln, N, p, res, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
