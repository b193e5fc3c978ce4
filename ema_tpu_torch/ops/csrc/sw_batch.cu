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
// across rows the max score, then min d, then min row.
//
// Layout: a group of G = 8 or 32 threads per candidate (4 or 1 candidates
// a warp), chosen with the rows per thread R from the longest read of the
// call and from its size (the table at the bottom).  Thread t
// of a group owns R consecutive read rows with their H, D and start rows
// in registers and sweeps the window columns one step behind thread t - 1:
// at step s it scores column s - t + 1 for all its rows, top to bottom.
// The row above its first comes from thread t - 1 in three shuffles per
// step (H, V, and both start rows in one word: rows stay below 1024), so
// a thread of 13 rows spreads the hand-over over 13 cells where one of 4
// rows spread it over 4, and a 100 bp read on 8 x 13 idles 7 steps of
// skew where 32 x 4 idled 24 with 7 of its 32 threads holding no row.
//
// What each cell no longer pays:
//   * the best cell is kept per row (value, column and start in two
//     registers) by a strict > alone: within a row the columns come in
//     ascending d.  The end-of-read penalty is constant along a row, so it
//     is added once, after the sweep, when the rows are merged by the full
//     rule (max score, min d, min row) and reduced over the group;
//   * validity: rows past the read feed only rows further past it, so
//     they run unmasked and are left out of the merge; columns outside
//     1..nl are never visited;
//   * every max with a start row is __vibmax_s32 (the max and its
//     predicate) and one select;
//   * the substitution score is one byte permute (prmt): each window column
//     carries a word of four score bytes, one per read base (all -1 for a
//     column that is N or outside the text), each row a selector that
//     sign-extends its base's byte (a read N selects a -1 byte of the
//     second operand).  Scores must fit a signed byte;
//   * the window is read once a candidate: every G steps a group loads
//     its next G columns, one byte a thread, side by side, and builds
//     their score words; thread 0 takes its column's word by one shuffle
//     and the word then travels down the wavefront with the row state.
//
// What bounds it on this card: integer ALU work and latency over rl x nl
// cells, the whole window (tools/bench_sw.py counts 22 instructions a
// cell at the least), plus a fill of one step per active thread.

#include "sw_common.cuh"

namespace {

using sw::Best;
using sw::kFull;
using sw::NEG;

constexpr int kMaxRows = 32 * 32;   // 32 threads x 32 rows
constexpr int kStartBits = 10;      // start rows and rows stay below 1024
constexpr int32_t kStartMask = (1 << kStartBits) - 1;
// A call of short reads takes 8 threads a candidate once it holds more
// than this many candidates for each SM of the card; a smaller call is
// bound by the latency of one candidate's sweep and takes a whole warp.
// (100 bp reads in 148-column windows on 132 SMs: 8 threads take 0.057 ms
// up to 2,048 candidates; a warp each takes 0.032 ms to 512, 0.047 at
// 1,024 = 7.8 an SM, 0.062 from 1,152 = 8.7 an SM, 0.079 from 1,792;
// chip_smoke.py times both around this size.)
constexpr int64_t kWarpCallPerSm = 8;

// the four score bytes of a window column, one per read base 0..3
__device__ __forceinline__ uint32_t score_word(int32_t fc, uint32_t all_mm,
                                               uint32_t delta) {
    return fc >= 4 ? 0xffffffffu : all_mm ^ (delta << (8 * fc));
}

template <int R, int G>
__global__ void __launch_bounds__(128)
sw_batch_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                const uint8_t *__restrict__ oriented, int64_t L,
                const int32_t *__restrict__ olens,
                const int32_t *__restrict__ owners,
                const int64_t *__restrict__ win_lo,
                const int32_t *__restrict__ win_len, int64_t N,
                sw::Scoring p, int32_t *__restrict__ out) {
    constexpr int kPerBlock = 128 / G;
    const int sl = threadIdx.x & (G - 1);            // thread in its group
    const int64_t b = (int64_t)blockIdx.x * kPerBlock + threadIdx.x / G;
    const bool live = b < N;
    // a whole-warp candidate leaves as a whole; a part-warp group past N
    // stays for its partners' shuffles with no rows and no columns
    if (G == 32 && !live) return;

    int32_t rl = 0, nl = 0;
    int64_t lo = 0;
    const uint8_t *read = oriented;
    if (live) {
        const int32_t owner = owners[b];
        rl = olens[owner];
        lo = win_lo[b];
        nl = win_len[b];
        read = oriented + (int64_t)owner * L;
    }
    const int32_t goe = p.gap_open + p.gap_extend;
    const int32_t ge = p.gap_extend;
    const int32_t i0 = sl * R + 1;            // this thread's first row
    const uint32_t all_mm = 0x01010101u * (uint32_t)((-p.mismatch) & 0xff);
    const uint32_t delta = (uint32_t)(((-p.mismatch) ^ p.match) & 0xff);

    // per row: the selector that sign-extends the score byte of its read
    // base (byte 4, of the all -1 operand, past the read or on an N), the
    // state at the previous column (H, the gap along the window D, their
    // start rows) and the row's best cell: its H and column << 10 | start
    uint32_t sel[R];
    int32_t H[R], D[R], SH[R], SD[R], BV[R], BP[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int32_t i = i0 + r;
        const uint32_t rc = i <= rl ? (uint32_t)read[i - 1] : 4u;
        const uint32_t byte = rc >= 4 ? 4u : rc;
        sel[r] = byte | (8u | byte) * 0x1110u;
        H[r] = NEG; D[r] = NEG; SH[r] = 0; SD[r] = 0;
        BV[r] = NEG; BP[r] = 0;
    }
    // the row above this thread's first (from thread t - 1; read row 0,
    // all NEG, for thread 0): u at this column, g at the previous one
    int32_t uH = NEG, uV = NEG, uSH = 0, uSV = 0, gH = NEG, gSH = 0;
    // this thread's last row at the last column it scored
    int32_t oH = NEG, oV = NEG, oS = 0;
    uint32_t word = 0xffffffffu;      // score word of this thread's column
    uint32_t buf = 0xffffffffu;       // that of column s0 + sl + 1

    const int32_t active = (rl + R - 1) / R;  // threads holding read rows
    int32_t steps = (rl > 0 && nl > 0) ? nl + active - 1 : 0;
    // the groups of one warp run the longest of their sweeps
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
        const int32_t o = __shfl_xor_sync(kFull, steps, off);
        steps = o > steps ? o : steps;
    }

    for (int32_t s = 0; s < steps; ++s) {
        if ((s & (G - 1)) == 0)
            buf = score_word(sw::text_at(text, text_n, lo + s + sl), all_mm,
                             delta);
        const uint32_t w0 = __shfl_sync(kFull, buf, s & (G - 1), G);
        if (sl == 0) word = w0;
        const int32_t j = s - sl + 1;
        if (j >= 1 && j <= nl && sl < active) {
            const int32_t jp = j << kStartBits;
            int32_t upH = uH, upV = uV, upSH = uSH, upSV = uSV;
            int32_t dgH = gH, dgSH = gSH;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int32_t fresh = (r == 0 && sl == 0) ? 0 : -p.clip;
                const int32_t sub =
                    (int32_t)sw::prmt(word, 0xffffffffu, sel[r]);
                bool pd, pv, ph, pdv, pm;
                const int32_t hdg = __vibmax_s32(dgH, fresh, &pd) + sub;
                const int32_t sdg = pd ? dgSH : i0 + r - 1;
                const int32_t v = __vibmax_s32(upH - goe, upV - ge, &pv);
                const int32_t sv = pv ? upSH : upSV;
                const int32_t dd = __vibmax_s32(H[r] - goe, D[r] - ge, &ph);
                const int32_t sdd = ph ? SH[r] : SD[r];
                const int32_t dv = __vibmax_s32(dd, v, &pdv);
                const int32_t sdv = pdv ? sdd : sv;
                const int32_t h = __vibmax_s32(hdg, dv, &pm);
                const int32_t sh = pm ? sdg : sdv;
                // this row at the previous column is the next row's diagonal
                dgH = H[r];
                dgSH = SH[r];
                H[r] = h; D[r] = dd; SH[r] = sh; SD[r] = sdd;
                upH = h; upV = v; upSH = sh; upSV = sv;
                bool keep;     // the first strict improvement of the row
                BV[r] = __vibmax_s32(BV[r], h, &keep);
                BP[r] = keep ? BP[r] : (jp | sh);
            }
            oH = upH; oV = upV; oS = upSH | (upSV << kStartBits);
        }
        // hand this thread's last row and its column to the next thread
        gH = uH;
        gSH = uSH;
        uH = __shfl_up_sync(kFull, oH, 1, G);
        uV = __shfl_up_sync(kFull, oV, 1, G);
        const int32_t uS = __shfl_up_sync(kFull, oS, 1, G);
        word = __shfl_up_sync(kFull, word, 1, G);
        uSH = uS & kStartMask;
        uSV = uS >> kStartBits;
        if (sl == 0) { uH = NEG; uV = NEG; uSH = 0; uSV = 0; }
    }

    // the rows of the read, merged by the full rule: the end-of-read
    // penalty, then max score, min d, min row (x unused: ref_end = d - i)
    Best best{NEG, 0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int32_t i = i0 + r;
        if (i <= rl && nl > 0) {
            const int32_t cand = BV[r] + (i == rl ? 0 : -p.clip);
            best.offer(Best{cand, i + (BP[r] >> kStartBits), i, 0,
                            BP[r] & kStartMask});
        }
    }
    best = sw::reduce_best<G>(best);
    if (sl == 0 && live) {
        int32_t *o = out + b * 4;
        o[0] = best.v;
        o[1] = best.s;
        o[2] = best.i;
        o[3] = best.d - best.i;
    }
}

struct Args {
    const uint8_t *text;
    int64_t text_n;
    const uint8_t *oriented;
    int64_t L;
    const int32_t *olens, *owners;
    const int64_t *win_lo;
    const int32_t *win_len;
    int64_t N;
    sw::Scoring p;
    int32_t *out;
    cudaStream_t stream;
};

template <int R, int G>
void launch(const Args &a) {
    constexpr int per_block = 128 / G;
    const int64_t blocks = (a.N + per_block - 1) / per_block;
    sw_batch_kernel<R, G><<<(unsigned)blocks, 128, 0, a.stream>>>(
        a.text, a.text_n, a.oriented, a.L, a.olens, a.owners, a.win_lo,
        a.win_len, a.N, a.p, a.out);
}

// The thread forms, rows a thread by threads a candidate:
//   8 threads   4, 7, 10, 13 rows    reads to 32, 56, 80, 104 bp
//   32 threads  4, 8, 16, 24, 32     reads to 128, 256, 512, 768, 1024
// Returns false when `group` threads hold no form of `rows` rows.
bool launch_form(int group, int64_t rows, const Args &a) {
    if (group == 8) {
        if (rows <= 32) launch<4, 8>(a);
        else if (rows <= 56) launch<7, 8>(a);
        else if (rows <= 80) launch<10, 8>(a);
        else if (rows <= 104) launch<13, 8>(a);
        else return false;
    } else {
        if (rows <= 128) launch<4, 32>(a);
        else if (rows <= 256) launch<8, 32>(a);
        else if (rows <= 512) launch<16, 32>(a);
        else if (rows <= 768) launch<24, 32>(a);
        else launch<32, 32>(a);
    }
    return true;
}

}  // namespace

extern "C" {

// Scores N candidates over their whole windows into out (int32 [N, 4]:
// score, qb, qe, ref_end) on `stream`.  Read rows are oriented[owner] of
// width L <= 1024; max_rl is the longest read of the call (0 < max_rl <=
// L, or 0 for L), which with N picks the threads a candidate and the rows
// a thread; group is 0 for that choice, or 8 or 32 to time one form
// against the other (8 threads give way to 32 where they cannot hold the
// call's rows).  wl is not read (the corridor is the window).  match and
// -mismatch must fit a signed byte.  Returns the launch's
// cudaGetLastError(); does not synchronise.
int sw_batch_launch(const void *text, int64_t text_n, const void *oriented,
                    int64_t L, const void *olens, const void *owners,
                    const void *win_lo, const void *win_len, const void *wl,
                    int64_t N, int32_t max_rl, int32_t group,
                    int32_t match, int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                    int32_t clip, void *out, void *stream) {
    (void)wl;
    if (N <= 0) return 0;
    if (L < 0 || L > kMaxRows || max_rl < 0 || max_rl > L)
        return (int)cudaErrorInvalidValue;
    if (group != 0 && group != 8 && group != 32)
        return (int)cudaErrorInvalidValue;
    if (match < -127 || match > 127 || mismatch < -127 || mismatch > 127)
        return (int)cudaErrorInvalidValue;
    const Args a{static_cast<const uint8_t *>(text), text_n,
                 static_cast<const uint8_t *>(oriented), L,
                 static_cast<const int32_t *>(olens),
                 static_cast<const int32_t *>(owners),
                 static_cast<const int64_t *>(win_lo),
                 static_cast<const int32_t *>(win_len), N,
                 sw::Scoring{match, mismatch, gap_open, gap_extend, clip},
                 static_cast<int32_t *>(out),
                 static_cast<cudaStream_t>(stream)};
    const int64_t rows = max_rl > 0 ? max_rl : (L > 0 ? L : 1);
    if (group == 0) group = N > kWarpCallPerSm * sw::sm_count() ? 8 : 32;
    if (!launch_form(group, rows, a)) launch_form(32, rows, a);
    return (int)cudaGetLastError();
}

}  // extern "C"
