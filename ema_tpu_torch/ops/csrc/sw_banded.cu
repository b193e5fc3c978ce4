// Banded Smith-Waterman scoring with the window gather fused in, for Hopper
// (sm_90a).  Built by ema_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_banded_kernel (the
// banded row sweep behind sw_score_banded_pallas) together with the gather
// of ema_tpu/core/pipeline.py:_gather_score that feeds it: the read row and
// the reference window are read straight from the device-resident oriented
// reads and 2-bit text, so no [N, W] window matrix is ever materialised.
//
// Recurrences, outputs and tie rules are those of ema_tpu/ops/sw.py:
// sw_score_banded (its plain PyTorch twin is ema_tpu_torch/ops/sw.py:
// sw_score_banded_ref).  Cell (i, k) is read row i = 1..rl against window
// column j = i + k, for diagonal lanes k in [0, wl):
//   Hd = max(H[i-1][k], fresh) + sub       fresh = 0 at i == 1 else -clip
//   F  = max(H[i-1][k+1] - go - ge, F[i-1][k+1] - ge)        (vertical)
//   H0 = max(Hd, F)
//   E  = max_{k' < k} (valid ? H0[k'] + k' ge : NEG) - k ge - go
//   H  = max(H0, E), start rows merged diag >= horizontal >= vertical.
// The horizontal max-plus scan prefers the nearest source (larger k') on
// ties; the per-lane best keeps the first strict improvement; the final
// pick is max score, then min 2i + k, then min i.
//
// What bounds it on this card: integer ALU work and dependent latency over
// about rl x wl cells per candidate (some 30 integer max/compare/select
// operations per cell), with a few bytes read per cell that hit in L1/L2
// (the read row is broadcast, the window slides one column per row).  No
// tensor-core work exists in this recurrence.  The design keeps each
// candidate's exact corridor (not padded to 128 lanes as on the TPU) in
// registers: one warp per candidate, LPT contiguous lanes per thread, the
// vertical dependency crosses threads by one __shfl_down_sync per state
// array, and the horizontal scan is a sequential in-thread scan plus a
// five-step warp-shuffle scan of the thread carries.  DPX instructions,
// sorting candidates by corridor width and packing two lanes per register
// are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -(1 << 28);
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
    int32_t match, mismatch, gap_open, gap_extend, clip;
};

__device__ __forceinline__ int32_t sub_score(int32_t rc, int32_t fc,
                                             const Scoring &p) {
    return (rc >= 4 || fc >= 4) ? -1 : (rc == fc ? p.match : -p.mismatch);
}

// One warp per candidate; lane t owns diagonals [t * LPT, t * LPT + LPT).
template <int LPT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_banded_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                 const uint8_t *__restrict__ oriented, int64_t L,
                 const int32_t *__restrict__ olens,
                 const int32_t *__restrict__ owners,
                 const int64_t *__restrict__ win_lo,
                 const int32_t *__restrict__ win_len,
                 const int32_t *__restrict__ wl_arr, int64_t N, Scoring p,
                 int32_t *__restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t b =
        (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (b >= N) return;  // b is uniform over the warp: it exits as a whole

    const int32_t owner = owners[b];
    const int32_t rl = olens[owner];
    const int64_t lo = win_lo[b];
    const int32_t nl = win_len[b];
    const int32_t wl = wl_arr[b];
    const uint8_t *read = oriented + (int64_t)owner * L;
    const int32_t goe = p.gap_open + p.gap_extend;
    const int32_t ge = p.gap_extend;
    const int32_t k0 = lane * LPT;

    // previous-row state of this thread's lanes
    int32_t Hp[LPT], Fp[LPT], SHp[LPT], SFp[LPT], rb[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        Hp[j] = NEG; Fp[j] = NEG; SHp[j] = 0; SFp[j] = 0; rb[j] = 5;
    }
    // this thread's best cell: value, row, lane, start row
    int32_t bv = NEG, bi = 0, bk = 0, bs = 0;

    // rows past the read or past the window hold no valid cell
    const int32_t last_row = rl < nl ? rl : nl;
    for (int32_t i = 1; i <= last_row; ++i) {
        // previous-row state of lane k0 + LPT, held by the next thread;
        // past the last thread every lane is >= wl, hence NEG
        int32_t nH = __shfl_down_sync(kFull, Hp[0], 1);
        int32_t nF = __shfl_down_sync(kFull, Fp[0], 1);
        int32_t nSH = __shfl_down_sync(kFull, SHp[0], 1);
        int32_t nSF = __shfl_down_sync(kFull, SFp[0], 1);
        if (lane == 31) { nH = NEG; nF = NEG; nSH = 0; nSF = 0; }

        const int32_t rc = read[i - 1];
        const int32_t fresh = (i == 1) ? 0 : -p.clip;
        const int32_t end_adj = (i == rl) ? 0 : -p.clip;
        const int64_t col0 = lo + (i - 1) + k0;

        // pass 1: vertical gaps in place (ascending j reads lane j + 1
        // before it is overwritten) and this thread's scan aggregate
        int32_t aggP = INT32_MIN, aggS = 0;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int32_t k = k0 + j;
            if (k < wl) {
                const int64_t c = col0 + j;
                rb[j] = (c >= 0 && c < text_n) ? (int32_t)text[c] : 5;
                const int32_t hn = (j + 1 < LPT) ? Hp[j + 1] : nH;
                const int32_t fn = (j + 1 < LPT) ? Fp[j + 1] : nF;
                const int32_t shn = (j + 1 < LPT) ? SHp[j + 1] : nSH;
                const int32_t sfn = (j + 1 < LPT) ? SFp[j + 1] : nSF;
                const int32_t fo = hn - goe, fe = fn - ge;
                const int32_t f = fo >= fe ? fo : fe;
                const int32_t sf = fo >= fe ? shn : sfn;
                Fp[j] = f;
                SFp[j] = sf;
                const int32_t ph = Hp[j];
                const int32_t hd =
                    (ph >= fresh ? ph : fresh) + sub_score(rc, rb[j], p);
                const int32_t sd = ph >= fresh ? SHp[j] : i - 1;
                const bool valid = i + k <= nl;
                const int32_t h0 = hd >= f ? hd : f;
                const int32_t s0 = hd >= f ? sd : sf;
                const int32_t a = valid ? h0 + k * ge : NEG;
                if (a >= aggP) { aggP = a; aggS = s0; }
            }
        }

        // warp inclusive scan of the carries: the nearer (higher) thread
        // wins ties, the rule of the TPU kernel's log-step scan
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int32_t oP = __shfl_up_sync(kFull, aggP, off);
            const int32_t oS = __shfl_up_sync(kFull, aggS, off);
            if (lane >= off && oP > aggP) { aggP = oP; aggS = oS; }
        }
        int32_t P = __shfl_up_sync(kFull, aggP, 1);
        int32_t PS = __shfl_up_sync(kFull, aggS, 1);
        if (lane == 0) { P = NEG; PS = 0; }

        // pass 2: horizontal gaps from the exclusive prefix, merge, best
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int32_t k = k0 + j;
            if (k < wl) {
                const int32_t ph = Hp[j];
                const int32_t hd =
                    (ph >= fresh ? ph : fresh) + sub_score(rc, rb[j], p);
                const int32_t sd = ph >= fresh ? SHp[j] : i - 1;
                const int32_t f = Fp[j], sf = SFp[j];
                const bool valid = i + k <= nl;
                const int32_t h0 = hd >= f ? hd : f;
                const int32_t s0 = hd >= f ? sd : sf;
                const int32_t e = P - k * ge - p.gap_open;
                const int32_t ef = e >= f ? e : f;
                const int32_t h = h0 >= e ? h0 : e;
                const int32_t sh = hd >= ef ? sd : (e >= f ? PS : sf);
                const int32_t a = valid ? h0 + k * ge : NEG;
                if (a >= P) { P = a; PS = s0; }
                Hp[j] = valid ? h : NEG;
                Fp[j] = valid ? f : NEG;
                SHp[j] = sh;
                if (valid) {
                    const int32_t cand = h + end_adj;
                    const int32_t d = 2 * i + k, bd = 2 * bi + bk;
                    if (cand > bv ||
                        (cand == bv && (d < bd || (d == bd && i < bi)))) {
                        bv = cand; bi = i; bk = k; bs = sh;
                    }
                }
            }
        }
    }

    // warp reduction of the thread bests: max score, min 2i + k, min i
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int32_t ov = __shfl_xor_sync(kFull, bv, off);
        const int32_t oi = __shfl_xor_sync(kFull, bi, off);
        const int32_t ok = __shfl_xor_sync(kFull, bk, off);
        const int32_t os = __shfl_xor_sync(kFull, bs, off);
        const int32_t od = 2 * oi + ok, md = 2 * bi + bk;
        if (ov > bv || (ov == bv && (od < md || (od == md && oi < bi)))) {
            bv = ov; bi = oi; bk = ok; bs = os;
        }
    }
    if (lane == 0) {
        int32_t *o = out + b * 4;
        o[0] = bv;
        o[1] = bs;
        o[2] = bi;
        o[3] = bi + bk;
    }
}

template <int LPT>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len,
            const int32_t *wl, int64_t N, Scoring p, int32_t *out,
            cudaStream_t stream) {
    const int64_t blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sw_banded_kernel<LPT><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                            stream>>>(text, text_n, oriented, L, olens,
                                      owners, win_lo, win_len, wl, N, p, out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes: 32 lanes per thread.
int sw_banded_max_wl() { return 32 * 32; }

// Scores N candidates into out (int32 [N, 4]: score, qb, qe, ref_end) on
// `stream`.  max_wl is the largest wl[b] (1 <= wl[b] <= sw_banded_max_wl(),
// checked by the caller); it picks the lanes per thread.  Returns the
// launch's cudaGetLastError() (0 on success); does not synchronise.
int sw_banded_launch(const void *text, int64_t text_n, const void *oriented,
                     int64_t L, const void *olens, const void *owners,
                     const void *win_lo, const void *win_len, const void *wl,
                     int64_t N, int32_t max_wl, int32_t match,
                     int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                     int32_t clip, void *out, void *stream) {
    if (N <= 0) return 0;
    if (max_wl < 1 || max_wl > sw_banded_max_wl())
        return (int)cudaErrorInvalidValue;
    const Scoring p{match, mismatch, gap_open, gap_extend, clip};
    const auto *t = static_cast<const uint8_t *>(text);
    const auto *o = static_cast<const uint8_t *>(oriented);
    const auto *ol = static_cast<const int32_t *>(olens);
    const auto *ow = static_cast<const int32_t *>(owners);
    const auto *lo = static_cast<const int64_t *>(win_lo);
    const auto *ln = static_cast<const int32_t *>(win_len);
    const auto *w = static_cast<const int32_t *>(wl);
    auto *res = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const int lpt = (max_wl + 31) / 32;
    if (lpt <= 1)
        launch<1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 2)
        launch<2>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 4)
        launch<4>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 8)
        launch<8>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 16)
        launch<16>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 24)
        launch<24>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else
        launch<32>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
