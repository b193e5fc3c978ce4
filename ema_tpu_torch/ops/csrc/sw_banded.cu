// Banded Smith-Waterman scoring with the window gather fused in, for Hopper
// (sm_90a).  Built by ema_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface, called through ctypes.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_banded_kernel (the
// banded row sweep behind sw_score_banded_pallas) together with the gather
// of ema_tpu/core/pipeline.py:_gather_score that feeds it: the read row and
// the reference window are read straight from the device-resident oriented
// reads and 2-bit text, so no [N, W] window matrix is ever materialised.
// The recurrences and the kernel body are in sw_rowsweep.cuh.
//
// What bounds it on this card: integer ALU work and dependent latency over
// about rl x wl cells per candidate (some 30 integer max/compare/select
// operations per cell), with a few bytes read per cell that hit in L1/L2
// (the read row is broadcast, the window slides one column per row).  No
// tensor-core work exists in this recurrence.  The design keeps each
// candidate's exact corridor (not padded to 128 lanes as on the TPU) in
// registers, and gives it the threads its width class and the size of
// the class call for: the caller sorts a call's candidates into the
// classes below and launches each class on its span of the permutation.
//
//   corridor   small class (< 6144)   large class: threads x lanes, per warp
//   <=   32    32 x 1                 8 x 4     4 candidates
//   <=   64    32 x 2                 8 x 8     4   (the usual chained 50..60)
//   <=   96    32 x 4                 16 x 6    2
//   <=  128    32 x 4                 32 x 4    1
//   <=  256 .. 1024   32 x 8, 16, 24, 32        1
//   <= 2048    4 warps x 32 x 16      one block
//   <= 4096    8 warps x 32 x 16      one block
//
// A part-warp segment amortises the per-row shuffles over more lanes and
// leaves no lane slot idle, which pays once the class fills the card; a
// class of a few thousand candidates is bound by the latency of its 100
// dependent rows, and there a whole warp per candidate, the most threads,
// is the fastest form (chip_smoke.py times a wl = 50 call on both sides of
// kLargeClass).  A call that spans several classes but is too small for a
// sort to pay comes as one launch at its widest class (ops/sw.py:
// plan_class_launches).
//
// The multi-warp forms (mate rescue of reads up to 1023 bp reaches 1606
// lanes) are joined per row through shared memory.

#include "sw_rowsweep.cuh"

namespace {

constexpr int kMaxWl = 8 * 32 * 16;   // 8 warps x 32 threads x 16 lanes
// from this many candidates a narrow class takes part-warp segments
constexpr int64_t kLargeClass = 6144;

template <int LPT, int SEGW, int WARPS>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len,
            const int32_t *wl, const int32_t *perm, int64_t N, sw::Scoring p,
            int32_t *out, cudaStream_t stream) {
    constexpr int threads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int per_block = WARPS > 1 ? 1 : 128 / SEGW;
    const int64_t blocks = (N + per_block - 1) / per_block;
    sw::rowsweep_kernel<LPT, SEGW, WARPS><<<(unsigned)blocks, threads, 0,
                                            stream>>>(
        text, text_n, oriented, L, olens, owners, win_lo, win_len, wl, perm,
        N, p, out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes.
int sw_banded_max_wl() { return kMaxWl; }

// Scores the N candidates perm[perm_off .. perm_off + N) (perm null: 0 ..
// N) into their own rows of out (int32 [*, 4]: score, qb, qe, ref_end) on
// `stream`.  max_wl bounds their wl (1 <= wl[b] <= max_wl <=
// sw_banded_max_wl(), checked by the caller); with N it picks the threads
// per candidate and the lanes per thread.  Returns the
// launch's cudaGetLastError() (0 on success); does not synchronise.
int sw_banded_launch(const void *text, int64_t text_n, const void *oriented,
                     int64_t L, const void *olens, const void *owners,
                     const void *win_lo, const void *win_len, const void *wl,
                     const void *perm, int64_t perm_off, int64_t N,
                     int32_t max_wl, int32_t match, int32_t mismatch,
                     int32_t gap_open, int32_t gap_extend, int32_t clip,
                     void *out, void *stream) {
    if (N <= 0) return 0;
    if (max_wl < 1 || max_wl > kMaxWl) return (int)cudaErrorInvalidValue;
    const sw::Scoring p{match, mismatch, gap_open, gap_extend, clip};
    const auto *t = static_cast<const uint8_t *>(text);
    const auto *o = static_cast<const uint8_t *>(oriented);
    const auto *ol = static_cast<const int32_t *>(olens);
    const auto *ow = static_cast<const int32_t *>(owners);
    const auto *lo = static_cast<const int64_t *>(win_lo);
    const auto *ln = static_cast<const int32_t *>(win_len);
    const auto *w = static_cast<const int32_t *>(wl);
    const auto *pm = static_cast<const int32_t *>(perm);
    if (pm != nullptr) pm += perm_off;
    auto *res = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
#define SW_CLASS(LPT, SEGW, WARPS)                                          \
    launch<LPT, SEGW, WARPS>(t, text_n, o, L, ol, ow, lo, ln, w, pm, N, p,  \
                             res, s)
    const bool big = N >= kLargeClass;
    if (max_wl <= 32) { if (big) SW_CLASS(4, 8, 1); else SW_CLASS(1, 32, 1); }
    else if (max_wl <= 64) { if (big) SW_CLASS(8, 8, 1); else SW_CLASS(2, 32, 1); }
    else if (max_wl <= 96) { if (big) SW_CLASS(6, 16, 1); else SW_CLASS(4, 32, 1); }
    else if (max_wl <= 128) SW_CLASS(4, 32, 1);
    else if (max_wl <= 256) SW_CLASS(8, 32, 1);
    else if (max_wl <= 512) SW_CLASS(16, 32, 1);
    else if (max_wl <= 768) SW_CLASS(24, 32, 1);
    else if (max_wl <= 1024) SW_CLASS(32, 32, 1);
    else if (max_wl <= 2048) SW_CLASS(16, 32, 4);
    else SW_CLASS(16, 32, 8);
#undef SW_CLASS
    return (int)cudaGetLastError();
}

}  // extern "C"
