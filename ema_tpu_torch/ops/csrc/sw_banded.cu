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
// registers.  Corridors up to 1024 lanes take one warp per candidate
// (four candidates per block); wider ones, up to 4096 (mate rescue of
// reads up to 1023 bp reaches 1606), take 4 or 8 warps of 16 lanes per
// thread, one candidate per block, joined per row through shared memory.

#include "sw_rowsweep.cuh"

namespace {

constexpr int kMaxWl = 8 * 32 * 16;   // 8 warps x 32 threads x 16 lanes

template <int LPT, int WARPS>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len,
            const int32_t *wl, int64_t N, sw::Scoring p, int32_t *out,
            cudaStream_t stream) {
    constexpr int threads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int per_block = WARPS > 1 ? 1 : 4;
    const int64_t blocks = (N + per_block - 1) / per_block;
    sw::rowsweep_kernel<LPT, 32, WARPS><<<(unsigned)blocks, threads, 0,
                                          stream>>>(
        text, text_n, oriented, L, olens, owners, win_lo, win_len, wl, N, p,
        out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes.
int sw_banded_max_wl() { return kMaxWl; }

// Scores N candidates into out (int32 [N, 4]: score, qb, qe, ref_end) on
// `stream`.  max_wl is the largest wl[b] (1 <= wl[b] <= sw_banded_max_wl(),
// checked by the caller); it picks the lanes per thread and the warps per
// candidate.  Returns the launch's cudaGetLastError() (0 on success); does
// not synchronise.
int sw_banded_launch(const void *text, int64_t text_n, const void *oriented,
                     int64_t L, const void *olens, const void *owners,
                     const void *win_lo, const void *win_len, const void *wl,
                     int64_t N, int32_t max_wl, int32_t match,
                     int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                     int32_t clip, void *out, void *stream) {
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
    auto *res = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const int lpt = (max_wl + 31) / 32;
    if (lpt <= 1)
        launch<1, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 2)
        launch<2, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 4)
        launch<4, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 8)
        launch<8, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 16)
        launch<16, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 24)
        launch<24, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (lpt <= 32)
        launch<32, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (max_wl <= 4 * 32 * 16)
        launch<16, 4>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else
        launch<16, 8>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
