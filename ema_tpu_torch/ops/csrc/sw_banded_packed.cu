// The pair-packed 64-diagonal tier of the banded Smith-Waterman scorer,
// with the window gather fused in, for Hopper (sm_90a).  Built by
// ema_tpu_torch/ops/_build.py with nvcc into a plain-C shared library.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_banded_kernel_packed
// (behind sw_score_banded_pallas_packed), which packs two candidates with
// corridors wl <= 64 into one 128-lane vector row and masks every shift
// and its scan (which stops at 32) by 64-lane segment.  Here the segment
// is a 16-lane half warp: two candidates per warp, 4 lanes per thread,
// every shuffle of the row sweep (sw_rowsweep.cuh) at width 16, so the
// vertical hand-off, the horizontal-gap scan and the best-cell reduction
// stop at the segment edge.  The two halves run the longer of their row
// counts; rows past a half's own count hold no valid cell.
//
// Its output is sw_score_banded's at w_band = 64, as the JAX wrapper
// documents.  Start rows live in their own registers: the JAX kernel's
// scan key (A << 17) | (kk << 8) | S0 keeps only the low 8 bits of the
// start row (P & 255), so reads past 256 bp come back with the start
// modulo 256 there; that packing is not carried over.
//
// What bounds it on this card: as sw_banded.cu, integer ALU work and
// latency over rl x wl cells.  A 64-lane corridor fills a half warp
// exactly, where the one-warp kernel at up to 64 lanes leaves half its
// threads idle or at 2 lanes per thread.

#include "sw_rowsweep.cuh"

namespace {

constexpr int kSegLanes = 64;           // 16 threads x 4 lanes
constexpr int kThreads = 128;
constexpr int kPerBlock = kThreads / 16;

}  // namespace

extern "C" {

// Widest corridor the kernel takes: one 64-lane segment.
int sw_banded_packed_max_wl() { return kSegLanes; }

// Scores N candidates into out (int32 [N, 4]: score, qb, qe, ref_end) on
// `stream`; candidates 2b and 2b + 1 share a warp.  1 <= wl[b] <= 64 is
// checked by the caller (max_wl).  Returns the launch's
// cudaGetLastError(); does not synchronise.
int sw_banded_packed_launch(const void *text, int64_t text_n,
                            const void *oriented, int64_t L,
                            const void *olens, const void *owners,
                            const void *win_lo, const void *win_len,
                            const void *wl, int64_t N, int32_t max_wl,
                            int32_t match, int32_t mismatch,
                            int32_t gap_open, int32_t gap_extend,
                            int32_t clip, void *out, void *stream) {
    if (N <= 0) return 0;
    if (max_wl < 1 || max_wl > kSegLanes) return (int)cudaErrorInvalidValue;
    const sw::Scoring p{match, mismatch, gap_open, gap_extend, clip};
    const int64_t blocks = (N + kPerBlock - 1) / kPerBlock;
    sw::rowsweep_kernel<4, 16, 1><<<(unsigned)blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t *>(text), text_n,
        static_cast<const uint8_t *>(oriented), L,
        static_cast<const int32_t *>(olens),
        static_cast<const int32_t *>(owners),
        static_cast<const int64_t *>(win_lo),
        static_cast<const int32_t *>(win_len),
        static_cast<const int32_t *>(wl), nullptr, N, p,
        static_cast<int32_t *>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
