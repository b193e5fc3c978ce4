// Pieces shared by the port's Smith-Waterman kernels (sw_banded.cu,
// sw_banded16.cu, sw_banded_packed.cu, sw_batch.cu): the scoring scheme,
// the fused window gather and the rule that picks the best cell.
// alu_probe.cu takes prmt from here.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sw {

constexpr int32_t NEG = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
    int32_t match, mismatch, gap_open, gap_extend, clip;
};

// SMs of the current device (132 where the query fails), read once: the
// launches of sw_batch.cu, sw_banded16.cu and sw_banded_packed.cu pick a
// thread form by the candidates a call holds for each SM
inline int64_t sm_count() {
    static const int n = [] {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess || sms <= 0)
            return 132;
        return sms;
    }();
    return n;
}

// read base rc against window base fc; any code >= 4 scores -1
__device__ __forceinline__ int32_t sub_score(int32_t rc, int32_t fc,
                                             const Scoring &p) {
    return (rc >= 4 || fc >= 4) ? -1 : (rc == fc ? p.match : -p.mismatch);
}

// window base at text column c; columns outside the text read 5
__device__ __forceinline__ int32_t text_at(const uint8_t *__restrict__ text,
                                           int64_t text_n, int64_t c) {
    return (c >= 0 && c < text_n) ? (int32_t)text[c] : 5;
}

// prmt.b32 in its generic form: nibble n of `c` picks output byte n from
// the bytes of a (0-3) and b (4-7); with the nibble's bit 3 set the byte's
// sign bit is spread over the output byte instead.  (__byte_perm keeps
// only the three index bits of each nibble.)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t c) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// The final pick of every kernel: the higher score, then the smaller
// anti-diagonal d, then the smaller read row i.
__device__ __forceinline__ bool better(int32_t v, int32_t d, int32_t i,
                                       int32_t bv, int32_t bd, int32_t bi) {
    return v > bv || (v == bv && (d < bd || (d == bd && i < bi)));
}

// One candidate's best cell: score, d, row, and two payloads (the lane
// or nothing, and the start row).
struct Best {
    int32_t v, d, i, x, s;

    __device__ __forceinline__ void offer(const Best &o) {
        if (better(o.v, o.d, o.i, v, d, i)) *this = o;
    }
};

// Butterfly reduction of Best over aligned groups of WIDTH lanes.
template <int WIDTH>
__device__ __forceinline__ Best reduce_best(Best b) {
#pragma unroll
    for (int off = WIDTH / 2; off > 0; off >>= 1) {
        Best o;
        o.v = __shfl_xor_sync(kFull, b.v, off, WIDTH);
        o.d = __shfl_xor_sync(kFull, b.d, off, WIDTH);
        o.i = __shfl_xor_sync(kFull, b.i, off, WIDTH);
        o.x = __shfl_xor_sync(kFull, b.x, off, WIDTH);
        o.s = __shfl_xor_sync(kFull, b.s, off, WIDTH);
        b.offer(o);
    }
    return b;
}

// Inclusive max scan of (value, start) carries over aligned groups of
// WIDTH lanes: a lower (farther) lane's carry replaces this lane's only
// when strictly greater, so the nearer source wins ties.
template <int WIDTH>
__device__ __forceinline__ void scan_carries(int32_t &P, int32_t &S,
                                             int sl) {
#pragma unroll
    for (int off = 1; off < WIDTH; off <<= 1) {
        const int32_t oP = __shfl_up_sync(kFull, P, off, WIDTH);
        const int32_t oS = __shfl_up_sync(kFull, S, off, WIDTH);
        if (sl >= off && oP > P) { P = oP; S = oS; }
    }
}

// Multi-warp candidates: the carry entering warp wc is the join of the
// warp totals (agg[2w], agg[2w + 1]) for w < wc, farthest first, a nearer
// warp winning ties (the rule of the shuffle scan, carried across warps
// through shared memory).  Returns whether there is one; (P, S) is left
// alone for warp 0.
__device__ __forceinline__ bool warp_carry(const int32_t *agg, int wc,
                                           int32_t &P, int32_t &S) {
    if (wc == 0) return false;
    P = agg[0];
    S = agg[1];
    for (int w = 1; w < wc; ++w) {
        if (agg[2 * w] >= P) { P = agg[2 * w]; S = agg[2 * w + 1]; }
    }
    return true;
}

}  // namespace sw
