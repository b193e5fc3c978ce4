// The banded Smith-Waterman row sweep in int16 state, two lanes per 32-bit
// register (s16x2), with the window gather fused in, for Hopper (sm_90a).
// Built by ema_tpu_torch/ops/_build.py with nvcc into a plain-C shared
// library.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_banded_kernel16 (behind
// sw_score_banded_pallas16): the recurrences of sw_rowsweep.cuh with every
// per-lane value (H, F, starts, bests) held as int16, the sentinel
// NEG16 = -16384, and a no-alignment score (<= NEG16 / 2) reported as the
// int32 NEG (sw_pallas.py:643-645).  Its plain PyTorch twin is
// ema_tpu_torch/ops/sw.py:sw_score_banded16_ref.
//
// Layout: a thread owns 2H lanes in H registers per state array; register j
// holds lane k0 + j in its low half and lane k0 + H + j in its high half,
// so one __vmaxs2 / __vadd2 / __vsub2 / __vcmpges2 advances two lanes, and
// so does the in-thread horizontal scan: the low and high halves scan in
// parallel and are joined once per row (the high half is the nearer).  The
// vertical neighbour of register H-1 is assembled with one __byte_perm
// from the high half of register 0 and the next thread's low half.
// Thread carries cross the warp (and, past 1024 lanes, the warps) exactly
// as in the int32 kernel, with the nearer source winning ties.
//
// What bounds it on this card: integer ALU work and latency over rl x wl
// cells, about half the instructions per cell of the int32 kernel in the
// packed parts; the carries, the gather and the final reduction stay
// per lane.

#include "sw_common.cuh"

namespace {

using sw::Best;
using sw::kFull;

constexpr int32_t NEG16 = -16384;
constexpr int kMaxWl = 8 * 32 * 16;   // 8 warps x 32 threads x 16 lanes

__device__ __forceinline__ uint32_t pk(int32_t lo, int32_t hi) {
    return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}
__device__ __forceinline__ int32_t lo16(uint32_t x) {
    return (int32_t)(int16_t)(uint16_t)(x & 0xffffu);
}
__device__ __forceinline__ int32_t hi16(uint32_t x) {
    return (int32_t)(int16_t)(uint16_t)(x >> 16);
}
// per half: m ? a : b, for masks of 0x0000 / 0xffff halves
__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
    return (a & m) | (b & ~m);
}
// low half from x's high half, high half from y's low half
__device__ __forceinline__ uint32_t shift_pair(uint32_t x, uint32_t y) {
    return __byte_perm(x, y, 0x5432);
}

template <int H, int WARPS>
__global__ void __launch_bounds__(WARPS > 1 ? 32 * WARPS : 128)
sw_banded16_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                   const uint8_t *__restrict__ oriented, int64_t L,
                   const int32_t *__restrict__ olens,
                   const int32_t *__restrict__ owners,
                   const int64_t *__restrict__ win_lo,
                   const int32_t *__restrict__ win_len,
                   const int32_t *__restrict__ wl_arr, int64_t N,
                   sw::Scoring p, int32_t *__restrict__ out) {
    constexpr int kPerBlock = WARPS > 1 ? 1 : 4;
    constexpr int kW = WARPS > 1 ? WARPS : 1;
    __shared__ uint32_t sh_bnd[kW][4];   // register 0's previous-row state
    __shared__ int32_t sh_agg[kW * 2];   // warp totals of the row's scan
    __shared__ Best sh_best[kW];

    const int lane = threadIdx.x & 31;
    const int wc = WARPS > 1 ? (int)(threadIdx.x >> 5) : 0;
    const int64_t b = (int64_t)blockIdx.x * kPerBlock
        + (WARPS > 1 ? 0 : (int64_t)(threadIdx.x >> 5));
    if (b >= N) return;  // b is uniform over the candidate's warps

    const int32_t owner = owners[b];
    const int32_t rl = olens[owner];
    const int64_t lo = win_lo[b];
    const int32_t nl = win_len[b];
    const int32_t wl = wl_arr[b];
    const uint8_t *read = oriented + (int64_t)owner * L;
    const int32_t ge = p.gap_extend;
    const int32_t k0 = (WARPS > 1 ? (int)threadIdx.x : lane) * 2 * H;

    const uint32_t NEGP = pk(NEG16, NEG16);
    const uint32_t goep = pk(p.gap_open + ge, p.gap_open + ge);
    const uint32_t gep = pk(ge, ge), gop = pk(p.gap_open, p.gap_open);
    const uint32_t matchp = pk(p.match, p.match);
    const uint32_t mismp = pk(-p.mismatch, -p.mismatch);
    const uint32_t minus1 = pk(-1, -1), fourp = pk(4, 4);
    const uint32_t clipp = pk(-p.clip, -p.clip);

    // previous-row state, per-lane sub scores of the row, per-lane bests
    uint32_t Hp[H], Fp[H], SHp[H], SFp[H], SUB[H], BV[H], BI[H], BS[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
        Hp[j] = NEGP; Fp[j] = NEGP; SHp[j] = 0; SFp[j] = 0; SUB[j] = 0;
        BV[j] = NEGP; BI[j] = 0; BS[j] = 0;
    }

    const int32_t last_row = rl < nl ? rl : nl;
    for (int32_t i = 1; i <= last_row; ++i) {
        if constexpr (WARPS > 1) {
            if (lane == 0) {
                sh_bnd[wc][0] = Hp[0]; sh_bnd[wc][1] = Fp[0];
                sh_bnd[wc][2] = SHp[0]; sh_bnd[wc][3] = SFp[0];
            }
            __syncthreads();
        }
        // register 0 of the next thread (its low half is lane k0 + 2H);
        // past the candidate's last thread every lane is >= wl: NEG16
        uint32_t nH = __shfl_down_sync(kFull, Hp[0], 1);
        uint32_t nF = __shfl_down_sync(kFull, Fp[0], 1);
        uint32_t nSH = __shfl_down_sync(kFull, SHp[0], 1);
        uint32_t nSF = __shfl_down_sync(kFull, SFp[0], 1);
        if (lane == 31) {
            if (WARPS > 1 && wc + 1 < WARPS) {
                nH = sh_bnd[wc + 1][0]; nF = sh_bnd[wc + 1][1];
                nSH = sh_bnd[wc + 1][2]; nSF = sh_bnd[wc + 1][3];
            } else {
                nH = NEGP; nF = NEGP; nSH = 0; nSF = 0;
            }
        }
        // register 0 as it was: pass 1 rewrites its F state before
        // register H-1 reads the high half as its neighbour
        const uint32_t F0 = Fp[0], SF0 = SFp[0];

        const int32_t rc = read[i - 1];
        const uint32_t rcp = pk(rc, rc);
        const uint32_t rc_n = rc >= 4 ? 0xffffffffu : 0u;
        const uint32_t freshp = i == 1 ? 0u : clipp;
        const uint32_t endp = i == rl ? 0u : clipp;
        const uint32_t rowp = pk(i, i), prevp = pk(i - 1, i - 1);
        // lane k is valid iff k < wl and i + k <= nl
        const int32_t lim = wl < nl - i + 1 ? wl : nl - i + 1;
        const int64_t col0 = lo + (i - 1) + k0;

        // pass 1: vertical gaps in place, sub scores, and the running scan
        // aggregate of each half
        uint32_t aggP = NEGP, aggS = 0;
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const int32_t kl = k0 + j, kh = k0 + H + j;
            if (kl < wl) {
                const int32_t cl = sw::text_at(text, text_n, col0 + j);
                const int32_t ch =
                    kh < wl ? sw::text_at(text, text_n, col0 + H + j) : 5;
                const uint32_t rb = pk(cl, ch);
                const uint32_t nm = rc_n | __vcmpges2(rb, fourp);
                const uint32_t sub =
                    sel(nm, minus1, sel(__vcmpeq2(rb, rcp), matchp, mismp));
                SUB[j] = sub;
                uint32_t hn, fn, shn, sfn;
                if (j + 1 < H) {
                    hn = Hp[j + 1]; fn = Fp[j + 1];
                    shn = SHp[j + 1]; sfn = SFp[j + 1];
                } else {
                    hn = shift_pair(Hp[0], nH);
                    fn = shift_pair(F0, nF);
                    shn = shift_pair(SHp[0], nSH);
                    sfn = shift_pair(SF0, nSF);
                }
                const uint32_t fo = __vsub2(hn, goep), fe = __vsub2(fn, gep);
                const uint32_t mf = __vcmpges2(fo, fe);
                const uint32_t f = __vmaxs2(fo, fe);
                const uint32_t sf = sel(mf, shn, sfn);
                Fp[j] = f;
                SFp[j] = sf;
                const uint32_t ph = Hp[j];
                const uint32_t hd = __vadd2(__vmaxs2(ph, freshp), sub);
                const uint32_t sd = sel(__vcmpges2(ph, freshp), SHp[j], prevp);
                const uint32_t mh = __vcmpges2(hd, f);
                const uint32_t h0 = __vmaxs2(hd, f);
                const uint32_t s0 = sel(mh, sd, sf);
                const uint32_t vm = (kl < lim ? 0x0000ffffu : 0u)
                    | (kh < lim ? 0xffff0000u : 0u);
                const uint32_t kep = pk(kl * ge, kh * ge);
                const uint32_t a = sel(vm, __vadd2(h0, kep), NEGP);
                const uint32_t ma = __vcmpges2(a, aggP);
                aggP = sel(ma, a, aggP);
                aggS = sel(ma, s0, aggS);
            }
        }

        // the thread's carry: its high half is nearer than its low half
        const int32_t aLo = lo16(aggP), aHi = hi16(aggP);
        int32_t tP = aHi >= aLo ? aHi : aLo;
        int32_t tS = aHi >= aLo ? hi16(aggS) : lo16(aggS);
        sw::scan_carries<32>(tP, tS, lane);
        int32_t cP = NEG16, cS = 0;       // what enters lane 0 of the warp
        if constexpr (WARPS > 1) {
            if (lane == 31) { sh_agg[2 * wc] = tP; sh_agg[2 * wc + 1] = tS; }
            __syncthreads();
            if (sw::warp_carry(sh_agg, wc, cP, cS) && cP > tP) {
                tP = cP; tS = cS;
            }
        }
        int32_t XP = __shfl_up_sync(kFull, tP, 1);
        int32_t XS = __shfl_up_sync(kFull, tS, 1);
        if (lane == 0) { XP = cP; XS = cS; }
        // the high half's prefix also spans the low half, which is nearer
        const int32_t YP = XP > aLo ? XP : aLo;
        const int32_t YS = XP > aLo ? XS : lo16(aggS);
        uint32_t P = pk(XP, YP), PS = pk(XS, YS);

        // pass 2: horizontal gaps from the exclusive prefix, merge, bests
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const int32_t kl = k0 + j, kh = k0 + H + j;
            if (kl < wl) {
                const uint32_t ph = Hp[j];
                const uint32_t hd = __vadd2(__vmaxs2(ph, freshp), SUB[j]);
                const uint32_t sd = sel(__vcmpges2(ph, freshp), SHp[j], prevp);
                const uint32_t f = Fp[j], sf = SFp[j];
                const uint32_t mh = __vcmpges2(hd, f);
                const uint32_t h0 = __vmaxs2(hd, f);
                const uint32_t s0 = sel(mh, sd, sf);
                const uint32_t vm = (kl < lim ? 0x0000ffffu : 0u)
                    | (kh < lim ? 0xffff0000u : 0u);
                const uint32_t kep = pk(kl * ge, kh * ge);
                const uint32_t e = __vsub2(__vsub2(P, kep), gop);
                const uint32_t ef = __vmaxs2(e, f);
                const uint32_t h = __vmaxs2(h0, e);
                const uint32_t sh = sel(__vcmpges2(hd, ef), sd,
                                        sel(__vcmpges2(e, f), PS, sf));
                const uint32_t a = sel(vm, __vadd2(h0, kep), NEGP);
                const uint32_t ma = __vcmpges2(a, P);
                P = sel(ma, a, P);
                PS = sel(ma, s0, PS);
                Hp[j] = sel(vm, h, NEGP);
                Fp[j] = sel(vm, f, NEGP);
                SHp[j] = sh;
                const uint32_t cand = sel(vm, __vadd2(h, endp), NEGP);
                const uint32_t imp = __vcmpgts2(cand, BV[j]);
                BV[j] = sel(imp, cand, BV[j]);
                BI[j] = sel(imp, rowp, BI[j]);
                BS[j] = sel(imp, sh, BS[j]);
            }
        }
    }

    // the per-lane bests, in int32: max score, min 2i + k, min i
    Best best{NEG16, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const int32_t kl = k0 + j, kh = k0 + H + j;
        const int32_t il = lo16(BI[j]), ih = hi16(BI[j]);
        best.offer(Best{lo16(BV[j]), 2 * il + kl, il, kl, lo16(BS[j])});
        best.offer(Best{hi16(BV[j]), 2 * ih + kh, ih, kh, hi16(BS[j])});
    }
    best = sw::reduce_best<32>(best);
    if constexpr (WARPS > 1) {
        if (lane == 0) sh_best[wc] = best;
        __syncthreads();
        if (threadIdx.x != 0) return;
        for (int w = 1; w < WARPS; ++w) best.offer(sh_best[w]);
    } else if (lane != 0) {
        return;
    }
    int32_t *o = out + b * 4;
    o[0] = best.v <= NEG16 / 2 ? sw::NEG : best.v;
    o[1] = best.s;
    o[2] = best.i;
    o[3] = best.i + best.x;
}

template <int H, int WARPS>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len,
            const int32_t *wl, int64_t N, sw::Scoring p, int32_t *out,
            cudaStream_t stream) {
    constexpr int threads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int per_block = WARPS > 1 ? 1 : 4;
    const int64_t blocks = (N + per_block - 1) / per_block;
    sw_banded16_kernel<H, WARPS><<<(unsigned)blocks, threads, 0, stream>>>(
        text, text_n, oriented, L, olens, owners, win_lo, win_len, wl, N, p,
        out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes.
int sw_banded16_max_wl() { return kMaxWl; }

// Scores N candidates into out (int32 [N, 4]: score, qb, qe, ref_end) on
// `stream`.  max_wl is the largest wl[b] (1 <= wl[b] <= sw_banded16_max_wl()
// and scores within the int16 range, checked by the caller); it picks the
// lanes per thread and the warps per candidate.  Returns the launch's
// cudaGetLastError(); does not synchronise.
int sw_banded16_launch(const void *text, int64_t text_n,
                       const void *oriented, int64_t L, const void *olens,
                       const void *owners, const void *win_lo,
                       const void *win_len, const void *wl, int64_t N,
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
    auto *res = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const int pairs = (max_wl + 63) / 64;   // registers per thread, 1 warp
    if (pairs <= 1)
        launch<1, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (pairs <= 2)
        launch<2, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (pairs <= 4)
        launch<4, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (pairs <= 8)
        launch<8, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (pairs <= 16)
        launch<16, 1>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else if (max_wl <= 4 * 32 * 16)
        launch<8, 4>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else
        launch<8, 8>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
