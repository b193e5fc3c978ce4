// The banded Smith-Waterman row sweep in int16 state, two lanes per 32-bit
// register (s16x2), with the window gather fused in, for Hopper (sm_90a).
// Built by ema_tpu_torch/ops/_build.py with nvcc into a plain-C shared
// library.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_banded_kernel16 (behind
// sw_score_banded_pallas16): the recurrences of sw_banded.cu with every
// per-lane value (H, F, starts, bests) held as int16, the sentinel
// NEG16 = -16384, and a no-alignment score (<= NEG16 / 2) reported as the
// int32 NEG (sw_pallas.py:643-645).  Its plain PyTorch twin is
// ema_tpu_torch/ops/sw.py:sw_score_banded16_ref.
//
// Layout: the candidate's SEGW * WARPS threads each own 2H lanes in H
// registers per state array; register j holds lane k0 + j in its low half
// and lane k0 + H + j in its high half, so one s16x2 instruction advances
// two lanes, and so does the in-thread horizontal scan: the low and high
// halves scan in parallel and are joined once per row (the high half is
// the nearer).  The vertical neighbour of register H-1 is assembled with
// one __byte_perm from the high half of register 0 and the next thread's
// low half.  Thread carries cross the segment (and, past 512 lanes, the
// warps) exactly as in the int32 kernel, with the nearer source winning
// ties.  Slot c of a launch scores candidate perm[c] (c itself when perm
// is null) and writes out[perm[c]]: the caller launches each corridor-width
// class of a call on its span of a permutation (ops/sw.py:
// plan_class_launches), and a class takes the threads its width and its
// size call for (the table at the bottom): a narrow corridor takes 8 or
// 16 threads of 4 to 8 lanes, so that the per-row shuffles and the carry
// scan (3 or 4 rounds) are spread over more cells than a whole warp of 2
// lanes a thread spread them.
//
// What a row no longer pays:
//   * one pass computes the vertical gap, the diagonal, their merge and
//     the scan value, and keeps them in registers; the second part (the
//     horizontal gap from the exclusive prefix, the final merge, the best
//     cell) computes nothing twice;
//   * validity: a lane is valid iff k < wl and i + k <= nl, a prefix of
//     the lanes, and an invalid lane feeds only lanes that are invalid
//     too, except through the vertical gap of the lane below it.  So the
//     scan runs unmasked, H and F are held at NEG16 by one mask per
//     register, which is a per-candidate constant (k < wl) until the rows
//     where i + wl - 1 > nl, and only those tail rows rebuild it (no row
//     does where the window holds rl + wl columns, as every chained
//     call's does).  No branch depends on the lane inside the unrolled
//     register loops; the gap-extension offsets k ge are per-thread
//     constants;
//   * every max whose start row follows is one VIMNMX (__vmaxs2) and a
//     select mask that is the sign of the s16x2 difference spread over
//     its half by one byte permute (the host's int16 range check keeps
//     the difference from wrapping): 4 instructions where __vcmpges2
//     takes 5.  A mask from the two
//     predicates of __vibmax_s16x2 also took 4 (VIMNMX, IADD3, two SEL)
//     and was no faster, and its predicates did not come out as a >= b in
//     the way this kernel used them;
//   * the window is read once: each lane's base lives in a register as
//     the byte selector of its substitution score, two lanes a word, and
//     slides by one lane a row with a __byte_perm as the state does; the
//     segment loads its next SEGW bases, one a thread, every SEGW rows.
//     The row's read base makes a word of four score bytes (one per
//     window base; all -1 for a read N) and a register's two scores are
//     one byte permute (prmt, which also spreads each score's sign over
//     its half) of that word by the register's selector (a window N
//     or a column outside the text selects a -1 byte of the second
//     operand).  Scores must fit a signed byte.
//
// What bounds it on this card: integer ALU work and latency over rl x wl
// cells; two cells an instruction in the packed parts, the carries, the
// gather and the final reduction stay per lane.

#include "sw_common.cuh"

namespace {

using sw::Best;
using sw::kFull;

constexpr int32_t NEG16 = -16384;
constexpr int kMaxWl = 8 * 32 * 16;   // 8 warps x 32 threads x 16 lanes
// A narrow class takes part-warp segments once it holds more than this
// many candidates for each SM of the card.  (Corridors of 50 on 132 SMs:
// 8 threads take 0.039 ms up to 2,048 candidates; a warp each takes 0.028
// ms to 512, 0.033 at 1,024 = 7.8 an SM, 0.043 from 1,152 = 8.7 an SM;
// chip_smoke.py times both around this size.)
constexpr int64_t kWarpClassPerSm = 8;

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
// per half max(a, b); ge: 0xffff where a >= b, else 0
__device__ __forceinline__ uint32_t max_ge(uint32_t a, uint32_t b,
                                           uint32_t &ge) {
    // the halves' differences stay within int16 (the caller's range
    // check), so their sign bits, spread over their halves, are a < b
    ge = ~sw::prmt(__vsub2(a, b), 0, 0xbb99);
    return __vmaxs2(a, b);
}

// the selector byte of a window base: the score byte of base c (byte 4,
// of the all -1 operand, for an N or a column outside the text) and the
// spread of its sign
__device__ __forceinline__ uint32_t base_selector(int32_t c) {
    const uint32_t byte = c >= 4 ? 4u : (uint32_t)c;
    return byte | ((8u | byte) << 4);
}

template <int H, int SEGW, int WARPS>
__global__ void __launch_bounds__(WARPS > 1 ? 32 * WARPS : 128)
sw_banded16_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                   const uint8_t *__restrict__ oriented, int64_t L,
                   const int32_t *__restrict__ olens,
                   const int32_t *__restrict__ owners,
                   const int64_t *__restrict__ win_lo,
                   const int32_t *__restrict__ win_len,
                   const int32_t *__restrict__ wl_arr,
                   const int32_t *__restrict__ perm, int64_t N,
                   sw::Scoring p, int32_t *__restrict__ out) {
    static_assert(WARPS == 1 || SEGW == 32,
                  "a multi-warp candidate is made of whole warps");
    constexpr int kThreads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int kCandPerBlock = WARPS > 1 ? 1 : kThreads / SEGW;
    constexpr int kW = WARPS > 1 ? WARPS : 1;
    constexpr int kLanes = 2 * H * SEGW * kW;   // lanes of a candidate
    __shared__ uint32_t sh_bnd[kW][5];   // register 0's previous-row state
    __shared__ int32_t sh_agg[kW * 2];   // warp totals of the row's scan
    __shared__ Best sh_best[kW];

    const int lane = threadIdx.x & 31;
    const int sl = threadIdx.x & (SEGW - 1);          // thread in segment
    const int wc = WARPS > 1 ? (int)(threadIdx.x >> 5) : 0;
    const int64_t slot = (int64_t)blockIdx.x * kCandPerBlock
        + (WARPS > 1 ? 0 : (int64_t)(threadIdx.x / SEGW));
    const bool live = slot < N;
    // a whole-warp candidate leaves as a whole; a part-warp segment past
    // N stays for its partners' shuffles with no rows and no lanes
    if (SEGW == 32 && !live) return;
    const int64_t b = (live && perm != nullptr) ? (int64_t)perm[slot] : slot;

    int32_t rl = 0, nl = 0, wl = 0;
    int64_t lo = 0;
    const uint8_t *read = oriented;
    if (live) {
        const int32_t owner = owners[b];
        rl = olens[owner];
        lo = win_lo[b];
        nl = win_len[b];
        wl = wl_arr[b];
        read = oriented + (int64_t)owner * L;
    }
    const int32_t ge = p.gap_extend;
    const int tc = WARPS > 1 ? (int)threadIdx.x : sl;  // thread of candidate
    const int32_t k0 = tc * 2 * H;
    const bool last_thread = tc == SEGW * kW - 1;

    const uint32_t NEGP = pk(NEG16, NEG16);
    // subtrahends are kept negated: __vadd2 is one instruction (VIADD),
    // __vsub2 three
    const uint32_t ngoep = pk(-p.gap_open - ge, -p.gap_open - ge);
    const uint32_t ngep = pk(-ge, -ge);
    const uint32_t clipp = pk(-p.clip, -p.clip);
    const uint32_t all_mm = 0x01010101u * (uint32_t)((-p.mismatch) & 0xff);
    const uint32_t delta = (uint32_t)(((-p.mismatch) ^ p.match) & 0xff);

    // rows past the read or past the window hold no valid cell; the
    // segments of one warp run the longest of their row counts
    const int32_t last_row = rl < nl ? rl : nl;
    int32_t rows = last_row;
#pragma unroll
    for (int off = SEGW; off < 32; off <<= 1) {
        const int32_t o = __shfl_xor_sync(kFull, rows, off);
        rows = o > rows ? o : rows;
    }
    // the last row whose every lane k < wl has i + k <= nl
    const int32_t full_rows = nl - wl + 1 < last_row ? nl - wl + 1 : last_row;

    // previous-row state, the lanes' base selectors, per-lane bests, and
    // the per-thread constants: the static lane mask (k < wl), k ge and
    // -(k ge + go)
    uint32_t Hp[H], Fp[H], SHp[H], SFp[H], S[H], BV[H], BI[H], BS[H];
    uint32_t VK[H], VM[H], KEP[H], NKEG[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const int32_t kl = k0 + j, kh = k0 + H + j;
        Hp[j] = NEGP; Fp[j] = NEGP; SHp[j] = 0; SFp[j] = 0;
        BV[j] = NEGP; BI[j] = 0; BS[j] = 0;
        VK[j] = (kl < wl ? 0x0000ffffu : 0u) | (kh < wl ? 0xffff0000u : 0u);
        VM[j] = VK[j];
        KEP[j] = pk(kl * ge, kh * ge);
        NKEG[j] = pk(-kl * ge - p.gap_open, -kh * ge - p.gap_open);
        // row 1: lane k is at window column k (the lanes past wl too:
        // their bases slide into the corridor row by row)
        S[j] = base_selector(sw::text_at(text, text_n, lo + kl))
            | (base_selector(sw::text_at(text, text_n, lo + kh)) << 8);
    }
    uint32_t nbuf = 0xc4u;   // the selector entering the last lane, by row

    for (int32_t i = 1; i <= rows; ++i) {
        if constexpr (WARPS > 1) {
            sw::fuzz_delay(i, 0);
            if (lane == 0) {
                sh_bnd[wc][0] = Hp[0]; sh_bnd[wc][1] = Fp[0];
                sh_bnd[wc][2] = SHp[0]; sh_bnd[wc][3] = SFp[0];
                sh_bnd[wc][4] = S[0];
            }
            __syncthreads();
        }
        // the base entering the candidate's last lane on the way to row
        // i + 1: window column (i + 1 - 1) + kLanes - 1, 0-based.  A
        // one-warp segment loads SEGW of them at once, one a thread.
        uint32_t s_in;
        if constexpr (WARPS == 1) {
            if (((i - 1) & (SEGW - 1)) == 0)
                nbuf = base_selector(sw::text_at(
                    text, text_n, lo + (i + sl) + kLanes - 1));
            s_in = __shfl_sync(kFull, nbuf, (i - 1) & (SEGW - 1), SEGW);
        } else {
            s_in = last_thread ? base_selector(sw::text_at(
                text, text_n, lo + i + kLanes - 1)) : 0u;
        }
        // register 0 of the next thread (its low half is lane k0 + 2H);
        // past the candidate's last thread every lane is >= wl: NEG16
        uint32_t nH = __shfl_down_sync(kFull, Hp[0], 1, SEGW);
        uint32_t nF = __shfl_down_sync(kFull, Fp[0], 1, SEGW);
        uint32_t nSH = __shfl_down_sync(kFull, SHp[0], 1, SEGW);
        uint32_t nSF = __shfl_down_sync(kFull, SFp[0], 1, SEGW);
        uint32_t nS = __shfl_down_sync(kFull, S[0], 1, SEGW);
        if constexpr (WARPS > 1) sw::fuzz_delay(i, 1);
        if (sl == SEGW - 1) {
            if (WARPS > 1 && wc + 1 < WARPS) {
                nH = sh_bnd[wc + 1][0]; nF = sh_bnd[wc + 1][1];
                nSH = sh_bnd[wc + 1][2]; nSF = sh_bnd[wc + 1][3];
                nS = sh_bnd[wc + 1][4];
            } else {
                nH = NEGP; nF = NEGP; nSH = 0; nSF = 0; nS = s_in;
            }
        }
        // register 0 as it was: the sweep rewrites its F state and its
        // selector before register H-1 reads the high half as its neighbour
        const uint32_t F0 = Fp[0], SF0 = SFp[0], S0 = S[0];

        const bool row_ok = i <= last_row;
        const int32_t rc = row_ok ? (int32_t)read[i - 1] : 4;
        // the row's score bytes by window base
        const uint32_t lut =
            rc >= 4 ? 0xffffffffu : all_mm ^ (delta << (8 * rc));
        const uint32_t freshp = i == 1 ? 0u : clipp;
        const uint32_t endp = i == rl ? 0u : clipp;
        const uint32_t rowp = pk(i, i), prevp = pk(i - 1, i - 1);
        if (i > full_rows) {
            // tail rows: lane k is valid iff k < wl and i + k <= nl
            const int32_t lim = row_ok ? nl - i + 1 : 0;
#pragma unroll
            for (int j = 0; j < H; ++j) {
                const int32_t kl = k0 + j, kh = k0 + H + j;
                VM[j] = VK[j] & ((kl < lim ? 0x0000ffffu : 0u)
                                 | (kh < lim ? 0xffff0000u : 0u));
            }
        }

        // part 1: vertical gaps in place, the diagonal, their merge, the
        // scan value and its running aggregate of each half
        uint32_t HD[H], SD[H], H0[H], S0s[H], A[H];
        uint32_t aggP = NEGP, aggS = 0;
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const uint32_t sub = sw::prmt(lut, 0xffffffffu, S[j]);
            uint32_t hn, fn, shn, sfn;
            if (j + 1 < H) {
                hn = Hp[j + 1]; fn = Fp[j + 1];
                shn = SHp[j + 1]; sfn = SFp[j + 1];
                S[j] = S[j + 1];
            } else {
                hn = shift_pair(Hp[0], nH);
                fn = shift_pair(F0, nF);
                shn = shift_pair(SHp[0], nSH);
                sfn = shift_pair(SF0, nSF);
                // byte 0 from the high lane of register 0, byte 1 from
                // the next thread's low lane
                S[j] = __byte_perm(S0, nS, 0x0041);
            }
            uint32_t mf, md, mh, ma;
            const uint32_t f =
                max_ge(__vadd2(hn, ngoep), __vadd2(fn, ngep), mf);
            const uint32_t sf = sel(mf, shn, sfn);
            Fp[j] = f;
            SFp[j] = sf;
            const uint32_t hd = __vadd2(max_ge(Hp[j], freshp, md), sub);
            const uint32_t sd = sel(md, SHp[j], prevp);
            const uint32_t h0 = max_ge(hd, f, mh);
            const uint32_t s0 = sel(mh, sd, sf);
            const uint32_t a = __vadd2(h0, KEP[j]);
            HD[j] = hd; SD[j] = sd; H0[j] = h0; S0s[j] = s0; A[j] = a;
            aggP = max_ge(a, aggP, ma);
            aggS = sel(ma, s0, aggS);
        }

        // the thread's carry: its high half is nearer than its low half
        const int32_t aLo = lo16(aggP), aHi = hi16(aggP);
        int32_t tP = aHi >= aLo ? aHi : aLo;
        int32_t tS = aHi >= aLo ? hi16(aggS) : lo16(aggS);
        sw::scan_carries<SEGW>(tP, tS, sl);
        int32_t cP = NEG16, cS = 0;       // what enters lane 0 of the warp
        if constexpr (WARPS > 1) {
            sw::fuzz_delay(i, 2);
            if (lane == 31) { sh_agg[2 * wc] = tP; sh_agg[2 * wc + 1] = tS; }
            __syncthreads();
            sw::fuzz_delay(i, 3);
            if (sw::warp_carry(sh_agg, wc, cP, cS) && cP > tP) {
                tP = cP; tS = cS;
            }
        }
        int32_t XP = __shfl_up_sync(kFull, tP, 1, SEGW);
        int32_t XS = __shfl_up_sync(kFull, tS, 1, SEGW);
        if (sl == 0) { XP = cP; XS = cS; }
        // the high half's prefix also spans the low half, which is nearer
        const int32_t YP = XP > aLo ? XP : aLo;
        const int32_t YS = XP > aLo ? XS : lo16(aggS);
        uint32_t P = pk(XP, YP), PS = pk(XS, YS);

        // part 2: horizontal gaps from the exclusive prefix, merge, bests
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const uint32_t f = Fp[j], sf = SFp[j];
            const uint32_t e = __vadd2(P, NKEG[j]);
            uint32_t m1, m2, ma, keep;
            const uint32_t ef = max_ge(e, f, m1);
            max_ge(HD[j], ef, m2);
            const uint32_t h = __vmaxs2(H0[j], e);
            const uint32_t sh = sel(m2, SD[j], sel(m1, PS, sf));
            P = max_ge(A[j], P, ma);
            PS = sel(ma, S0s[j], PS);
            Hp[j] = sel(VM[j], h, NEGP);
            Fp[j] = sel(VM[j], f, NEGP);
            SHp[j] = sh;
            const uint32_t cand = sel(VM[j], __vadd2(h, endp), NEGP);
            // the first strict improvement of each lane
            BV[j] = max_ge(BV[j], cand, keep);
            BI[j] = sel(keep, BI[j], rowp);
            BS[j] = sel(keep, BS[j], sh);
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
    best = sw::reduce_best<SEGW>(best);
    if constexpr (WARPS > 1) {
        sw::fuzz_delay(rows + 1, 4);
        if (lane == 0) sh_best[wc] = best;
        __syncthreads();
        if (threadIdx.x != 0) return;
        for (int w = 1; w < WARPS; ++w) best.offer(sh_best[w]);
    } else if (sl != 0 || !live) {
        return;
    }
    int32_t *o = out + b * 4;
    o[0] = best.v <= NEG16 / 2 ? sw::NEG : best.v;
    o[1] = best.s;
    o[2] = best.i;
    o[3] = best.i + best.x;
}

template <int H, int SEGW, int WARPS>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len,
            const int32_t *wl, const int32_t *perm, int64_t N,
            sw::Scoring p, int32_t *out, cudaStream_t stream) {
    constexpr int threads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int per_block = WARPS > 1 ? 1 : 128 / SEGW;
    const int64_t blocks = (N + per_block - 1) / per_block;
    sw_banded16_kernel<H, SEGW, WARPS><<<(unsigned)blocks, threads, 0,
                                         stream>>>(
        text, text_n, oriented, L, olens, owners, win_lo, win_len, wl, perm,
        N, p, out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes.
int sw_banded16_max_wl() { return kMaxWl; }

// Scores the N candidates perm[perm_off .. perm_off + N) (perm null: 0 ..
// N) into their own rows of out (int32 [*, 4]: score, qb, qe, ref_end) on
// `stream`.  max_wl bounds their wl (1 <= wl[b] <= max_wl <=
// sw_banded16_max_wl(), and scores within the int16 range and a signed
// byte, checked by the caller); with N it picks the form, registers (of
// two lanes) x threads, per candidate (group 0; 8 takes the large class's
// form and 32 the small class's whatever N is, to time one against the
// other):
//
//   corridor   small class (<= 8 an SM)  large class
//   <=   32    1 x 16   2 a warp      2 x 8    4 a warp
//   <=   64    1 x 32                 4 x 8    4   (the usual chained 50)
//   <=   96    2 x 32                 3 x 16   2
//   <=  128 .. 512    2, 4, 8 x 32    one warp
//   <=  768, 1024     6, 8 x 32 x 2 warps      one block
//   <= 2048, 4096     8 x 32 x 4, 8 warps      one block
//
// Returns the launch's cudaGetLastError(); does not synchronise.
int sw_banded16_launch(const void *text, int64_t text_n,
                       const void *oriented, int64_t L, const void *olens,
                       const void *owners, const void *win_lo,
                       const void *win_len, const void *wl,
                       const void *perm, int64_t perm_off, int64_t N,
                       int32_t max_wl, int32_t group, int32_t match,
                       int32_t mismatch,
                       int32_t gap_open, int32_t gap_extend, int32_t clip,
                       void *out, void *stream) {
    if (N <= 0) return 0;
    if (max_wl < 1 || max_wl > kMaxWl) return (int)cudaErrorInvalidValue;
    if (group != 0 && group != 8 && group != 32)
        return (int)cudaErrorInvalidValue;
    if (match < -127 || match > 127 || mismatch < -127 || mismatch > 127)
        return (int)cudaErrorInvalidValue;
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
#define SW_CLASS(H, SEGW, WARPS)                                            \
    launch<H, SEGW, WARPS>(t, text_n, o, L, ol, ow, lo, ln, w, pm, N, p,    \
                           res, s)
    const bool big = group == 8
        || (group == 0 && N > kWarpClassPerSm * sw::sm_count());
    if (max_wl <= 32) { if (big) SW_CLASS(2, 8, 1); else SW_CLASS(1, 16, 1); }
    else if (max_wl <= 64) { if (big) SW_CLASS(4, 8, 1); else SW_CLASS(1, 32, 1); }
    else if (max_wl <= 96) { if (big) SW_CLASS(3, 16, 1); else SW_CLASS(2, 32, 1); }
    else if (max_wl <= 128) SW_CLASS(2, 32, 1);
    else if (max_wl <= 256) SW_CLASS(4, 32, 1);
    else if (max_wl <= 512) SW_CLASS(8, 32, 1);
    else if (max_wl <= 768) SW_CLASS(6, 32, 2);
    else if (max_wl <= 1024) SW_CLASS(8, 32, 2);
    else if (max_wl <= 2048) SW_CLASS(8, 32, 4);
    else SW_CLASS(8, 32, 8);
#undef SW_CLASS
    return (int)cudaGetLastError();
}

}  // extern "C"
