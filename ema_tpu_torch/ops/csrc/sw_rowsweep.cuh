// The int32 banded row sweep of sw_banded.cu (a part of a warp, a whole
// warp or several warps per candidate, by corridor-width class), its only
// user: sw_banded_packed.cu, which instantiated it at 16 threads x 4 lanes
// until it got a one-pass body of its own, keeps its recurrences and tie
// rules.  This body pays per cell for a bounds-checked byte load of the
// window base, the substitution score and the diagonal twice (a second
// pass recomputes the first), a branch on k < wl and on validity, and a
// five-field best-cell offer: 101.9 SASS instructions a cell at 8 threads
// x 8 lanes against a hand count of 21 (tools/bench_sw.py), the costs that
// sw_banded16.cu and sw_banded_packed.cu no longer pay.
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
// Layout: the candidate's SEGW * WARPS threads each own LPT contiguous
// lanes, state in registers.  The vertical dependency crosses threads by
// one __shfl_down_sync per state array (and, between the warps of a
// multi-warp candidate, through shared memory); the horizontal scan is a
// sequential in-thread scan, a shuffle scan of the thread carries and,
// for several warps, a join of the warp totals in shared memory with the
// same nearest-wins rule.  Two block barriers per row serve the
// multi-warp form: one publishes the previous row's lane-0 state, one the
// warp totals.
//
// Slot c of a launch scores candidate perm[c] (c itself when perm is
// null) and writes out[perm[c]]: a caller that sorted its candidates into
// width classes launches each class on its span of the permutation and
// gets the results back in its own order.
#pragma once

#include "sw_common.cuh"

namespace sw {

template <int LPT, int SEGW, int WARPS>
__global__ void __launch_bounds__(WARPS > 1 ? 32 * WARPS : 128)
rowsweep_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                const uint8_t *__restrict__ oriented, int64_t L,
                const int32_t *__restrict__ olens,
                const int32_t *__restrict__ owners,
                const int64_t *__restrict__ win_lo,
                const int32_t *__restrict__ win_len,
                const int32_t *__restrict__ wl_arr,
                const int32_t *__restrict__ perm, int64_t N, Scoring p,
                int32_t *__restrict__ out) {
    static_assert(WARPS == 1 || SEGW == 32,
                  "a multi-warp candidate is made of whole warps");
    constexpr int kThreads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int kCandPerBlock = WARPS > 1 ? 1 : kThreads / SEGW;
    constexpr int kW = WARPS > 1 ? WARPS : 1;
    __shared__ int32_t sh_bnd[kW][4];    // lane 0's previous-row state
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
    const int32_t goe = p.gap_open + p.gap_extend;
    const int32_t ge = p.gap_extend;
    const int32_t k0 = (WARPS > 1 ? (int)threadIdx.x : sl) * LPT;

    // rows past the read or past the window hold no valid cell; the
    // segments of one warp run the longest of their row counts
    const int32_t last_row = rl < nl ? rl : nl;
    int32_t rows = last_row;
#pragma unroll
    for (int off = SEGW; off < 32; off <<= 1) {
        const int32_t o = __shfl_xor_sync(kFull, rows, off);
        rows = o > rows ? o : rows;
    }

    // previous-row state of this thread's lanes
    int32_t Hp[LPT], Fp[LPT], SHp[LPT], SFp[LPT], rb[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        Hp[j] = NEG; Fp[j] = NEG; SHp[j] = 0; SFp[j] = 0; rb[j] = 5;
    }
    // this thread's best cell (x = lane k)
    Best best{NEG, 0, 0, 0, 0};

    for (int32_t i = 1; i <= rows; ++i) {
        if constexpr (WARPS > 1) {
            if (lane == 0) {
                sh_bnd[wc][0] = Hp[0]; sh_bnd[wc][1] = Fp[0];
                sh_bnd[wc][2] = SHp[0]; sh_bnd[wc][3] = SFp[0];
            }
            __syncthreads();
        }
        // previous-row state of lane k0 + LPT, held by the next thread;
        // past the candidate's last thread every lane is >= wl, hence NEG
        int32_t nH = __shfl_down_sync(kFull, Hp[0], 1, SEGW);
        int32_t nF = __shfl_down_sync(kFull, Fp[0], 1, SEGW);
        int32_t nSH = __shfl_down_sync(kFull, SHp[0], 1, SEGW);
        int32_t nSF = __shfl_down_sync(kFull, SFp[0], 1, SEGW);
        if (sl == SEGW - 1) {
            if (WARPS > 1 && wc + 1 < WARPS) {
                nH = sh_bnd[wc + 1][0]; nF = sh_bnd[wc + 1][1];
                nSH = sh_bnd[wc + 1][2]; nSF = sh_bnd[wc + 1][3];
            } else {
                nH = NEG; nF = NEG; nSH = 0; nSF = 0;
            }
        }

        const bool row_ok = i <= last_row;
        const int32_t rc = row_ok ? (int32_t)read[i - 1] : 4;
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
                rb[j] = text_at(text, text_n, col0 + j);
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
                const bool valid = row_ok && i + k <= nl;
                const int32_t h0 = hd >= f ? hd : f;
                const int32_t s0 = hd >= f ? sd : sf;
                const int32_t a = valid ? h0 + k * ge : NEG;
                if (a >= aggP) { aggP = a; aggS = s0; }
            }
        }

        // inclusive scan of the carries; then, for several warps, the
        // carry of the earlier warps, which loses ties to every lane here
        scan_carries<SEGW>(aggP, aggS, sl);
        int32_t cP = NEG, cS = 0;        // what enters lane 0 of the warp
        if constexpr (WARPS > 1) {
            if (lane == 31) { sh_agg[2 * wc] = aggP; sh_agg[2 * wc + 1] = aggS; }
            __syncthreads();
            if (warp_carry(sh_agg, wc, cP, cS) && cP > aggP) {
                aggP = cP; aggS = cS;
            }
        }
        int32_t P = __shfl_up_sync(kFull, aggP, 1, SEGW);
        int32_t PS = __shfl_up_sync(kFull, aggS, 1, SEGW);
        if (sl == 0) { P = cP; PS = cS; }

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
                const bool valid = row_ok && i + k <= nl;
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
                if (valid) best.offer(Best{h + end_adj, 2 * i + k, i, k, sh});
            }
        }
    }

    // reduction of the thread bests: max score, min 2i + k, min i
    best = reduce_best<SEGW>(best);
    if constexpr (WARPS > 1) {
        if (lane == 0) sh_best[wc] = best;
        __syncthreads();
        if (threadIdx.x != 0) return;
        for (int w = 1; w < WARPS; ++w) best.offer(sh_best[w]);
    } else if (sl != 0 || !live) {
        return;
    }
    int32_t *o = out + b * 4;
    o[0] = best.v;
    o[1] = best.s;
    o[2] = best.i;
    o[3] = best.i + best.x;
}

}  // namespace sw
