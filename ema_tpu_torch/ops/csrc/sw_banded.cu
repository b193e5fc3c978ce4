// Banded Smith-Waterman scoring with the window gather fused in, for Hopper
// (sm_90a): a one-pass int32 row sweep.  Built by
// ema_tpu_torch/ops/_build.py with nvcc into a shared library with a plain
// C interface, called through ctypes.
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
//   E  = max_{k' < k} (H0[k'] + k' ge) - k ge - go             (horizontal)
//   H  = max(H0, E), start rows merged diag >= horizontal >= vertical.
// The horizontal max-plus scan prefers the nearest source (larger k') on
// ties; each lane keeps its first strict improvement; the final pick is
// max score, then min 2i + k, then min i.
//
// Layout: a candidate's SEGW * WARPS threads each own LPT contiguous
// lanes, state in registers.  The vertical dependency crosses threads by
// one __shfl_down_sync per state array and, between the warps of a
// several-warp candidate, through shared memory; the horizontal scan is an
// in-thread scan, a shuffle scan of the thread carries and, for several
// warps, a shuffle scan of the warp totals read from shared memory, all
// with the nearer source winning ties.  A several-warp row pays two block
// barriers: one publishes the previous row's lane-0 state, one the warp
// totals.
//
// What bounds it on this card: integer ALU issue over rl x wl cells, about
// twenty dependent-free int32 instructions a cell that no layout removes
// (tools/bench_sw.py: MIN_INSTR_PER_CELL), plus what a row costs a thread
// whatever its lanes: the shuffles of the vertical hand-off and of the
// carry scan, and for a small call the latency of those dependent rows.
// The body is the one-pass sweep that sw_banded_packed.cu proved (its
// forms 48.4 SASS instructions a cell against this kernel's former 101.9):
//   * one pass computes the vertical gap, the diagonal, their merge and
//     the scan value, and keeps them in registers; after the carry scan
//     only the horizontal gap, the final merge and the lane's best remain;
//   * validity: a lane is valid iff k < wl and i + k <= nl, a prefix of the
//     lanes, and an invalid lane feeds only lanes that are invalid too, so
//     the scan runs unmasked and H and F are held at NEG by one mask per
//     lane: a per-candidate constant (k < wl) until the rows where
//     i + wl - 1 > nl, and only those tail rows rebuild it.  No branch
//     depends on the lane inside the unrolled lane loops; k ge is a
//     per-thread constant;
//   * the window is read once: each lane's base is one nibble of a prmt
//     selector (byte c of the row's score word, or byte 4 of the second
//     operand for an N or a column outside the text), eight lanes a word,
//     and every lane takes its right neighbour's nibble each row by a
//     funnel shift that brings in the next thread's lane 0.  The bases
//     entering the candidate's last lane, and the read's bases, come one a
//     thread for the next SEGW rows, loaded a period ahead of their use,
//     so no global load sits on a row's critical path;
//   * the substitution score: with match and mismatch within a signed byte
//     (BYTE), the row's read base makes a word of four score bytes, one
//     prmt by a nibble quad gives four lanes' scores as bytes and one more
//     a lane spreads its byte's sign; any other int32 scoring takes the
//     same lookups as masks (equal base, window N) and two LOP3 a lane, so
//     the kernel takes every scoring the JAX banded scorer takes;
//   * each lane keeps its best (value, row, start) by the first strict
//     improvement, as the JAX kernel keeps bestv/besti/bests; the
//     three-key pick happens once, after the last row.
//
// Slot c of a launch scores candidate perm[c] (c itself when perm is
// null) and writes out[perm[c]]: a caller that sorted its candidates into
// width classes launches each class on its span of the permutation and
// gets the results back in its own order.  The form of a class (the table
// at the bottom) depends on its width and on the call's candidates for
// each SM of the card: a large call takes the form with the most lanes a
// thread its registers hold (fewest shuffles a cell), a small call, bound
// by the latency of its dependent rows, spreads a candidate over more
// threads (mate rescue: one or two candidates of about 600 lanes take
// eight warps of 3 lanes a thread, where the former body gave them one
// warp of 24).

#include "sw_common.cuh"

namespace {

using sw::Best;
using sw::kFull;
using sw::NEG;

constexpr int kMaxWl = 4096;

// the selector nibble of a window base: byte c of the row's score word,
// or byte 4 (of the second operand) for an N or a column outside the text
__device__ __forceinline__ uint32_t base_nibble(int32_t c) {
    return c >= 4 ? 4u : (uint32_t)c;
}

// prmt selector that sign-spreads byte b of a word over 32 bits
__host__ __device__ constexpr uint32_t sext_byte(int b) {
    return (uint32_t)b | ((8u | (uint32_t)b) * 0x1110u);
}

__device__ __forceinline__ int32_t pick(uint32_t m, int32_t a, int32_t b) {
    return (int32_t)(((uint32_t)a & m) | ((uint32_t)b & ~m));
}

template <int LPT, int SEGW, int WARPS, bool BYTE>
__global__ void __launch_bounds__(WARPS > 1 ? 32 * WARPS : 128)
sw_banded_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                 const uint8_t *__restrict__ oriented, int64_t L,
                 const int32_t *__restrict__ olens,
                 const int32_t *__restrict__ owners,
                 const int64_t *__restrict__ win_lo,
                 const int32_t *__restrict__ win_len,
                 const int32_t *__restrict__ wl_arr,
                 const int32_t *__restrict__ perm, int64_t N,
                 sw::Scoring p, int32_t *__restrict__ out) {
    static_assert(WARPS == 1 || SEGW == 32,
                  "a several-warp candidate is made of whole warps");
    static_assert(WARPS <= 32, "the warp totals are scanned in one warp");
    constexpr int kThreads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int kCandPerBlock = WARPS > 1 ? 1 : kThreads / SEGW;
    constexpr int kW = WARPS > 1 ? WARPS : 1;
    constexpr int kLanes = LPT * SEGW * kW;        // lanes of a candidate
    // selector words: lane j is nibble kOff + j of the words in order
    // (word w holds nibbles 8w .. 8w + 7), the lanes at the top
    constexpr int kWords = (LPT + 7) / 8;
    constexpr int kOff = 8 * kWords - LPT;
    constexpr int kQ0 = kOff / 4;                  // first nibble quad used
    constexpr int kQuads = 2 * kWords;
    __shared__ uint32_t sh_bnd[kW][5];   // lane 0's previous-row state
    __shared__ int32_t sh_agg[kW][2];    // warp totals of the row's scan
    __shared__ Best sh_best[kW];

    const int lane = threadIdx.x & 31;
    const int sl = threadIdx.x & (SEGW - 1);          // thread in segment
    const int wc = WARPS > 1 ? (int)(threadIdx.x >> 5) : 0;
    const int tc = WARPS > 1 ? (int)threadIdx.x : sl; // thread of candidate
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
    const int32_t goe = p.gap_open + ge;
    const int32_t k0 = tc * LPT;
    // BYTE: the row's score bytes are all_mm with byte rc flipped to match
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

    // previous-row state, per-lane bests, k ge and the lane masks (all
    // ones where valid: k < wl, then this row's in the tail rows)
    int32_t Hp[LPT], Fp[LPT], SHp[LPT], SFp[LPT], BV[LPT], BI[LPT], BS[LPT];
    int32_t KE[LPT];
    uint32_t VM[LPT];
    // row 1: lane k is at window column k (the lanes past wl too: their
    // bases slide into the corridor row by row)
    uint32_t sel[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) sel[w] = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int32_t k = k0 + j;
        Hp[j] = NEG; Fp[j] = NEG; SHp[j] = 0; SFp[j] = 0;
        BV[j] = NEG; BI[j] = 0; BS[j] = 0;
        KE[j] = k * ge;
        VM[j] = k < wl ? ~0u : 0u;
        const int n = kOff + j;
        sel[n >> 3] |= base_nibble(sw::text_at(text, text_n, lo + k))
            << (4 * (n & 7));
    }
    // staged bases, one a thread of the segment for each of its next SEGW
    // rows: the read's base of the row, and the window base that enters
    // the candidate's last lane on the way to the next row (window column
    // i + kLanes - 1, 0-based, after row i); *_next is a period ahead
    auto read_base = [&](int32_t r) -> uint32_t {   // 0-based read row
        return r < last_row ? (uint32_t)read[r] : 4u;
    };
    auto entering = [&](int32_t i) -> uint32_t {
        return base_nibble(sw::text_at(text, text_n, lo + i + kLanes - 1));
    };
    uint32_t r_cur = 4u, w_cur = 4u;
    uint32_t r_next = read_base(sl), w_next = entering(1 + sl);

    for (int32_t i = 1; i <= rows; ++i) {
        const int phase = (i - 1) & (SEGW - 1);
        if (phase == 0) {
            r_cur = r_next;
            w_cur = w_next;
            r_next = read_base(i - 1 + SEGW + sl);
            w_next = entering(i + SEGW + sl);
        }
        // lane 0 of the thread as a selector quad at nibble 0
        const uint32_t sel0 = sel[0] >> (4 * kOff);
        if constexpr (WARPS > 1) {
            if (lane == 0) {
                sh_bnd[wc][0] = (uint32_t)Hp[0];
                sh_bnd[wc][1] = (uint32_t)Fp[0];
                sh_bnd[wc][2] = (uint32_t)SHp[0];
                sh_bnd[wc][3] = (uint32_t)SFp[0];
                sh_bnd[wc][4] = sel0;
            }
            __syncthreads();
        }
        const int32_t rc = (int32_t)__shfl_sync(kFull, r_cur, phase, SEGW);
        const uint32_t s_in = __shfl_sync(kFull, w_cur, phase, SEGW);
        // lane k0 + LPT's previous-row state and selector, held by the next
        // thread; past the candidate's last thread every lane is >= wl
        int32_t nH = __shfl_down_sync(kFull, Hp[0], 1, SEGW);
        int32_t nF = __shfl_down_sync(kFull, Fp[0], 1, SEGW);
        int32_t nSH = __shfl_down_sync(kFull, SHp[0], 1, SEGW);
        int32_t nSF = __shfl_down_sync(kFull, SFp[0], 1, SEGW);
        uint32_t nsel = __shfl_down_sync(kFull, sel0, 1, SEGW);
        if (sl == SEGW - 1) {
            if (WARPS > 1 && wc + 1 < WARPS) {
                nH = (int32_t)sh_bnd[wc + 1][0];
                nF = (int32_t)sh_bnd[wc + 1][1];
                nSH = (int32_t)sh_bnd[wc + 1][2];
                nSF = (int32_t)sh_bnd[wc + 1][3];
                nsel = sh_bnd[wc + 1][4];
            } else {
                nH = NEG; nF = NEG; nSH = 0; nSF = 0; nsel = s_in;
            }
        }

        // the row's lookups, four lanes a prmt by a nibble quad: the score
        // bytes (BYTE), else an equal-base mask and a window-N mask
        uint32_t qa[kQuads], qn[kQuads];
        uint32_t lut, mmr = 0, xr = 0;
        if constexpr (BYTE) {
            lut = rc >= 4 ? 0xffffffffu : all_mm ^ (delta << (8 * rc));
        } else {
            lut = rc >= 4 ? 0u : 0xffu << (8 * rc);
            mmr = rc >= 4 ? ~0u : (uint32_t)(-p.mismatch);
            xr = rc >= 4 ? 0u : (uint32_t)(p.match ^ -p.mismatch);
        }
#pragma unroll
        for (int q = kQ0; q < kQuads; ++q) {
            const uint32_t s = sel[q >> 1] >> (16 * (q & 1));
            qa[q] = sw::prmt(lut, BYTE ? 0xffffffffu : 0u, s);
            if constexpr (!BYTE) qn[q] = sw::prmt(0u, 0xffffffffu, s);
        }
        // the next row's selectors: every lane takes its right neighbour's
#pragma unroll
        for (int w = 0; w < kWords; ++w)
            sel[w] = __funnelshift_r(sel[w], w + 1 < kWords ? sel[w + 1]
                                                            : nsel, 4);
        const bool row_ok = i <= last_row;
        const int32_t fresh = i == 1 ? 0 : -p.clip;
        const int32_t endp = i == rl ? 0 : -p.clip;
        if (i > full_rows) {
            // tail rows: lane k is valid iff k < wl and i + k <= nl
            const int32_t lim = row_ok ? (nl - i + 1 < wl ? nl - i + 1 : wl)
                                       : 0;
#pragma unroll
            for (int j = 0; j < LPT; ++j)
                VM[j] = k0 + j < lim ? ~0u : 0u;
        }

        // part 1: vertical gaps in place (ascending j reads lane j + 1
        // before it is overwritten), the diagonal, their merge, the scan
        // value and the thread's running aggregate
        int32_t HD[LPT], SD[LPT], H0[LPT], S0[LPT];
        int32_t aggP = NEG, aggS = 0;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int n = kOff + j;
            const uint32_t sx = sext_byte(n & 3);
            int32_t sub;
            if constexpr (BYTE) {
                sub = (int32_t)sw::prmt(qa[n >> 2], 0u, sx);
            } else {
                const uint32_t eq = sw::prmt(qa[n >> 2], 0u, sx);
                const uint32_t isn = sw::prmt(qn[n >> 2], 0u, sx);
                sub = (int32_t)(((eq & xr) ^ mmr) | isn);
            }
            const int32_t hn = j + 1 < LPT ? Hp[j + 1] : nH;
            const int32_t fn = j + 1 < LPT ? Fp[j + 1] : nF;
            const int32_t shn = j + 1 < LPT ? SHp[j + 1] : nSH;
            const int32_t sfn = j + 1 < LPT ? SFp[j + 1] : nSF;
            const int32_t fo = hn - goe, fe = fn - ge;
            const int32_t f = fo >= fe ? fo : fe;
            const int32_t sf = fo >= fe ? shn : sfn;
            Fp[j] = f;
            SFp[j] = sf;
            const int32_t ph = Hp[j];
            const int32_t hd = (ph >= fresh ? ph : fresh) + sub;
            const int32_t sd = ph >= fresh ? SHp[j] : i - 1;
            const int32_t h0 = hd >= f ? hd : f;
            const int32_t s0 = hd >= f ? sd : sf;
            const int32_t a = h0 + KE[j];
            HD[j] = hd; SD[j] = sd; H0[j] = h0; S0[j] = s0;
            if (a >= aggP) { aggP = a; aggS = s0; }
        }

        // inclusive scan of the thread carries; then, for several warps,
        // the carry of the earlier warps, which loses ties to every lane here
        sw::scan_carries<SEGW>(aggP, aggS, sl);
        int32_t cP = NEG, cS = 0;        // what enters lane 0 of the warp
        if constexpr (WARPS > 1) {
            if (lane == 31) { sh_agg[wc][0] = aggP; sh_agg[wc][1] = aggS; }
            __syncthreads();
            // lane w < WARPS scans warp w's total, the nearer winning ties
            int32_t wP = lane < WARPS ? sh_agg[lane][0] : NEG;
            int32_t wS = lane < WARPS ? sh_agg[lane][1] : 0;
#pragma unroll
            for (int off = 1; off < WARPS; off <<= 1) {
                const int32_t oP = __shfl_up_sync(kFull, wP, off);
                const int32_t oS = __shfl_up_sync(kFull, wS, off);
                if (lane >= off && oP > wP) { wP = oP; wS = oS; }
            }
            const int src = wc > 0 ? wc - 1 : 0;
            const int32_t xP = __shfl_sync(kFull, wP, src);
            const int32_t xS = __shfl_sync(kFull, wS, src);
            if (wc > 0) {
                cP = xP; cS = xS;
                if (cP > aggP) { aggP = cP; aggS = cS; }
            }
        }
        int32_t P = __shfl_up_sync(kFull, aggP, 1, SEGW);
        int32_t PS = __shfl_up_sync(kFull, aggS, 1, SEGW);
        if (sl == 0) { P = cP; PS = cS; }

        // part 2: horizontal gaps from the exclusive prefix, merge, bests
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int32_t f = Fp[j], sf = SFp[j];
            const int32_t e = P - KE[j] - p.gap_open;
            const int32_t ef = e >= f ? e : f;
            const int32_t h = H0[j] >= e ? H0[j] : e;
            const int32_t sh = HD[j] >= ef ? SD[j] : (e >= f ? PS : sf);
            const int32_t a = H0[j] + KE[j];
            if (a >= P) { P = a; PS = S0[j]; }
            Hp[j] = pick(VM[j], h, NEG);
            Fp[j] = pick(VM[j], f, NEG);
            SHp[j] = sh;
            // an invalid lane offers NEG + endp, never a strict improvement
            const int32_t cand = Hp[j] + endp;
            if (cand > BV[j]) { BV[j] = cand; BI[j] = i; BS[j] = sh; }
        }
    }

    // the per-lane bests: max score, min 2i + k, min i
    Best best{NEG, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int32_t k = k0 + j;
        best.offer(Best{BV[j], 2 * BI[j] + k, BI[j], k, BS[j]});
    }
    best = sw::reduce_best<SEGW>(best);
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

template <int LPT, int SEGW, int WARPS>
void launch(bool byte_scores, const uint8_t *text, int64_t text_n,
            const uint8_t *oriented, int64_t L, const int32_t *olens,
            const int32_t *owners, const int64_t *win_lo,
            const int32_t *win_len, const int32_t *wl, const int32_t *perm,
            int64_t N, sw::Scoring p, int32_t *out, cudaStream_t stream) {
    constexpr int threads = WARPS > 1 ? 32 * WARPS : 128;
    constexpr int per_block = WARPS > 1 ? 1 : 128 / SEGW;
    const unsigned blocks = (unsigned)((N + per_block - 1) / per_block);
    if (byte_scores)
        sw_banded_kernel<LPT, SEGW, WARPS, true><<<blocks, threads, 0,
                                                   stream>>>(
            text, text_n, oriented, L, olens, owners, win_lo, win_len, wl,
            perm, N, p, out);
    else
        sw_banded_kernel<LPT, SEGW, WARPS, false><<<blocks, threads, 0,
                                                    stream>>>(
            text, text_n, oriented, L, olens, owners, win_lo, win_len, wl,
            perm, N, p, out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes.
int sw_banded_max_wl() { return kMaxWl; }

// Scores the N candidates perm[perm_off .. perm_off + N) (perm null: 0 ..
// N) into their own rows of out (int32 [*, 4]: score, qb, qe, ref_end) on
// `stream`.  max_wl bounds their wl (1 <= wl[b] <= max_wl <=
// sw_banded_max_wl(), checked by the caller); with N it picks the form,
// warps x threads x lanes a thread, per candidate: a class takes its
// small call's form up to the given candidates for each SM of the card,
// its large call's form above (group 0; 32 takes the small call's form and
// 8 the large call's whatever N is, to time one against the other):
//
//   corridor   small call                   large call
//   <=   32    16 x 2 (<= 16 an SM)         8 x 4      4 candidates a warp
//   <=   64    32 x 2 (<= 12)               8 x 8      (chained, 50..60)
//   <=   96    32 x 3 (<= 4)                16 x 6
//   <=  128    32 x 4 (<= 8)                16 x 8
//   <=  256    32 x 8                       32 x 8
//   <=  512    4 warps x 32 x 4 (<= 2)      32 x 16
//   <=  768    8 warps x 32 x 3 (<= 1)      2 warps x 32 x 12  (rescue)
//   <= 1024    4 warps x 32 x 8 (<= 2)      2 warps x 32 x 16
//   <= 2048    8 warps x 32 x 8 (<= 1)      4 warps x 32 x 16
//   <= 4096    8 warps x 32 x 16            8 warps x 32 x 16
//
// Where the forms cross was timed on the card (launches alone, wl 20, 50,
// 80, 120 on 100 bp reads and 200 to 3000 on the rescue set's, 1 to
// 65,536 candidates): a large call runs fastest on the most lanes a thread
// that fit its registers without a spill (16, at 209-232 registers), a
// small one, bound by the latency of its dependent rows, on more threads
// a candidate, up to 8 warps, with 2 to 8 lanes a thread.  Scores within
// a signed byte take the byte lookups, any other int32 scoring the mask
// form of the same body.  Returns the launch's cudaGetLastError() (0 on
// success); does not synchronise.
int sw_banded_launch(const void *text, int64_t text_n, const void *oriented,
                     int64_t L, const void *olens, const void *owners,
                     const void *win_lo, const void *win_len, const void *wl,
                     const void *perm, int64_t perm_off, int64_t N,
                     int32_t max_wl, int32_t group, int32_t match,
                     int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                     int32_t clip, void *out, void *stream) {
    if (N <= 0) return 0;
    if (max_wl < 1 || max_wl > kMaxWl) return (int)cudaErrorInvalidValue;
    if (group != 0 && group != 8 && group != 32)
        return (int)cudaErrorInvalidValue;
    const sw::Scoring p{match, mismatch, gap_open, gap_extend, clip};
    const bool byte_scores = match >= -127 && match <= 127
        && mismatch >= -127 && mismatch <= 127;
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
    const int64_t sms = sw::sm_count();
    // whether the call takes its class's small-call form
    auto small = [&](int64_t per_sm) {
        return group == 32 || (group == 0 && N <= per_sm * sms);
    };
#define SW_FORM(LPT, SEGW, WARPS)                                           \
    launch<LPT, SEGW, WARPS>(byte_scores, t, text_n, o, L, ol, ow, lo, ln,  \
                             w, pm, N, p, res, s)
    if (max_wl <= 32) { if (small(16)) SW_FORM(2, 16, 1); else SW_FORM(4, 8, 1); }
    else if (max_wl <= 64) { if (small(12)) SW_FORM(2, 32, 1); else SW_FORM(8, 8, 1); }
    else if (max_wl <= 96) { if (small(4)) SW_FORM(3, 32, 1); else SW_FORM(6, 16, 1); }
    else if (max_wl <= 128) { if (small(8)) SW_FORM(4, 32, 1); else SW_FORM(8, 16, 1); }
    else if (max_wl <= 256) SW_FORM(8, 32, 1);
    else if (max_wl <= 512) { if (small(2)) SW_FORM(4, 32, 4); else SW_FORM(16, 32, 1); }
    else if (max_wl <= 768) { if (small(1)) SW_FORM(3, 32, 8); else SW_FORM(12, 32, 2); }
    else if (max_wl <= 1024) { if (small(2)) SW_FORM(8, 32, 4); else SW_FORM(16, 32, 2); }
    else if (max_wl <= 2048) { if (small(1)) SW_FORM(8, 32, 8); else SW_FORM(16, 32, 4); }
    else SW_FORM(16, 32, 8);
#undef SW_FORM
    return (int)cudaGetLastError();
}

}  // extern "C"
