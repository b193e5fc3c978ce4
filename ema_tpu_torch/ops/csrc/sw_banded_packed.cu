// The pair-packed 64-diagonal tier of the banded Smith-Waterman scorer,
// with the window gather fused in, for Hopper (sm_90a): a one-pass int32
// row sweep of its own.  Built by ema_tpu_torch/ops/_build.py with nvcc
// into a plain-C shared library.
//
// Replaces the TPU kernel ema_tpu/ops/sw_pallas.py:_banded_kernel_packed
// (behind sw_score_banded_pallas_packed), which packs two candidates with
// corridors wl <= 64 into one 128-lane vector row and masks every shift
// and its scan (which stops at 32) by 64-lane segment.  Its output is
// sw_score_banded's at w_band = 64, as the JAX wrapper documents; the plain
// PyTorch twin is ema_tpu_torch/ops/sw.py:sw_score_banded_packed_ref.
// Start rows live in their own registers: the JAX kernel's scan key
// (A << 17) | (kk << 8) | S0 keeps only the low 8 bits of the start row
// (P & 255), so reads past 256 bp come back with the start modulo 256
// there; that packing is not carried over.
//
// Layout: a candidate is a segment of SEGW threads of LPT lanes each
// (SEGW x LPT = 64), one segment per corridor, two (16 x 4) or four (8 x 8)
// candidates a warp; every shuffle runs at the segment's width, so the
// vertical hand-off, the horizontal-gap scan and the best-cell reduction
// stop at its edge.  The segments of a warp run the longest of their row
// counts; rows past a segment's own read or window hold no valid cell.
// The recurrences and tie rules are those of sw_banded.cu, whose one-pass
// body is this one generalised to any lanes a thread and to several warps
// a candidate: the scan prefers the nearer source, merges go diag >=
// horizontal >= vertical, each lane keeps its first strict improvement,
// and the pick is max score, then min 2i + k, then min i.
//
// What bounds it on this card: integer ALU issue over rl x wl cells, about
// twenty dependent-free int32 instructions a cell that no layout removes
// (tools/bench_sw.py: MIN_INSTR_PER_CELL), plus what a row costs a thread
// whatever its lanes: the shuffles of the vertical hand-off and of the
// carry scan.  The former shared two-pass row sweep (101.9 SASS
// instructions a cell at 8 x 8) paid per cell for a bounds-checked byte
// load of the window, the substitution score twice, a second pass that
// recomputed the first, a branch on k < wl and on validity, and a
// five-field best-cell offer.  Here:
//   * one pass computes the vertical gap, the diagonal, their merge and
//     the scan value, and keeps them in registers; the part after the scan
//     (the horizontal gap from the exclusive prefix, the final merge, the
//     lane's best) computes nothing twice;
//   * validity: a lane is valid iff k < wl and i + k <= nl, a prefix of the
//     lanes, and an invalid lane feeds only lanes that are invalid too, so
//     the scan runs unmasked and H and F are held at NEG by one mask per
//     lane: a per-candidate constant (k < wl) until the rows where
//     i + wl - 1 > nl, and only those tail rows rebuild it.  No branch
//     depends on the lane inside the unrolled lane loops; k ge and
//     -(k ge + go) are per-thread constants;
//   * the window is read once: each lane's base lives in the thread's
//     selector word as one nibble of a prmt selector (the score byte of
//     base c, or byte 4 of the all -1 operand for an N or a column outside
//     the text), four lanes a nibble quad, and slides by one lane a row
//     with one funnel shift that brings in the next thread's lane 0; the
//     segment loads its next SEGW bases, one a thread, every SEGW rows, and
//     the out-of-text check moves to that load.  The row's read base makes
//     a word of four score bytes; one prmt by a nibble quad gives four
//     lanes' scores as bytes, and a lane's score is one more prmt that
//     spreads its byte's sign over 32 bits.  Scores must fit a signed
//     byte;
//   * each lane keeps its best (value, row, start) by the first strict
//     improvement, as the JAX kernel keeps bestv/besti/bests; the three-key
//     pick happens once, after the last row.
// The launch picks 8 x 8 (four candidates a warp, fewer shuffles a cell)
// when the call holds more than kWarpCallPerSm candidates for each SM, and
// 16 x 4 (more threads for a small call) below that.

#include "sw_common.cuh"

namespace {

using sw::Best;
using sw::kFull;
using sw::NEG;

constexpr int kSegLanes = 64;       // one corridor of at most 64 lanes
constexpr int kThreads = 128;
// The call takes 8 threads x 8 lanes a candidate from more than this many
// candidates for each SM of the card (the rule of sw_batch.cu and
// sw_banded16.cu), 16 x 4 below it.
constexpr int64_t kWarpCallPerSm = 8;

// the selector nibble of a window base: byte c of the row's score word,
// or byte 4 (of the all -1 operand) for an N or a column outside the text
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

template <int LPT, int SEGW>
__global__ void __launch_bounds__(kThreads)
sw_banded_packed_kernel(const uint8_t *__restrict__ text, int64_t text_n,
                        const uint8_t *__restrict__ oriented, int64_t L,
                        const int32_t *__restrict__ olens,
                        const int32_t *__restrict__ owners,
                        const int64_t *__restrict__ win_lo,
                        const int32_t *__restrict__ win_len,
                        const int32_t *__restrict__ wl_arr, int64_t N,
                        sw::Scoring p, int32_t *__restrict__ out) {
    static_assert(LPT * SEGW == kSegLanes, "a segment is one corridor");
    static_assert(LPT == 4 || LPT == 8, "scores are looked up by fours");
    // lane j's selector is nibble kNib0 + j of the word: 8 lanes fill it,
    // 4 lanes sit in its high half
    constexpr int kNib0 = 8 - LPT;
    constexpr int kCandPerBlock = kThreads / SEGW;

    const int sl = threadIdx.x & (SEGW - 1);           // thread in segment
    const int64_t b = (int64_t)blockIdx.x * kCandPerBlock
        + (int64_t)(threadIdx.x / SEGW);
    // a segment past N stays for its partners' shuffles with no rows and
    // no lanes
    const bool live = b < N;
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
    const int32_t k0 = sl * LPT;
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

    // previous-row state, per-lane bests, the lane masks (all ones where
    // valid: VK k < wl, VM this row's), k ge and -(k ge + go)
    int32_t Hp[LPT], Fp[LPT], SHp[LPT], SFp[LPT], BV[LPT], BI[LPT], BS[LPT];
    int32_t KE[LPT], NKEG[LPT];
    uint32_t VK[LPT], VM[LPT];
    // row 1: lane k is at window column k (the lanes past wl too: their
    // bases slide into the corridor row by row)
    uint32_t sel = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        const int32_t k = k0 + j;
        Hp[j] = NEG; Fp[j] = NEG; SHp[j] = 0; SFp[j] = 0;
        BV[j] = NEG; BI[j] = 0; BS[j] = 0;
        KE[j] = k * ge;
        NKEG[j] = -k * ge - p.gap_open;
        VK[j] = k < wl ? ~0u : 0u;
        VM[j] = VK[j];
        sel |= base_nibble(sw::text_at(text, text_n, lo + k))
            << (4 * (kNib0 + j));
    }
    uint32_t nbuf = 4u;       // the selector entering the last lane, by row

    for (int32_t i = 1; i <= rows; ++i) {
        // the base entering the candidate's last lane on the way to row
        // i + 1: window column (i + 1 - 1) + 63, 0-based; the segment loads
        // SEGW of them at once, one a thread
        if (((i - 1) & (SEGW - 1)) == 0)
            nbuf = base_nibble(sw::text_at(text, text_n,
                                           lo + (i + sl) + kSegLanes - 1));
        const uint32_t s_in =
            __shfl_sync(kFull, nbuf, (i - 1) & (SEGW - 1), SEGW);
        // lanes 0..3 of the thread at nibbles 0..3
        const uint32_t sel_lo = LPT == 4 ? sel >> 16 : sel;
        // lane k0 + LPT's previous-row state and selector, held by the next
        // thread; past the segment's last thread every lane is >= wl
        int32_t nH = __shfl_down_sync(kFull, Hp[0], 1, SEGW);
        int32_t nF = __shfl_down_sync(kFull, Fp[0], 1, SEGW);
        int32_t nSH = __shfl_down_sync(kFull, SHp[0], 1, SEGW);
        int32_t nSF = __shfl_down_sync(kFull, SFp[0], 1, SEGW);
        uint32_t nsel = __shfl_down_sync(kFull, sel_lo, 1, SEGW);
        if (sl == SEGW - 1) {
            nH = NEG; nF = NEG; nSH = 0; nSF = 0; nsel = s_in;
        }

        const bool row_ok = i <= last_row;
        const int32_t rc = row_ok ? (int32_t)read[i - 1] : 4;
        // the row's score bytes by window base; four lanes' scores a prmt
        const uint32_t lut =
            rc >= 4 ? 0xffffffffu : all_mm ^ (delta << (8 * rc));
        uint32_t sub4[LPT / 4];
        sub4[0] = sw::prmt(lut, 0xffffffffu, sel_lo);
        if constexpr (LPT == 8) sub4[1] = sw::prmt(lut, 0xffffffffu, sel >> 16);
        // the next row's selectors: every lane takes its right neighbour's
        sel = __funnelshift_r(sel, nsel, 4);
        const int32_t fresh = i == 1 ? 0 : -p.clip;
        const int32_t endp = i == rl ? 0 : -p.clip;
        if (i > full_rows) {
            // tail rows: lane k is valid iff k < wl and i + k <= nl
            const int32_t lim = row_ok ? nl - i + 1 : 0;
#pragma unroll
            for (int j = 0; j < LPT; ++j)
                VM[j] = VK[j] & (k0 + j < lim ? ~0u : 0u);
        }

        // part 1: vertical gaps in place (ascending j reads lane j + 1
        // before it is overwritten), the diagonal, their merge, the scan
        // value and the thread's running aggregate
        int32_t HD[LPT], SD[LPT], H0[LPT], S0[LPT], A[LPT];
        int32_t aggP = NEG, aggS = 0;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int32_t sub =
                (int32_t)sw::prmt(sub4[j >> 2], 0u, sext_byte(j & 3));
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
            HD[j] = hd; SD[j] = sd; H0[j] = h0; S0[j] = s0; A[j] = a;
            if (a >= aggP) { aggP = a; aggS = s0; }
        }

        // inclusive scan of the thread carries, then the exclusive prefix
        // entering the thread's lane 0
        sw::scan_carries<SEGW>(aggP, aggS, sl);
        int32_t P = __shfl_up_sync(kFull, aggP, 1, SEGW);
        int32_t PS = __shfl_up_sync(kFull, aggS, 1, SEGW);
        if (sl == 0) { P = NEG; PS = 0; }

        // part 2: horizontal gaps from the exclusive prefix, merge, bests
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
            const int32_t f = Fp[j], sf = SFp[j];
            const int32_t e = P + NKEG[j];
            const int32_t ef = e >= f ? e : f;
            const int32_t h = H0[j] >= e ? H0[j] : e;
            const int32_t sh = HD[j] >= ef ? SD[j] : (e >= f ? PS : sf);
            if (A[j] >= P) { P = A[j]; PS = S0[j]; }
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
    if (sl != 0 || !live) return;
    int32_t *o = out + b * 4;
    o[0] = best.v;
    o[1] = best.s;
    o[2] = best.i;
    o[3] = best.i + best.x;
}

template <int LPT, int SEGW>
void launch(const uint8_t *text, int64_t text_n, const uint8_t *oriented,
            int64_t L, const int32_t *olens, const int32_t *owners,
            const int64_t *win_lo, const int32_t *win_len, const int32_t *wl,
            int64_t N, sw::Scoring p, int32_t *out, cudaStream_t stream) {
    constexpr int per_block = kThreads / SEGW;
    const int64_t blocks = (N + per_block - 1) / per_block;
    sw_banded_packed_kernel<LPT, SEGW><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        text, text_n, oriented, L, olens, owners, win_lo, win_len, wl, N, p,
        out);
}

}  // namespace

extern "C" {

// Widest corridor the kernel takes: one 64-lane segment.
int sw_banded_packed_max_wl() { return kSegLanes; }

// Scores N candidates into out (int32 [N, 4]: score, qb, qe, ref_end) on
// `stream`.  1 <= wl[b] <= max_wl <= 64 and scores within a signed byte
// are checked by the caller.  group picks the thread form: 0 the launch's
// own choice by N (8 x 8 from more than kWarpCallPerSm candidates an SM,
// else 16 x 4), 8 or 16 threads a candidate whatever N is (to time one
// form against the other).  Returns the launch's cudaGetLastError(); does
// not synchronise.
int sw_banded_packed_launch(const void *text, int64_t text_n,
                            const void *oriented, int64_t L,
                            const void *olens, const void *owners,
                            const void *win_lo, const void *win_len,
                            const void *wl, int64_t N, int32_t max_wl,
                            int32_t group, int32_t match, int32_t mismatch,
                            int32_t gap_open, int32_t gap_extend,
                            int32_t clip, void *out, void *stream) {
    if (N <= 0) return 0;
    if (max_wl < 1 || max_wl > kSegLanes) return (int)cudaErrorInvalidValue;
    if (group != 0 && group != 8 && group != 16)
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
    auto *res = static_cast<int32_t *>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const bool big = group == 8
        || (group == 0 && N > kWarpCallPerSm * sw::sm_count());
    if (big)
        launch<8, 8>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    else
        launch<4, 16>(t, text_n, o, L, ol, ow, lo, ln, w, N, p, res, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
