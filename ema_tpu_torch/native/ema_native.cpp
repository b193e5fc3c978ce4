// ema_native — host-side native code of ema_tpu_torch (its own copy of
// ema_tpu/native/ema_native.cpp).
//
// The reference implementation is all native (C aligner core + C++
// preprocessor + the BWA library); this library provides the
// host-side native components:
//
//   1. sais_u8 / sais_int: SA-IS suffix-array construction (linear time),
//      used by the index construction (the reference gets its FM-index from
//      `bwa index`, loaded via bwa_idx_load — bwabridge.c:77-96).
//   2. align_batch: batched affine-gap alignment with soft-clip-penalized
//      ends and full traceback -> CIGAR/NM, used for the final
//      CIGAR-producing pass (the reference calls mem_reg2aln per kept
//      candidate — align.c:1013, bwabridge.c:301-311).  Candidate *scoring*
//      runs on TPU; only survivors take this host path.
//
// Build: g++ -O3 -shared -fPIC (see build.py).  Exposed via ctypes.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

// ---------------------------------------------------------------------------
// SA-IS suffix array construction
// ---------------------------------------------------------------------------
// Induced-sorting suffix array algorithm (Nong, Zhang & Chan 2009).
// T is over alphabet [0, K); a virtual sentinel smaller than everything is
// assumed at T[n] (not stored).  SA gets the n suffix start positions.

namespace {

// Templated on both the text type I and the index type J: int32 indexes
// halve the memory traffic for texts under 2^31 (GRCh38-scale shards).
template <typename I, typename J>
static void get_buckets(const I *T, int64_t n, int64_t K, J *bkt, bool end) {
    for (int64_t i = 0; i < K; i++) bkt[i] = 0;
    for (int64_t i = 0; i < n; i++) bkt[T[i]]++;
    J sum = 0;
    for (int64_t i = 0; i < K; i++) {
        sum += bkt[i];
        bkt[i] = end ? sum : sum - bkt[i];
    }
}

// t[i]: suffix type, true = S-type
template <typename I, typename J>
static void induce_sal(const I *T, J *SA, int64_t n, int64_t K,
                       J *bkt, const std::vector<bool> &t) {
    get_buckets(T, n, K, bkt, false);
    // sentinel suffix: preceding char T[n-1] is L-type
    if (n > 0) {
        int64_t j = n - 1;
        if (!t[j]) SA[bkt[T[j]]++] = (J)j;
    }
    for (int64_t i = 0; i < n; i++) {
        J j = SA[i] - 1;
        if (SA[i] > 0 && !t[j]) SA[bkt[T[j]]++] = j;
    }
}

template <typename I, typename J>
static void induce_sas(const I *T, J *SA, int64_t n, int64_t K,
                       J *bkt, const std::vector<bool> &t) {
    get_buckets(T, n, K, bkt, true);
    for (int64_t i = n - 1; i >= 0; i--) {
        J j = SA[i] - 1;
        if (SA[i] > 0 && t[j]) SA[--bkt[T[j]]] = j;
    }
}

template <typename I, typename J>
static void sais_core(const I *T, J *SA, int64_t n, int64_t K) {
    if (n == 0) return;
    if (n == 1) { SA[0] = 0; return; }

    std::vector<bool> t(n);
    t[n - 1] = false;  // last real char: L-type (followed by smaller sentinel)
    for (int64_t i = n - 2; i >= 0; i--)
        t[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && t[i + 1]);

    auto is_lms = [&](int64_t i) { return i > 0 && t[i] && !t[i - 1]; };

    std::vector<J> bkt(K);

    // step 1: place LMS suffixes, induce-sort
    std::fill(SA, SA + n, (J)-1);
    get_buckets(T, n, K, bkt.data(), true);
    for (int64_t i = 1; i < n; i++)
        if (is_lms(i)) SA[--bkt[T[i]]] = (J)i;
    induce_sal(T, SA, n, K, bkt.data(), t);
    induce_sas(T, SA, n, K, bkt.data(), t);

    // compact sorted LMS positions into the front of SA
    int64_t n1 = 0;
    for (int64_t i = 0; i < n; i++)
        if (is_lms(SA[i])) SA[n1++] = SA[i];

    // name LMS substrings
    std::fill(SA + n1, SA + n, (J)-1);
    int64_t name = 0, prev = -1;
    for (int64_t i = 0; i < n1; i++) {
        int64_t pos = SA[i];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (int64_t d = 0;; d++) {
                if (pos + d == n || prev + d == n) { diff = (pos + d == n) != (prev + d == n); break; }
                if (T[pos + d] != T[prev + d] || t[pos + d] != t[prev + d]) { diff = true; break; }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        SA[n1 + pos / 2] = (J)(name - 1);
    }
    J *s1 = SA + n - n1;
    for (int64_t i = n - 1, j = n - 1; i >= n1; i--)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // step 2: sort the reduced problem
    J *SA1 = SA;
    if (name < n1) {
        sais_core<J, J>(s1, SA1, n1, name);
    } else {
        for (int64_t i = 0; i < n1; i++) SA1[s1[i]] = (J)i;
    }

    // step 3: induce the final SA from sorted LMS suffixes
    std::vector<J> lms;
    lms.reserve(n1);
    for (int64_t i = 1; i < n; i++)
        if (is_lms(i)) lms.push_back((J)i);
    for (int64_t i = 0; i < n1; i++) SA1[i] = lms[SA1[i]];

    std::fill(SA + n1, SA + n, (J)-1);
    get_buckets(T, n, K, bkt.data(), true);
    for (int64_t i = n1 - 1; i >= 0; i--) {
        J j = SA[i];
        SA[i] = (J)-1;
        SA[--bkt[T[j]]] = j;
    }
    induce_sal(T, SA, n, K, bkt.data(), t);
    induce_sas(T, SA, n, K, bkt.data(), t);
}

}  // namespace

// Suffix array of uint8 text (alphabet [0,K)), result int64.
extern "C" void sais_u8(const uint8_t *T, int64_t *SA, int64_t n, int64_t K) {
    sais_core<uint8_t, int64_t>(T, SA, n, K);
}

// int32 variant: half the index-array bandwidth for n < 2^31
extern "C" void sais_u8_i32(const uint8_t *T, int32_t *SA, int64_t n, int64_t K) {
    sais_core<uint8_t, int32_t>(T, SA, n, K);
}

// ---------------------------------------------------------------------------
// Batched affine-gap alignment with clip-penalized ends + traceback
// ---------------------------------------------------------------------------
// Semantics (BWA-MEM-like; reference constants via mem_opt_init, see
// SURVEY.md §2.3): match +ma, mismatch -mb, gap open+ext -(go+ge), extend
// -ge.  The read may be soft-clipped at either end for a flat `clip`
// penalty; the reported score includes clip penalties (this reproduces
// BWA's "extend to end unless local is better by > pen_clip" rule in a
// single DP).  The reference window is free at both ends (glocal).
//
// Reads/refs are 2-bit codes, 4 = N (always scores -1).
//
// Outputs per item: score (clip-penalized), pos (window offset of first
// aligned ref base), qb/qe (aligned read span, 0-based half-open), NM,
// n_cigar + BAM-encoded cigar (len<<4|op, op: 0=M 1=I 2=D 4=S),
// where I consumes read, D consumes ref.  Soft clips are included.

namespace {

struct Cell { int32_t h, e, f; };

}  // namespace

extern "C" void align_one(const uint8_t *read, int32_t m, const uint8_t *ref, int32_t n,
               int32_t ma, int32_t mb, int32_t go, int32_t ge, int32_t clip,
               int32_t *score_out, int32_t *pos_out, int32_t *qb_out,
               int32_t *qe_out, int32_t *nm_out, uint32_t *cigar_out,
               int32_t *n_cigar_out, int32_t max_cigar, uint8_t *tb_buf) {
    const int32_t NEG = -(1 << 28);
    // tb flags per cell: bits0-1 H source (0 diag, 1 from D, 2 from I, 3 fresh
    // start), bit2 D extends D (else opens from H), bit3 I extends I.
    // Row arrays indexed by j hold the previous row's H and I (vertical gap);
    // the horizontal gap D is a within-row scalar.
    std::vector<int32_t> H(n + 1), V(n + 1);
    // row 0: alignment may start before any ref base; H[0][j] = 0
    for (int32_t j = 0; j <= n; j++) { H[j] = 0; V[j] = NEG; }

    int32_t best = NEG, best_i = 0, best_j = 0;
    for (int32_t i = 1; i <= m; i++) {
        int32_t d = NEG;          // D[i][j-1], horizontal (consumes ref)
        int32_t h_diag = H[0];    // H[i-1][j-1]
        // starting the alignment at read position i-1 clips i-1 bases
        const int32_t start_val = (i == 1) ? 0 : -clip;
        H[0] = NEG;  // i read bases cannot align to 0 ref bases (no leading I)
        int32_t h_left = NEG;     // H[i][j-1]
        uint8_t *tbrow = tb_buf + (int64_t)(i - 1) * n;
        const uint8_t rb = read[i - 1];
        for (int32_t j = 1; j <= n; j++) {
            uint8_t flags = 0;
            // D: gap in read (consumes ref), within-row recurrence
            int32_t d_open = h_left - (go + ge);
            int32_t d_ext = d - ge;
            d = d_open >= d_ext ? d_open : d_ext;
            if (d_ext > d_open) flags |= 4;
            // I: gap in ref (consumes read), from the previous row
            int32_t v_open = H[j] - (go + ge);  // H[i-1][j]
            int32_t v_ext = V[j] - ge;
            int32_t v = v_open >= v_ext ? v_open : v_ext;
            if (v_ext > v_open) flags |= 8;
            // H: diagonal (match/mismatch), possibly a fresh (clipped) start
            const uint8_t cb = ref[j - 1];
            const int32_t sub = (rb >= 4 || cb >= 4) ? -1 : (rb == cb ? ma : -mb);
            int32_t diag_from = h_diag >= start_val ? h_diag : start_val;
            if (start_val > h_diag) flags |= 3;  // fresh start marker
            int32_t h = diag_from + sub;
            if (d > h) { h = d; flags = (flags & ~3u) | 1; }
            if (v > h) { h = v; flags = (flags & ~3u) | 2; }
            // record
            h_diag = H[j];
            H[j] = h;
            V[j] = v;
            h_left = h;
            tbrow[j - 1] = flags;
            const int32_t end_bonus = (i == m) ? 0 : -clip;
            if (h + end_bonus > best) { best = h + end_bonus; best_i = i; best_j = j; }
        }
    }

    if (best <= 0) {  // no usable alignment
        *score_out = best; *pos_out = -1; *qb_out = 0; *qe_out = 0;
        *nm_out = 0; *n_cigar_out = 0;
        return;
    }

    // traceback from (best_i, best_j)
    std::vector<uint32_t> rcig;  // reversed (op, len) runs
    auto push_op = [&](uint32_t op) {
        if (!rcig.empty() && (rcig.back() & 0xf) == op) rcig.back() += 16;
        else rcig.push_back(16 | op);
    };
    int32_t i = best_i, j = best_j, nm = 0;
    int32_t state = 0;  // 0=H, 1=E, 2=F
    while (i > 0) {
        uint8_t flags = tb_buf[(int64_t)(i - 1) * n + (j - 1)];
        if (state == 0) {
            uint8_t src = flags & 3;
            if (src == 1) { state = 1; continue; }
            if (src == 2) { state = 2; continue; }
            // diagonal step (M)
            push_op(0);
            if (read[i - 1] != ref[j - 1] || read[i - 1] >= 4) nm++;
            i--; j--;
            if (src == 3) break;  // fresh start: alignment begins here
            if (i == 0) break;
            if (j == 0) break;
        } else if (state == 1) {  // E: D op, consumes ref
            push_op(2); nm++;
            state = (flags & 4) ? 1 : 0;
            j--;
            if (j == 0) break;
        } else {  // F: I op, consumes read
            push_op(1); nm++;
            state = (flags & 8) ? 2 : 0;
            i--;
            if (i == 0) break;
        }
    }

    const int32_t qb = i;           // bases 0..i-1 soft-clipped at start
    const int32_t qe = best_i;      // aligned through best_i-1
    *score_out = best;
    *pos_out = j;                   // 0-based window offset of first aligned base
    *qb_out = qb;
    *qe_out = qe;
    *nm_out = nm;

    int32_t nc = 0;
    if (qb > 0 && nc < max_cigar) cigar_out[nc++] = ((uint32_t)qb << 4) | 4;
    for (auto it = rcig.rbegin(); it != rcig.rend() && nc < max_cigar; ++it)
        cigar_out[nc++] = *it;
    if (qe < m && nc < max_cigar) cigar_out[nc++] = ((uint32_t)(m - qe) << 4) | 4;
    *n_cigar_out = nc;
}

// Batched entry point.  reads: [B, m_max], lens m_len[B]; refs: [B, n_max],
// lens n_len[B].  Outputs are [B] (cigars [B, max_cigar]).
extern "C" void align_batch(const uint8_t *reads, const int32_t *m_len, int32_t m_max,
                 const uint8_t *refs, const int32_t *n_len, int32_t n_max,
                 int32_t B,
                 int32_t ma, int32_t mb, int32_t go, int32_t ge, int32_t clip,
                 int32_t *score, int32_t *pos, int32_t *qb, int32_t *qe,
                 int32_t *nm, uint32_t *cigars, int32_t *n_cigar,
                 int32_t max_cigar) {
    std::vector<uint8_t> tb((int64_t)m_max * n_max);
    for (int32_t b = 0; b < B; b++) {
        align_one(reads + (int64_t)b * m_max, m_len[b],
                  refs + (int64_t)b * n_max, n_len[b],
                  ma, mb, go, ge, clip,
                  score + b, pos + b, qb + b, qe + b, nm + b,
                  cigars + (int64_t)b * max_cigar, n_cigar + b, max_cigar,
                  tb.data());
    }
}

// CIGAR/NM for scored candidates, windows read straight off the packed
// genome text (no [N, W] host gather): the SW kernel already pinned each
// candidate's optimal cell (qb, qe, ref_end); if the gapless alignment
// there reproduces the kernel score exactly the full DP would pick the
// same path (tie-breaking prefers the diagonal), so the CIGAR is S/M/S
// and NM is a base-compare — ~99% of candidates at indel rate 1e-4
// (reference align.h:70).  The rest run the full DP (align_one) on a
// per-thread window scratch.  Threaded over candidates.
extern "C" void traceback_batch(
    const uint8_t *oriented, int32_t m_max, const int32_t *olens,
    const int64_t *rows, int32_t B,
    const uint8_t *text, int64_t text_n,
    const int64_t *win_lo, const int32_t *win_len,
    const int32_t *sw_score, const int32_t *sw_qb, const int32_t *sw_qe,
    const int32_t *sw_ref_end,
    int32_t ma, int32_t mb, int32_t go, int32_t ge, int32_t clip,
    int32_t n_threads,
    int32_t *score, int32_t *pos, int32_t *qb, int32_t *qe,
    int32_t *nm, uint32_t *cigars, int32_t *n_cigar, int32_t max_cigar) {
    int32_t w_max = 1;
    for (int32_t b = 0; b < B; b++)
        if (win_len[b] > w_max) w_max = win_len[b];

    auto work = [&](int32_t b0, int32_t b1) {
        std::vector<uint8_t> win(w_max);
        std::vector<uint8_t> tb((int64_t)m_max * w_max);
        for (int32_t b = b0; b < b1; b++) {
            const uint8_t *read = oriented + rows[b] * m_max;
            const int32_t rlen = olens[b];
            const int32_t qb_b = sw_qb[b], qe_b = sw_qe[b];
            const int32_t span = qe_b - qb_b;
            const int32_t start = sw_ref_end[b] - span;
            uint32_t *cig = cigars + (int64_t)b * max_cigar;
            if (span > 0 && start >= 0 && sw_ref_end[b] <= win_len[b]) {
                int32_t n_mis = 0, n_n = 0;
                const int64_t col0 = win_lo[b] + start;
                for (int32_t t = 0; t < span; t++) {
                    const uint8_t rb = read[qb_b + t];
                    const int64_t col = col0 + t;
                    const uint8_t cb =
                        (col >= 0 && col < text_n) ? text[col] : 5;
                    if (rb >= 4) n_n++;
                    else if (rb != cb) n_mis++;
                }
                const int32_t n_mat = span - n_mis - n_n;
                const int64_t hyp = (int64_t)ma * n_mat
                    - (int64_t)mb * n_mis - n_n
                    - (int64_t)clip * ((qb_b > 0) + (qe_b < rlen));
                if (hyp == sw_score[b]) {
                    score[b] = sw_score[b];
                    pos[b] = start;
                    qb[b] = qb_b;
                    qe[b] = qe_b;
                    nm[b] = n_mis + n_n;
                    int32_t k = 0;
                    if (qb_b > 0)
                        cig[k++] = ((uint32_t)qb_b << 4) | 4;
                    cig[k++] = ((uint32_t)span << 4) | 0;
                    if (qe_b < rlen)
                        cig[k++] = ((uint32_t)(rlen - qe_b) << 4) | 4;
                    n_cigar[b] = k;
                    continue;
                }
            }
            const int32_t w = win_len[b];
            const int64_t wl = win_lo[b];
            for (int32_t t = 0; t < w; t++) {
                const int64_t col = wl + t;
                win[t] = (col >= 0 && col < text_n) ? text[col] : 5;
            }
            align_one(read, rlen, win.data(), w, ma, mb, go, ge, clip,
                      score + b, pos + b, qb + b, qe + b, nm + b,
                      cig, n_cigar + b, max_cigar, tb.data());
        }
    };

    if (n_threads <= 0)
        n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads > B) n_threads = B > 0 ? B : 1;
    if (n_threads > 1) {
        std::vector<std::thread> pool;
        const int32_t chunk = (B + n_threads - 1) / n_threads;
        for (int32_t t = 0; t < n_threads; t++) {
            const int32_t b0 = t * chunk;
            const int32_t b1 = b0 + chunk < B ? b0 + chunk : B;
            if (b0 >= b1) break;
            pool.emplace_back(work, b0, b1);
        }
        for (auto &th : pool) th.join();
    } else {
        work(0, B);
    }
}

// ---------------------------------------------------------------------------
// Batched SAM line formatting
// ---------------------------------------------------------------------------
// The reference emits SAM records in C (print_sam_record,
// samrecord.c:104-284).  Here the Python pipeline computes the per-record
// numeric fields (flags, mapq, TLEN) vectorized and this routine does the
// string assembly: CIGAR rendering from the BAM-encoded pool, seq/qual
// reverse-complement for reverse-strand records, and tag concatenation.
//
// Layout: per-record variable-length strings (names, seq, qual) arrive as
// one concatenated blob plus int64 offset arrays (offs[i]..offs[i+1]).
// rnext_idx: contig index, -1 => '=', -2 => '*'.  nm < 0 suppresses the
// linked-read tags (unmapped or --nobc records still get BX when bx_len>0
// and lr=2).  alt_cig_len < 0 => no XA.

namespace {

static inline char *put_i64(char *p, int64_t v) {
    if (v < 0) { *p++ = '-'; v = -v; }
    char tmp[24]; int k = 0;
    do { tmp[k++] = '0' + (v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

static const char CIG_OPS[] = "MIDSS";  // op 3 (H) printed as S
static const char COMP[] = "TGCA";      // ACGT -> TGCA

static inline char *put_cigar(char *p, const uint32_t *cig, int32_t n) {
    for (int32_t i = 0; i < n; i++) {
        p = put_i64(p, cig[i] >> 4);
        uint32_t op = cig[i] & 0xF;
        *p++ = (op < 5) ? CIG_OPS[op] : '?';
    }
    return p;
}

static inline char comp_base(char c) {
    switch (c) {
        case 'A': return 'T'; case 'C': return 'G';
        case 'G': return 'C'; case 'T': return 'A';
        case 'a': return 't'; case 'c': return 'g';
        case 'g': return 'c'; case 't': return 'a';
        default: return c;   // IUPAC/other bytes pass through, matching
                             // the Python revcomp translate table
    }
}

}  // namespace

extern "C" int64_t format_sam_batch(
    int64_t M,
    // string blobs + offsets [M+1]
    const char *names, const int64_t *name_off,
    const char *seqs, const int64_t *seq_off,
    const char *quals, const int64_t *qual_off,
    // contig name table
    const char *chroms, const int64_t *chrom_off, int32_t n_chroms,
    // numeric per-record fields
    const int32_t *flag, const int32_t *chrom_idx, const int64_t *pos,
    const int32_t *mapq, const int32_t *rnext_idx, const int64_t *pnext,
    const int64_t *tlen, const int32_t *rev,
    const int64_t *cig_off, const int32_t *cig_len, const uint32_t *cig_pool,
    const int32_t *nm, const double *gamma, const int64_t *mi,
    const int32_t *xf,
    // XA alt (alt_cig_len < 0 => none)
    const int32_t *alt_chrom, const int64_t *alt_pos, const int32_t *alt_rev,
    const int64_t *alt_cig_off, const int32_t *alt_cig_len,
    const int32_t *alt_nm,
    // per-record tag mode lr (0 none, 1 full, 2 bx-only, 3 NM-only) and
    // per-record BX string (blob + offsets: groups batch into one call)
    const int32_t *lr,
    const char *bx_blob, const int64_t *bx_off,
    const char *rg, int32_t rg_len,
    char *out, int64_t out_cap) {
    char *p = out;
    char *lim = out + out_cap - 64;
    for (int64_t i = 0; i < M; i++) {
        int64_t chrom_need = 0;                 // RNAME + RNEXT + XA chrom
        if (chrom_idx[i] >= 0)
            chrom_need += chrom_off[chrom_idx[i] + 1] - chrom_off[chrom_idx[i]];
        if (rnext_idx[i] >= 0)
            chrom_need += chrom_off[rnext_idx[i] + 1] - chrom_off[rnext_idx[i]];
        if (alt_cig_len[i] >= 0)
            chrom_need += chrom_off[alt_chrom[i] + 1] - chrom_off[alt_chrom[i]];
        int64_t need = (name_off[i + 1] - name_off[i])
            + (seq_off[i + 1] - seq_off[i]) + (qual_off[i + 1] - qual_off[i])
            + 16 * (cig_len[i] > 0 ? cig_len[i] : 1)
            + (alt_cig_len[i] > 0 ? 16 * alt_cig_len[i] + 64 : 0)
            + chrom_need + (bx_off[i + 1] - bx_off[i]) + rg_len + 256;
        if (p + need > lim) return -1;          // caller grows the buffer

        // QNAME FLAG RNAME POS MAPQ
        int64_t nl = name_off[i + 1] - name_off[i];
        memcpy(p, names + name_off[i], nl); p += nl;
        *p++ = '\t'; p = put_i64(p, flag[i]);
        *p++ = '\t';
        if (chrom_idx[i] < 0) { *p++ = '*'; }
        else {
            int64_t cl = chrom_off[chrom_idx[i] + 1] - chrom_off[chrom_idx[i]];
            memcpy(p, chroms + chrom_off[chrom_idx[i]], cl); p += cl;
        }
        *p++ = '\t'; p = put_i64(p, pos[i]);
        *p++ = '\t'; p = put_i64(p, mapq[i]);

        // CIGAR
        *p++ = '\t';
        if (cig_len[i] <= 0) *p++ = '*';
        else p = put_cigar(p, cig_pool + cig_off[i], cig_len[i]);

        // RNEXT PNEXT TLEN
        *p++ = '\t';
        if (rnext_idx[i] == -1) *p++ = '=';
        else if (rnext_idx[i] < 0) *p++ = '*';
        else {
            int64_t cl = chrom_off[rnext_idx[i] + 1] - chrom_off[rnext_idx[i]];
            memcpy(p, chroms + chrom_off[rnext_idx[i]], cl); p += cl;
        }
        *p++ = '\t'; p = put_i64(p, pnext[i]);
        *p++ = '\t'; p = put_i64(p, tlen[i]);

        // SEQ QUAL (revcomp / reverse for reverse-strand records); each
        // uses its OWN span — a malformed record with len(qual) !=
        // len(seq) must not read past its blob slice
        int64_t sl = seq_off[i + 1] - seq_off[i];
        int64_t ql = qual_off[i + 1] - qual_off[i];
        const char *sq = seqs + seq_off[i];
        const char *qu = quals + qual_off[i];
        *p++ = '\t';
        if (rev[i]) for (int64_t j = sl - 1; j >= 0; j--) *p++ = comp_base(sq[j]);
        else { memcpy(p, sq, sl); p += sl; }
        *p++ = '\t';
        if (rev[i]) for (int64_t j = ql - 1; j >= 0; j--) *p++ = qu[j];
        else { memcpy(p, qu, ql); p += ql; }

        // tags
        const char *bx = bx_blob + bx_off[i];
        const int64_t bx_len = bx_off[i + 1] - bx_off[i];
        if (lr[i] == 1) {
            memcpy(p, "\tNM:i:", 6); p += 6; p = put_i64(p, nm[i]);
            memcpy(p, "\tBX:Z:", 6); p += 6;
            memcpy(p, bx, bx_len); p += bx_len;
            memcpy(p, "\tXG:f:", 6); p += 6;
            p += snprintf(p, 32, "%.5g", gamma[i]);
            memcpy(p, "\tMI:i:", 6); p += 6; p = put_i64(p, mi[i]);
            memcpy(p, "\tXF:i:", 6); p += 6; p = put_i64(p, xf[i]);
        } else if (lr[i] == 2) {
            memcpy(p, "\tBX:Z:", 6); p += 6;
            memcpy(p, bx, bx_len); p += bx_len;
        } else if (lr[i] == 3) {   // --nobc: NM only
            memcpy(p, "\tNM:i:", 6); p += 6; p = put_i64(p, nm[i]);
        }
        if (rg_len > 0) {
            memcpy(p, "\tRG:Z:", 6); p += 6;
            memcpy(p, rg, rg_len); p += rg_len;
        }
        if (alt_cig_len[i] >= 0) {
            memcpy(p, "\tXA:Z:", 6); p += 6;
            int64_t cl = chrom_off[alt_chrom[i] + 1] - chrom_off[alt_chrom[i]];
            memcpy(p, chroms + chrom_off[alt_chrom[i]], cl); p += cl;
            *p++ = ',';
            *p++ = alt_rev[i] ? '-' : '+';
            p = put_i64(p, alt_pos[i]);
            *p++ = ',';
            p = put_cigar(p, cig_pool + alt_cig_off[i], alt_cig_len[i]);
            *p++ = ',';
            p = put_i64(p, alt_nm[i]);
            *p++ = ';';
        }
        *p++ = '\n';
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// Density-based multimapping resolver: the simulated-annealing inner loop of
// the reference's -d mode (reference src/split.c:223-325), over *local*
// clean-record arrays prepared by ema_tpu.core.split.  The reference seeds
// rand() with time() (split.c:54-59); here the caller passes an explicit
// seed (splitmix64 stream) so -d runs are reproducible.
// ---------------------------------------------------------------------------

namespace {

struct Splitmix64 {
    uint64_t s;
    uint64_t next() {
        uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
        return z ^ (z >> 31);
    }
    // uniform in [0, n)
    int64_t below(int64_t n) { return (int64_t)(next() % (uint64_t)n); }
    // uniform double in [0, 1)
    double real() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

struct SAProblem {
    const int64_t *pos; const int32_t *chrom; const int8_t *rev;
    const double *score;
    int64_t insert_min, insert_max;

    bool is_pair(int64_t k1, int64_t k2) const {
        // FR proper-pair predicate (reference align.c:27-40)
        if ((rev[k1] != 0) == (rev[k2] != 0) || chrom[k1] != chrom[k2])
            return false;
        int64_t d = rev[k2] ? pos[k2] - pos[k1] : pos[k1] - pos[k2];
        return insert_min <= d && d <= insert_max;
    }
};

static inline double log_density_prob(int64_t density, const double *lp,
                                      int64_t n_lp) {
    if (density < 0) return -1e18;   // reference: unsigned wraparound
    if (density < n_lp) return lp[density];
    return lp[n_lp - 1] - (double)(density - n_lp + 1) * 0.6931471805599453;
}

}  // namespace

extern "C" void sa_optimize(
    const int64_t *pos, const int32_t *chrom, const int8_t *rev,
    const double *score,
    const int64_t *umap_local, int64_t n_umaps,
    const int64_t *mm_start, const int64_t *mm_n,
    const int64_t *mm_mate_umap, const int64_t *mm_mate_mmap,
    int64_t *mm_active, int64_t n_mmaps,
    int64_t *bins, int64_t lo, int64_t bin_size,
    const double *log_probs, int64_t n_log_probs,
    int64_t iters, double tmax_log, double tmin_log,
    int64_t max_no_move, double score_scale,
    int64_t insert_min, int64_t insert_max, uint64_t seed) {
    SAProblem P{pos, chrom, rev, score, insert_min, insert_max};
    Splitmix64 rng{seed ? seed : 1};
    const double tspan = tmax_log - tmin_log;
    int64_t no_move = 0;

    for (int64_t it = 0; it < iters; it++) {
        double t = pow(10.0, tmax_log - tspan * (double)it / (double)iters);
        int64_t r = rng.below(n_mmaps);
        int64_t r_old = mm_active[r];
        int64_t r_new = rng.below(mm_n[r] - 1);
        if (r_new >= r_old) r_new++;

        int64_t active_mate = -1, mate_r = 0;
        bool mate_is_mmap = false;
        if (mm_mate_umap[r] >= 0) {
            mate_r = mm_mate_umap[r];
            active_mate = umap_local[mate_r];
        } else if (mm_mate_mmap[r] >= 0) {
            mate_r = mm_mate_mmap[r];
            active_mate = mm_start[mate_r] + mm_active[mate_r];
            mate_is_mmap = true;
        }

        int64_t rec_old = mm_start[r] + r_old;
        int64_t rec_new = mm_start[r] + r_new;

        double dens_change = 0.0, score_change = 0.0;
        bool force = false;
        int64_t mate_new_active = -1;
        int64_t mate_old_bin = 0, mate_new_bin = 0;
        bool old_paired = active_mate >= 0 && P.is_pair(rec_old, active_mate);
        bool new_paired = active_mate >= 0 && P.is_pair(rec_new, active_mate);

        if (!old_paired && new_paired) {
            force = true;   // moves creating a pair are always taken
        } else if (old_paired && !new_paired && mate_is_mmap) {
            // drag a multimapped mate along to keep the pair
            for (int64_t mi = 0; mi < mm_n[mate_r]; mi++) {
                int64_t cand = mm_start[mate_r] + mi;
                if (P.is_pair(rec_new, cand)) {
                    mate_new_active = mi;
                    mate_old_bin = (pos[active_mate] - lo) / bin_size;
                    mate_new_bin = (pos[cand] - lo) / bin_size;
                    score_change += (score[cand] - score[active_mate])
                                    / score_scale;
                    break;
                }
            }
        }

        int64_t old_bin = (pos[rec_old] - lo) / bin_size;
        int64_t new_bin = (pos[rec_new] - lo) / bin_size;
        int64_t p1 = (mate_new_active >= 0 && old_bin == mate_old_bin) ? 2 : 1;
        int64_t p2 = (mate_new_active >= 0 && new_bin == mate_new_bin) ? 2 : 1;
        dens_change +=
            log_density_prob(bins[old_bin] - p1, log_probs, n_log_probs)
            - log_density_prob(bins[old_bin], log_probs, n_log_probs)
            + log_density_prob(bins[new_bin] + p2, log_probs, n_log_probs)
            - log_density_prob(bins[new_bin], log_probs, n_log_probs);
        if (p1 == 1 && mate_new_active >= 0)
            dens_change +=
                log_density_prob(bins[mate_old_bin] - 1, log_probs, n_log_probs)
                - log_density_prob(bins[mate_old_bin], log_probs, n_log_probs);
        if (p2 == 1 && mate_new_active >= 0)
            dens_change +=
                log_density_prob(bins[mate_new_bin] + 1, log_probs, n_log_probs)
                - log_density_prob(bins[mate_new_bin], log_probs, n_log_probs);

        score_change += (score[rec_new] - score[rec_old]) / score_scale;
        double change = dens_change + score_change;

        double arg = change / t;
        if (arg > 50.0) arg = 50.0;
        if (force || change > 0 || exp(arg) >= rng.real()) {
            mm_active[r] = r_new;
            bins[old_bin] -= 1;
            bins[new_bin] += 1;
            if (mate_new_active >= 0) {
                mm_active[mate_r] = mate_new_active;
                bins[mate_old_bin] -= 1;
                bins[mate_new_bin] += 1;
            }
        } else {
            no_move++;
        }
        if (no_move >= max_no_move) break;
    }
}

// Multi-chain variant (ours; no reference analog): run n_chains seeded
// annealing chains from the same initial state — in parallel threads —
// and keep the assignment with the best final SA energy
// (sum_bins log_density_prob + sum_mm score/scale; unique-mapped score
// terms are constant across chains and omitted).  The reference runs a
// single time-seeded chain (split.c:54-59, 223-325).
extern "C" void sa_optimize_best(
    const int64_t *pos, const int32_t *chrom, const int8_t *rev,
    const double *score,
    const int64_t *umap_local, int64_t n_umaps,
    const int64_t *mm_start, const int64_t *mm_n,
    const int64_t *mm_mate_umap, const int64_t *mm_mate_mmap,
    int64_t *mm_active, int64_t n_mmaps,
    int64_t *bins, int64_t n_bins, int64_t lo, int64_t bin_size,
    const double *log_probs, int64_t n_log_probs,
    int64_t iters, double tmax_log, double tmin_log,
    int64_t max_no_move, double score_scale,
    int64_t insert_min, int64_t insert_max,
    const uint64_t *seeds, int64_t n_chains, int64_t n_threads) {
    if (n_chains <= 1) {
        sa_optimize(pos, chrom, rev, score, umap_local, n_umaps,
                    mm_start, mm_n, mm_mate_umap, mm_mate_mmap,
                    mm_active, n_mmaps, bins, lo, bin_size,
                    log_probs, n_log_probs, iters, tmax_log, tmin_log,
                    max_no_move, score_scale, insert_min, insert_max,
                    seeds[0]);
        return;
    }
    std::vector<std::vector<int64_t>> c_bins(n_chains),
        c_active(n_chains);
    std::vector<double> c_energy(n_chains);
    auto run_chain = [&](int64_t c) {
        c_bins[c].assign(bins, bins + n_bins);
        c_active[c].assign(mm_active, mm_active + n_mmaps);
        sa_optimize(pos, chrom, rev, score, umap_local, n_umaps,
                    mm_start, mm_n, mm_mate_umap, mm_mate_mmap,
                    c_active[c].data(), n_mmaps, c_bins[c].data(), lo,
                    bin_size, log_probs, n_log_probs, iters, tmax_log,
                    tmin_log, max_no_move, score_scale, insert_min,
                    insert_max, seeds[c]);
        double e = 0.0;
        // every bin contributes, INCLUDING empty ones: the annealed
        // objective's transition deltas include log_density_prob(0)
        // (~log 0.6), so chains ending with different empty-bin counts
        // would otherwise be mis-ranked
        for (int64_t b = 0; b < n_bins; b++)
            e += log_density_prob(c_bins[c][b], log_probs, n_log_probs);
        for (int64_t r = 0; r < n_mmaps; r++)
            e += score[mm_start[r] + c_active[c][r]] / score_scale;
        c_energy[c] = e;
    };
    if (n_threads <= 0)
        n_threads = (int64_t)std::thread::hardware_concurrency();
    if (n_threads > n_chains) n_threads = n_chains;
    if (n_threads > 1) {
        std::vector<std::thread> pool;
        std::atomic<int64_t> next{0};
        for (int64_t t = 0; t < n_threads; t++)
            pool.emplace_back([&]() {
                for (int64_t c; (c = next.fetch_add(1)) < n_chains;)
                    run_chain(c);
            });
        for (auto &th : pool) th.join();
    } else {
        for (int64_t c = 0; c < n_chains; c++) run_chain(c);
    }
    int64_t best = 0;
    for (int64_t c = 1; c < n_chains; c++)
        if (c_energy[c] > c_energy[best]) best = c;
    std::copy(c_bins[best].begin(), c_bins[best].end(), bins);
    std::copy(c_active[best].begin(), c_active[best].end(), mm_active);
}

// ---------------------------------------------------------------------------
// SMEM seeding: supermaximal exact matches over the both-strands FM index,
// with BWA-MEM's re-seeding of long unique MEMs and the LAST-like third
// round.  This is the host-side equivalent of the seeding the reference
// gets from mem_align1_core (reference src/bwabridge.c:173, 236-237) — the
// algorithm is the published bi-directional backward search (Li 2012,
// "Exploring single-sample SNP and INDEL calling with whole-genome de novo
// assembly", alg. bwt_smem1), implemented here against our occ-block
// layout (index/build.py): one int32 row of [4 counts + 8 packed 2-bit
// words] per 128 BWT chars, $ row removed with `primary` kept.
// ---------------------------------------------------------------------------

#include <thread>

#if defined(__AVX512VL__) && defined(__AVX512VPOPCNTDQ__)
// The occ-block scan ranks 4 chars per packed word: one __m256i lane per
// char turns the 4 scalar eq-mask/popcount chains into one vector chain
// (vpopcntq needs AVX512VPOPCNTDQ+VL; -march=native enables it where the
// host has it, the scalar bodies below remain the portable fallback).
#include <immintrin.h>
#define EMA_OCC_AVX512 1
#endif

namespace smem {

struct FM {
    const int32_t *blocks;   // [n_blocks, 12]
    const int64_t *C;        // counts[5]; C[0] = 1 ($ row)
    int64_t primary;         // full-row index of the $ BWT char
    int64_t n;               // FM text length (row space = n + 1)

    // packed 2-bit words are walked as 64-bit lanes (32 bases/popcount;
    // little-endian makes two consecutive u32 words one sequential u64)
    static inline void add_word64(uint64_t word, int nbase,
                                  int64_t cnt[4]) {
        uint64_t m = nbase >= 32 ? ~0ULL : ((1ULL << (2 * nbase)) - 1ULL);
        for (int c = 0; c < 4; c++) {
            uint64_t x = word ^ (0x5555555555555555ULL * (uint64_t)c);
            uint64_t eq = (~(x | (x >> 1))) & 0x5555555555555555ULL & m;
            cnt[c] += __builtin_popcountll(eq);
        }
    }

    // occurrences of each base among the first k rows of the full row space
    inline void occ4(int64_t k, int64_t cnt[4]) const {
#ifdef EMA_OCC_AVX512
        occ4_from(0, k, cnt);
#else
        int64_t adj = k - (k > primary ? 1 : 0);
        int64_t blk = adj >> 7;
        int off = (int)(adj & 127);
        const int32_t *row = blocks + blk * 12;
        cnt[0] = row[0]; cnt[1] = row[1]; cnt[2] = row[2]; cnt[3] = row[3];
        const uint64_t *w = (const uint64_t *)(row + 4);
        int fw = off >> 5, rem = off & 31;
        for (int i = 0; i < fw; i++) add_word64(w[i], 32, cnt);
        if (rem) add_word64(w[fw], rem, cnt);
#endif
    }

    // single-char rank (occ(c, k)) — ~4x cheaper than occ4 when only one
    // base matters (greedy backward extension, LF locate walk)
    inline int64_t occ1(int c, int64_t k) const {
        int64_t adj = k - (k > primary ? 1 : 0);
        int64_t blk = adj >> 7;
        int off = (int)(adj & 127);
        const int32_t *row = blocks + blk * 12;
        int64_t cnt = row[c];
        const uint64_t *w = (const uint64_t *)(row + 4);
        int fw = off >> 5, rem = off & 31;
        uint64_t pat = 0x5555555555555555ULL * (uint64_t)c;
        for (int i = 0; i < fw; i++) {
            uint64_t x = w[i] ^ pat;
            cnt += __builtin_popcountll((~(x | (x >> 1)))
                                        & 0x5555555555555555ULL);
        }
        if (rem) {
            uint64_t x = w[fw] ^ pat;
            cnt += __builtin_popcountll((~(x | (x >> 1)))
                                        & 0x5555555555555555ULL
                                        & ((1ULL << (2 * rem)) - 1ULL));
        }
        return cnt;
    }

    // rank of one char at TWO positions (klo <= khi).  When both land in
    // the same 128-base block — the common case once a seed's interval
    // narrows — the packed words are walked once instead of twice.
    inline void occ2(int c, int64_t klo, int64_t khi,
                     int64_t *rlo, int64_t *rhi) const {
        int64_t alo = klo - (klo > primary ? 1 : 0);
        int64_t ahi = khi - (khi > primary ? 1 : 0);
        if ((alo >> 7) != (ahi >> 7)) {
            *rlo = occ1(c, klo);
            *rhi = occ1(c, khi);
            return;
        }
        const int32_t *row = blocks + (alo >> 7) * 12;
        const uint64_t *w = (const uint64_t *)(row + 4);
        uint64_t pat = 0x5555555555555555ULL * (uint64_t)c;
        int ol = (int)(alo & 127), oh = (int)(ahi & 127);
        int64_t cl = row[c], ch = row[c];
        int fwh = oh >> 5, remh = oh & 31;
        for (int i = 0; i < fwh; i++) {
            uint64_t x = w[i] ^ pat;
            uint64_t eq = (~(x | (x >> 1))) & 0x5555555555555555ULL;
            int pc = __builtin_popcountll(eq);
            ch += pc;
            int lo_nb = ol - 32 * i;     // bases of this word below klo
            if (lo_nb >= 32) cl += pc;
            else if (lo_nb > 0)
                cl += __builtin_popcountll(
                    eq & ((1ULL << (2 * lo_nb)) - 1ULL));
        }
        if (remh) {
            uint64_t x = w[fwh] ^ pat;
            uint64_t eq = (~(x | (x >> 1))) & 0x5555555555555555ULL;
            ch += __builtin_popcountll(eq & ((1ULL << (2 * remh)) - 1ULL));
            int lo_nb = ol - 32 * fwh;   // < remh since ol <= oh
            if (lo_nb > 0)
                cl += __builtin_popcountll(
                    eq & ((1ULL << (2 * lo_nb)) - 1ULL));
        }
        *rlo = cl;
        *rhi = ch;
    }

    // occ of chars cmin..3 among the first k rows (one block walk,
    // restricted char set): extend_*_1 below only consumes ok[c] and the
    // l prefix-sum over chars > c, so chars < cmin are never needed
    inline void occ4_from(int cmin, int64_t k, int64_t cnt[4]) const {
        int64_t adj = k - (k > primary ? 1 : 0);
        const int32_t *row = blocks + (adj >> 7) * 12;
        int off = (int)(adj & 127);
        const uint64_t *w = (const uint64_t *)(row + 4);
        int fw = off >> 5, rem = off & 31;
#ifdef EMA_OCC_AVX512
        (void)cmin;  // all 4 chars cost one vector chain; extras are free
        const __m256i pats = _mm256_setr_epi64x(
            0LL, 0x5555555555555555LL,
            (long long)0xAAAAAAAAAAAAAAAAULL,
            (long long)0xFFFFFFFFFFFFFFFFULL);
        const __m256i fives = _mm256_set1_epi64x(0x5555555555555555LL);
        __m256i acc =
            _mm256_cvtepi32_epi64(_mm_loadu_si128((const __m128i *)row));
        for (int i = 0; i < fw; i++) {
            __m256i x = _mm256_xor_si256(
                _mm256_set1_epi64x((long long)w[i]), pats);
            __m256i eq = _mm256_andnot_si256(
                _mm256_or_si256(x, _mm256_srli_epi64(x, 1)), fives);
            acc = _mm256_add_epi64(acc, _mm256_popcnt_epi64(eq));
        }
        if (rem) {
            __m256i x = _mm256_xor_si256(
                _mm256_set1_epi64x((long long)w[fw]), pats);
            __m256i eq = _mm256_andnot_si256(
                _mm256_or_si256(x, _mm256_srli_epi64(x, 1)), fives);
            eq = _mm256_and_si256(eq, _mm256_set1_epi64x(
                (long long)((1ULL << (2 * rem)) - 1ULL)));
            acc = _mm256_add_epi64(acc, _mm256_popcnt_epi64(eq));
        }
        _mm256_storeu_si256((__m256i *)cnt, acc);
        return;
#endif
        for (int c = cmin; c < 4; c++) cnt[c] = row[c];
        for (int i = 0; i < fw; i++) {
            uint64_t word = w[i];
            for (int c = cmin; c < 4; c++) {
                uint64_t x = word ^ (0x5555555555555555ULL * (uint64_t)c);
                cnt[c] += __builtin_popcountll(
                    (~(x | (x >> 1))) & 0x5555555555555555ULL);
            }
        }
        if (rem) {
            uint64_t word = w[fw];
            uint64_t m = (1ULL << (2 * rem)) - 1ULL;
            for (int c = cmin; c < 4; c++) {
                uint64_t x = word ^ (0x5555555555555555ULL * (uint64_t)c);
                cnt[c] += __builtin_popcountll(
                    (~(x | (x >> 1))) & 0x5555555555555555ULL & m);
            }
        }
    }

    // occ of chars cmin..3 at TWO positions (klo <= khi) — the bi-interval
    // extension always ranks at (k, k+s); once the interval narrows under
    // a block (the common case after ~14 extensions) both land in the
    // same 128-base block and the packed words are walked ONCE
    inline void occ4_pair_from(int cmin, int64_t klo, int64_t khi,
                               int64_t tk[4], int64_t tl[4]) const {
        int64_t alo = klo - (klo > primary ? 1 : 0);
        int64_t ahi = khi - (khi > primary ? 1 : 0);
        if ((alo >> 7) != (ahi >> 7)) {
            occ4_from(cmin, klo, tk);
            occ4_from(cmin, khi, tl);
            return;
        }
        const int32_t *row = blocks + (alo >> 7) * 12;
        const uint64_t *w = (const uint64_t *)(row + 4);
        int ol = (int)(alo & 127), oh = (int)(ahi & 127);
        int fwh = oh >> 5, remh = oh & 31;
#ifdef EMA_OCC_AVX512
        (void)cmin;
        const __m256i pats = _mm256_setr_epi64x(
            0LL, 0x5555555555555555LL,
            (long long)0xAAAAAAAAAAAAAAAAULL,
            (long long)0xFFFFFFFFFFFFFFFFULL);
        const __m256i fives = _mm256_set1_epi64x(0x5555555555555555LL);
        const __m256i base =
            _mm256_cvtepi32_epi64(_mm_loadu_si128((const __m128i *)row));
        __m256i acck = base, accl = base;
        for (int i = 0; i < fwh; i++) {
            __m256i x = _mm256_xor_si256(
                _mm256_set1_epi64x((long long)w[i]), pats);
            __m256i eq = _mm256_andnot_si256(
                _mm256_or_si256(x, _mm256_srli_epi64(x, 1)), fives);
            __m256i pc = _mm256_popcnt_epi64(eq);
            accl = _mm256_add_epi64(accl, pc);
            int lo_nb = ol - 32 * i;   // bases of this word below klo
            if (lo_nb >= 32) {
                acck = _mm256_add_epi64(acck, pc);
            } else if (lo_nb > 0) {
                __m256i eqlo = _mm256_and_si256(eq, _mm256_set1_epi64x(
                    (long long)((1ULL << (2 * lo_nb)) - 1ULL)));
                acck = _mm256_add_epi64(acck, _mm256_popcnt_epi64(eqlo));
            }
        }
        if (remh) {
            __m256i x = _mm256_xor_si256(
                _mm256_set1_epi64x((long long)w[fwh]), pats);
            __m256i eq = _mm256_andnot_si256(
                _mm256_or_si256(x, _mm256_srli_epi64(x, 1)), fives);
            __m256i eqhi = _mm256_and_si256(eq, _mm256_set1_epi64x(
                (long long)((1ULL << (2 * remh)) - 1ULL)));
            accl = _mm256_add_epi64(accl, _mm256_popcnt_epi64(eqhi));
            int lo_nb = ol - 32 * fwh;  // <= remh < 32 since ol <= oh
            if (lo_nb > 0) {
                __m256i eqlo = _mm256_and_si256(eq, _mm256_set1_epi64x(
                    (long long)((1ULL << (2 * lo_nb)) - 1ULL)));
                acck = _mm256_add_epi64(acck, _mm256_popcnt_epi64(eqlo));
            }
        }
        _mm256_storeu_si256((__m256i *)tk, acck);
        _mm256_storeu_si256((__m256i *)tl, accl);
        return;
#endif
        for (int c = cmin; c < 4; c++) { tk[c] = row[c]; tl[c] = row[c]; }
        for (int i = 0; i < fwh; i++) {
            uint64_t word = w[i];
            int lo_nb = ol - 32 * i;       // bases of this word below klo
            uint64_t lom = lo_nb >= 32 ? ~0ULL
                         : (lo_nb <= 0 ? 0ULL
                                       : ((1ULL << (2 * lo_nb)) - 1ULL));
            for (int c = cmin; c < 4; c++) {
                uint64_t x = word ^ (0x5555555555555555ULL * (uint64_t)c);
                uint64_t eq = (~(x | (x >> 1))) & 0x5555555555555555ULL;
                tl[c] += __builtin_popcountll(eq);
                if (lom) tk[c] += __builtin_popcountll(eq & lom);
            }
        }
        if (remh) {
            uint64_t word = w[fwh];
            uint64_t him = (1ULL << (2 * remh)) - 1ULL;
            int lo_nb = ol - 32 * fwh;     // <= remh < 32 since ol <= oh
            uint64_t lom = lo_nb <= 0 ? 0ULL
                                      : ((1ULL << (2 * lo_nb)) - 1ULL);
            for (int c = cmin; c < 4; c++) {
                uint64_t x = word ^ (0x5555555555555555ULL * (uint64_t)c);
                uint64_t eq = (~(x | (x >> 1))) & 0x5555555555555555ULL;
                tl[c] += __builtin_popcountll(eq & him);
                if (lom) tk[c] += __builtin_popcountll(eq & lom);
            }
        }
    }

    // 2-bit BWT char at full-row index k (k != primary)
    inline int bwt_char(int64_t k) const {
        int64_t adj = k - (k > primary ? 1 : 0);
        const uint32_t *w = (const uint32_t *)(blocks + (adj >> 7) * 12 + 4);
        int off = (int)(adj & 127);
        return (int)((w[off >> 4] >> (2 * (off & 15))) & 3u);
    }
};

// bi-interval: k = SA-row start of the pattern P, l = row start of
// revcomp(P), s = size.  start/end carry the read span.
struct BiIntv {
    int64_t k, l, s;
    int32_t start, end;
};

// backward extension (prepend): fills ok[c] for every base c
static inline void extend_back(const FM &fm, const BiIntv &ik, BiIntv ok[4]) {
    int64_t tk[4], tl[4];
    fm.occ4(ik.k, tk);
    fm.occ4(ik.k + ik.s, tl);
    int64_t sdol =
        (ik.k <= fm.primary && fm.primary < ik.k + ik.s) ? 1 : 0;
    for (int c = 0; c < 4; c++) {
        ok[c].k = fm.C[c] + tk[c];
        ok[c].s = tl[c] - tk[c];
        ok[c].start = ik.start;
        ok[c].end = ik.end;
    }
    // rc-side starts: the l-interval of W partitions by the char FOLLOWING
    // W in the text ($ < T' < G' < C' < A' in complement order) — the
    // formula from BWA's bwt_extend
    ok[3].l = ik.l + sdol;
    ok[2].l = ok[3].l + ok[3].s;
    ok[1].l = ok[2].l + ok[2].s;
    ok[0].l = ok[1].l + ok[1].s;
}

// forward extension (append char c) = backward extension of the swapped
// interval with the complement
static inline void extend_fwd(const FM &fm, const BiIntv &ik, BiIntv ok[4]) {
    BiIntv tmp{ik.l, ik.k, ik.s, ik.start, ik.end};
    BiIntv o2[4];
    extend_back(fm, tmp, o2);
    for (int c = 0; c < 4; c++) {
        ok[c].k = o2[3 - c].l;
        ok[c].l = o2[3 - c].k;
        ok[c].s = o2[3 - c].s;
        ok[c].start = ik.start;
        ok[c].end = ik.end;
    }
}

// single-char backward extension: identical values to extend_back()[c]
// (the reference semantics, BWA bwt_extend) but ranks only chars >= c —
// ok[c].l needs just the complement-order prefix sum over chars > c —
// and walks (k, k+s) in one pass when they share an occ block.  The
// SMEM loops below only ever consume ok[q[i]], so this is the hot path.
static inline void extend_back_1(const FM &fm, const BiIntv &ik, int c,
                                 BiIntv *out) {
    int64_t tk[4], tl[4];
    fm.occ4_pair_from(c, ik.k, ik.k + ik.s, tk, tl);
    int64_t sdol =
        (ik.k <= fm.primary && fm.primary < ik.k + ik.s) ? 1 : 0;
    int64_t l = ik.l + sdol;
    for (int cc = 3; cc > c; cc--) l += tl[cc] - tk[cc];
    out->k = fm.C[c] + tk[c];
    out->l = l;
    out->s = tl[c] - tk[c];
    out->start = ik.start;
    out->end = ik.end;
}

// single-char forward extension (append c) via the swap/complement trick
static inline void extend_fwd_1(const FM &fm, const BiIntv &ik, int c,
                                BiIntv *out) {
    BiIntv tmp{ik.l, ik.k, ik.s, ik.start, ik.end};
    BiIntv o2;
    extend_back_1(fm, tmp, 3 - c, &o2);
    out->k = o2.l;
    out->l = o2.k;
    out->s = o2.s;
    out->start = ik.start;
    out->end = ik.end;
}

static inline BiIntv init_intv(const FM &fm, int c, int x) {
    return BiIntv{fm.C[c], fm.C[3 - c], fm.C[c + 1] - fm.C[c], x, x + 1};
}

// all SMEMs passing through position x with interval size >= min_intv;
// returns the next anchor (end of the longest exact match through x)
static int smem1(const FM &fm, const uint8_t *q, int len, int x,
                 int64_t min_intv, std::vector<BiIntv> &mem,
                 std::vector<BiIntv> &prev, std::vector<BiIntv> &curr) {
    if (min_intv < 1) min_intv = 1;
    curr.clear();
    BiIntv ik = init_intv(fm, q[x], x);
    BiIntv oc;
    int i;
    for (i = x + 1; i < len; i++) {           // forward pass
        if (q[i] < 4) {
            int c = q[i];
            extend_fwd_1(fm, ik, c, &oc);
            if (oc.s != ik.s) {
                curr.push_back(ik);
                if (oc.s < min_intv) break;
            }
            ik = oc;
            ik.end = i + 1;
        } else {
            curr.push_back(ik);
            break;
        }
    }
    if (i == len) curr.push_back(ik);
    int ret = curr.back().end;
    prev.assign(curr.rbegin(), curr.rend());  // longest first

    for (i = x - 1; i >= -1; --i) {           // backward pass
        int c = (i < 0 || q[i] > 3) ? -1 : q[i];
        curr.clear();
        for (size_t j = 0; j < prev.size(); j++) {
            const BiIntv &p = prev[j];
            if (c >= 0) extend_back_1(fm, p, c, &oc);
            if (c < 0 || oc.s < min_intv) {
                if (curr.empty()) {
                    // longest candidate died: [i+1, p.end) is an SMEM
                    // unless contained in the previously emitted one
                    if (mem.empty() || i + 1 < mem.back().start) {
                        BiIntv t = p;
                        t.start = i + 1;
                        mem.push_back(t);
                    }
                }
            } else if (curr.empty() || oc.s != curr.back().s) {
                oc.start = p.start;
                oc.end = p.end;
                curr.push_back(oc);
            }
        }
        if (curr.empty()) break;
        std::swap(curr, prev);
    }
    return ret;
}

// LAST-like third round (BWA bwt_seed_strategy1): forward-only greedy,
// emit the first extension whose interval drops under max_intv once the
// match is long enough.  The _from variant resumes from a precomputed
// interval ik for q[x..i0) — identical to the plain walk when
// (i0, ik) = (x+1, init_intv(q[x], x)); the k-mer jump table below
// supplies ik for i0 = x+K in O(1).  Skipping the emit checks below i0
// is exact because they cannot fire while i-x < min_len (callers keep
// K <= min_len), and a dead interval (s=0) stays dead under extension,
// so its k/l are never observable.
static int seed_strategy1_from(const FM &fm, const uint8_t *q, int len,
                               int x, int i0, BiIntv ik, int min_len,
                               int64_t max_intv, BiIntv *out) {
    out->s = 0;
    BiIntv oc;
    for (int i = i0; i < len; i++) {
        if (q[i] < 4) {
            int c = q[i];
            extend_fwd_1(fm, ik, c, &oc);
            if (oc.s < max_intv && i - x >= min_len) {
                if (oc.s > 0) {
                    *out = oc;
                    out->start = x;
                    out->end = i + 1;
                }
                return i + 1;
            }
            ik = oc;
        } else {
            return i + 1;
        }
    }
    return len;
}

static int seed_strategy1(const FM &fm, const uint8_t *q, int len, int x,
                          int min_len, int64_t max_intv, BiIntv *out) {
    return seed_strategy1_from(fm, q, len, x, x + 1,
                               init_intv(fm, q[x], x), min_len, max_intv,
                               out);
}

// ---------------------------------------------------------------------------
// Interleaved SMEM loop: the per-read walk is a serial chain of occ
// lookups (each extension's block address depends on the previous
// result), so a single read leaves the core stalled on L2/L3 for most
// of its wall (measured ~11 us/read vs ~4 us of pure compute).  Running
// W reads per thread as explicit state machines — each step executes
// exactly one pending extension, then PREFETCHES the occ rows of its
// next one and yields — overlaps each lane's memory latency with the
// other lanes' compute.  Outputs are bit-identical to the scalar loop
// (same per-read code path, time-multiplexed; no cross-read state) —
// equivalence-gated in tests/test_native.py.
// ---------------------------------------------------------------------------

static inline void pf_occ(const FM &fm, int64_t k) {
    int64_t adj = k - (k > fm.primary ? 1 : 0);
    const char *p = (const char *)(fm.blocks + (adj >> 7) * 12);
    __builtin_prefetch(p, 0, 3);
    __builtin_prefetch(p + 47, 0, 3);   // 48 B rows straddle two lines
}

static inline void pf_pair(const FM &fm, int64_t k, int64_t s) {
    pf_occ(fm, k);
    pf_occ(fm, k + s);
}

struct IlvParams {
    int32_t min_seed_len, split_len, split_width, max_mem_intv, max_seeds;
    const int64_t *ktab;
    int32_t K;
    int32_t *s_lo, *s_hi, *s_qb, *s_len, *n_seeds;
};

struct IlvLane {
    const uint8_t *q = nullptr;
    int len = 0;
    int64_t b = -1;              // < 0: lane idle
    std::vector<BiIntv> mems, m1, prev, curr;
    BiIntv ik, oc;
    int64_t min_intv = 1;
    int x = 0, sx = 0, i = 0, ret = 0, bc = -1, pc = 0;
    size_t j = 0, n_old = 0, m2 = 0;
    int cont = 0;                // after smem1: 0 -> round-1 loop, 1 -> round 2
    int resume = 0;              // 0 new read, 1 fwd, 2 back, 3 round-3
};

// One scheduling quantum: run lane L until it issues its next occ
// lookup (prefetched; resume point recorded) or the read completes.
// Control flow mirrors smem1 / seed_strategy1_from / the scalar batch
// loop statement-for-statement.
static bool ilv_step(const FM &fm, IlvLane &L, const IlvParams &P) {
    switch (L.resume) {
        case 1: goto r_fwd;
        case 2: goto r_back;
        case 3: goto r_r3;
        default: break;
    }
    // fresh read: round 1 (all SMEMs through each anchor)
    L.mems.clear();
    L.cont = 0;
    L.x = 0;
r1_anchor:
    if (L.x >= L.len) goto r2_init;
    if (L.q[L.x] > 3) { L.x++; goto r1_anchor; }
    L.m1.clear();
    L.min_intv = 1;
    L.sx = L.x;
    goto smem1_start;

smem1_start:
    L.curr.clear();
    L.ik = init_intv(fm, L.q[L.sx], L.sx);
    L.i = L.sx + 1;
fwd_loop:
    if (L.i >= L.len) { L.curr.push_back(L.ik); goto fwd_done; }
    if (L.q[L.i] > 3) { L.curr.push_back(L.ik); goto fwd_done; }
    L.pc = L.q[L.i];
    pf_pair(fm, L.ik.l, L.ik.s);     // fwd extend ranks the swapped side
    L.resume = 1;
    return true;
r_fwd:
    extend_fwd_1(fm, L.ik, L.pc, &L.oc);
    if (L.oc.s != L.ik.s) {
        L.curr.push_back(L.ik);
        if (L.oc.s < L.min_intv) goto fwd_done;
    }
    L.ik = L.oc;
    L.ik.end = L.i + 1;
    L.i++;
    goto fwd_loop;
fwd_done:
    L.ret = L.curr.back().end;
    L.prev.assign(L.curr.rbegin(), L.curr.rend());
    L.i = L.sx - 1;
back_i:
    if (L.i < -1) goto smem1_done;
    L.bc = (L.i < 0 || L.q[L.i] > 3) ? -1 : L.q[L.i];
    L.curr.clear();
    L.j = 0;
back_j:
    if (L.j >= L.prev.size()) goto back_i_end;
    if (L.bc >= 0) {
        L.pc = L.bc;
        pf_pair(fm, L.prev[L.j].k, L.prev[L.j].s);
        L.resume = 2;
        return true;
    }
    goto back_dead;
r_back:
    {
        const BiIntv &p = L.prev[L.j];
        extend_back_1(fm, p, L.pc, &L.oc);
        if (L.oc.s < L.min_intv) goto back_dead;
        if (L.curr.empty() || L.oc.s != L.curr.back().s) {
            L.oc.start = p.start;
            L.oc.end = p.end;
            L.curr.push_back(L.oc);
        }
    }
    L.j++;
    goto back_j;
back_dead:
    {
        const BiIntv &p = L.prev[L.j];
        if (L.curr.empty()) {
            if (L.m1.empty() || L.i + 1 < L.m1.back().start) {
                BiIntv t = p;
                t.start = L.i + 1;
                L.m1.push_back(t);
            }
        }
    }
    L.j++;
    goto back_j;
back_i_end:
    if (L.curr.empty()) goto smem1_done;
    std::swap(L.curr, L.prev);
    L.i--;
    goto back_i;
smem1_done:
    L.mems.insert(L.mems.end(), L.m1.begin(), L.m1.end());
    if (L.cont == 0) { L.x = L.ret; goto r1_anchor; }
    L.m2++;
    goto r2_loop;

r2_init:
    // round 2: re-seed long unique-ish MEMs from their middle
    L.n_old = L.mems.size();
    L.m2 = 0;
    L.cont = 1;
r2_loop:
    if (L.m2 >= L.n_old) goto r3_init;
    {
        BiIntv mm = L.mems[L.m2];     // by value: mems may grow
        if (mm.end - mm.start >= P.split_len && mm.s <= P.split_width) {
            L.m1.clear();
            L.min_intv = mm.s + 1;
            L.sx = (mm.start + mm.end) >> 1;
            goto smem1_start;
        }
    }
    L.m2++;
    goto r2_loop;

r3_init:
    // round 3: LAST-like forward-greedy seeds (k-mer jump table)
    if (P.max_mem_intv <= 0) goto fin;
    L.x = 0;
r3_anchor:
    if (L.x >= L.len) goto fin;
    if (L.q[L.x] > 3) { L.x++; goto r3_anchor; }
    {
        const int K = P.ktab ? P.K : 0;
        if (K && L.x + K <= L.len) {
            int64_t code = 0;
            int nx = -1;
            for (int jj = 0; jj < K; jj++) {
                int c = L.q[L.x + jj];
                if (c > 3) { nx = L.x + jj + 1; break; }
                code = code * 4 + c;
            }
            if (nx >= 0) { L.x = nx; goto r3_anchor; }
            L.ik = BiIntv{P.ktab[code * 3], P.ktab[code * 3 + 1],
                          P.ktab[code * 3 + 2], L.x, L.x + K};
            L.i = L.x + K;
        } else {
            L.ik = init_intv(fm, L.q[L.x], L.x);
            L.i = L.x + 1;
        }
    }
r3_chain:
    if (L.i >= L.len) { L.x = L.len; goto r3_anchor; }
    if (L.q[L.i] > 3) { L.x = L.i + 1; goto r3_anchor; }
    L.pc = L.q[L.i];
    pf_pair(fm, L.ik.l, L.ik.s);
    L.resume = 3;
    return true;
r_r3:
    extend_fwd_1(fm, L.ik, L.pc, &L.oc);
    if (L.oc.s < P.max_mem_intv && L.i - L.x >= P.min_seed_len) {
        if (L.oc.s > 0) {
            BiIntv mm = L.oc;
            mm.start = L.x;
            mm.end = L.i + 1;
            L.mems.push_back(mm);
        }
        L.x = L.i + 1;
        goto r3_anchor;
    }
    L.ik = L.oc;
    L.i++;
    goto r3_chain;

fin:
    // filter by seed length, dedup by (start, end, k), cap — the scalar
    // epilogue verbatim
    {
        int ns = 0;
        const int64_t b = L.b;
        const int32_t ms = P.max_seeds;
        for (size_t m = 0; m < L.mems.size() && ns < ms; m++) {
            const BiIntv &mm = L.mems[m];
            if (mm.end - mm.start < P.min_seed_len || mm.s <= 0) continue;
            bool dup = false;
            for (int t = 0; t < ns; t++) {
                if (P.s_qb[b * ms + t] == mm.start
                    && P.s_len[b * ms + t] == mm.end - mm.start
                    && P.s_lo[b * ms + t] == (int32_t)mm.k) {
                    dup = true;
                    break;
                }
            }
            if (dup) continue;
            P.s_lo[b * ms + ns] = (int32_t)mm.k;
            P.s_hi[b * ms + ns] = (int32_t)(mm.k + mm.s);
            P.s_qb[b * ms + ns] = mm.start;
            P.s_len[b * ms + ns] = mm.end - mm.start;
            ns++;
        }
        P.n_seeds[b] = ns;
    }
    L.resume = 0;
    return false;
}

}  // namespace smem

// Bi-intervals of every K-mer, built once per index by breadth-first
// backward extension (one extend_back per parent yields all 4 children:
// (4^K-4)/3 rank ops for the whole table).  out[m] = (k, l, s) of the
// K-mer whose base-4 code (leftmost char most significant) is m; absent
// K-mers have s = 0.  Round 3 of smem_seed_batch jumps its first K
// extensions through this table.
extern "C" void smem_kmer_table(
    const int32_t *occ_blocks, const int64_t *counts, int64_t primary,
    int64_t fm_n, int32_t K, int64_t *out) {
    if (K < 1) return;   // the 4 single-base rows below need 4^K >= 4
    smem::FM fm{occ_blocks, counts, primary, fm_n};
    std::vector<smem::BiIntv> cur(4), nxt;
    for (int c = 0; c < 4; c++) cur[c] = smem::init_intv(fm, c, 0);
    int64_t sz = 4;
    for (int j = 1; j < K; j++) {
        nxt.assign(sz * 4, smem::BiIntv{0, 0, 0, 0, 0});
        for (int64_t m = 0; m < sz; m++) {
            const smem::BiIntv &p = cur[m];
            if (p.s <= 0) continue;               // children stay dead
            smem::BiIntv ch[4];
            smem::extend_back(fm, p, ch);
            for (int c = 0; c < 4; c++) nxt[(int64_t)c * sz + m] = ch[c];
        }
        std::swap(cur, nxt);
        sz *= 4;
    }
    for (int64_t m = 0; m < sz; m++) {
        out[m * 3 + 0] = cur[m].k;
        out[m * 3 + 1] = cur[m].l;
        out[m * 3 + 2] = cur[m].s;
    }
}

extern "C" void smem_seed_batch(
    const int32_t *occ_blocks, const int64_t *counts,
    int64_t primary, int64_t fm_n,
    const uint8_t *reads, const int32_t *lens, int64_t B, int32_t Lmax,
    int32_t min_seed_len, int32_t split_len, int32_t split_width,
    int32_t max_mem_intv, int32_t max_seeds, int32_t n_threads,
    const int64_t *ktab, int32_t ktab_k,
    int32_t *s_lo, int32_t *s_hi, int32_t *s_qb, int32_t *s_len,
    int32_t *n_seeds) {
    smem::FM fm{occ_blocks, counts, primary, fm_n};

    // interleaved default is SIZE-GATED: occ tables that fit L2
    // (~2 MB at bacterial scale) leave the chains compute-bound and the
    // machine overhead costs ~3%; from ~tens of MB the lookups spill to
    // L3/DRAM and interleaving wins (measured 1.14x at a 32 Mbp genome,
    // growing with index size).  fm_n > 16M rows ~= 6 MB of occ.
    // EMA_TPU_SMEM_ILV=1/0 forces either path (equivalence oracle).
    const char *ilv_env = getenv("EMA_TPU_SMEM_ILV");
    const bool use_ilv = ilv_env ? (ilv_env[0] != '0')
                                 : (fm_n > (int64_t)16000000);

    // lane count: swept on a 1-core host at a 32 Mbp index
    // (occ 24 MB): 8->1.19x, 16->1.31x, 24->1.33x over scalar, W>=48
    // degrades as lane state spills L2 — 24 is the plateau
    const char *wenv = getenv("EMA_TPU_SMEM_ILV_W");
    const int ilv_w = wenv ? std::max(1, atoi(wenv)) : 24;

    auto work_ilv = [&](int64_t b0, int64_t b1) {
        const int W = ilv_w;
        smem::IlvParams P{min_seed_len, split_len, split_width,
                          max_mem_intv, max_seeds, ktab, ktab_k,
                          s_lo, s_hi, s_qb, s_len, n_seeds};
        std::vector<smem::IlvLane> lanes(W);
        int64_t nb = b0;
        while (true) {
            bool any = false;
            for (int w = 0; w < W; w++) {
                smem::IlvLane &L = lanes[w];
                if (L.b < 0) {
                    if (nb >= b1) continue;
                    L.q = reads + nb * Lmax;
                    L.len = lens[nb];
                    L.b = nb++;
                    L.resume = 0;
                }
                any = true;
                if (!smem::ilv_step(fm, L, P)) L.b = -1;
            }
            if (!any) break;
        }
    };

    auto work = [&](int64_t b0, int64_t b1) {
        if (use_ilv) return work_ilv(b0, b1);
        std::vector<smem::BiIntv> mems, m1, prev, curr;
        for (int64_t b = b0; b < b1; b++) {
            const uint8_t *q = reads + b * Lmax;
            int len = lens[b];
            mems.clear();
            // round 1: all SMEMs (mem_collect_intv first pass).  m1 is
            // cleared per smem1 call: its contained-match suppression is
            // scoped to one anchor, as in BWA (a->mem1.n = 0 per call)
            for (int x = 0; x < len;) {
                if (q[x] < 4) {
                    m1.clear();
                    x = smem::smem1(fm, q, len, x, 1, m1, prev, curr);
                    mems.insert(mems.end(), m1.begin(), m1.end());
                } else {
                    x++;
                }
            }
            // round 2: re-seed long unique-ish MEMs from their middle,
            // requiring strictly more occurrences (split_len/split_width
            // are BWA's min_seed_len*1.5 and 10)
            size_t n_old = mems.size();
            for (size_t m = 0; m < n_old; m++) {
                smem::BiIntv mm = mems[m];
                if (mm.end - mm.start >= split_len && mm.s <= split_width) {
                    m1.clear();
                    smem::smem1(fm, q, len, (mm.start + mm.end) >> 1,
                                mm.s + 1, m1, prev, curr);
                    mems.insert(mems.end(), m1.begin(), m1.end());
                }
            }
            // round 3: LAST-like forward-greedy seeds.  With a k-mer
            // table the first K extensions of each restart are one
            // lookup (exactness argued at seed_strategy1_from; K <=
            // min_seed_len is enforced at the wrapper).
            if (max_mem_intv > 0) {
                const int K = ktab ? ktab_k : 0;
                for (int x = 0; x < len;) {
                    if (q[x] < 4) {
                        smem::BiIntv mm;
                        if (K && x + K <= len) {
                            int64_t code = 0;
                            int nx = -1;
                            for (int j = 0; j < K; j++) {
                                int c = q[x + j];
                                if (c > 3) { nx = x + j + 1; break; }
                                code = code * 4 + c;
                            }
                            if (nx >= 0) { x = nx; continue; }
                            smem::BiIntv ik{ktab[code * 3],
                                            ktab[code * 3 + 1],
                                            ktab[code * 3 + 2],
                                            x, x + K};
                            x = smem::seed_strategy1_from(
                                fm, q, len, x, x + K, ik, min_seed_len,
                                max_mem_intv, &mm);
                        } else {
                            x = smem::seed_strategy1(fm, q, len, x,
                                                     min_seed_len,
                                                     max_mem_intv, &mm);
                        }
                        if (mm.s > 0) mems.push_back(mm);
                    } else {
                        x++;
                    }
                }
            }
            // filter by seed length, dedup by (start, end, k), cap
            int ns = 0;
            for (size_t m = 0; m < mems.size() && ns < max_seeds; m++) {
                const smem::BiIntv &mm = mems[m];
                if (mm.end - mm.start < min_seed_len || mm.s <= 0) continue;
                bool dup = false;
                for (int t = 0; t < ns; t++) {
                    if (s_qb[b * max_seeds + t] == mm.start
                        && s_len[b * max_seeds + t] == mm.end - mm.start
                        && s_lo[b * max_seeds + t] == (int32_t)mm.k) {
                        dup = true;
                        break;
                    }
                }
                if (dup) continue;
                s_lo[b * max_seeds + ns] = (int32_t)mm.k;
                s_hi[b * max_seeds + ns] = (int32_t)(mm.k + mm.s);
                s_qb[b * max_seeds + ns] = mm.start;
                s_len[b * max_seeds + ns] = mm.end - mm.start;
                ns++;
            }
            n_seeds[b] = ns;
        }
    };

    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt == 1 || B < 64) {
        work(0, B);
        return;
    }
    std::vector<std::thread> ts;
    int64_t step = (B + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t b0 = t * step, b1 = std::min(B, b0 + step);
        if (b0 >= b1) break;
        ts.emplace_back(work, b0, b1);
    }
    for (auto &th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Host greedy seeding + batched SA locate (the CPU-backend FM path).
//
// Value-identical to the device programs (index/fmindex.seed_reads /
// locate): the same right-to-left greedy maximal-suffix chop (restart on
// empty extension, min_seed_len gate, first max_seeds kept, final flush
// at the read start) and the same sampled-SA LF walk.  The occ table for
// bacterial-scale genomes fits L2 and one scalar rank is ~20 ops, so on
// a host core this beats the XLA:CPU vectorized scan severalfold while
// the TPU keeps the fused device program (fmindex.seed_locate_reads).
// ---------------------------------------------------------------------------

extern "C" void greedy_seed_batch(
    const int32_t *occ_blocks, const int64_t *counts,
    int64_t primary, int64_t fm_n,
    const uint8_t *reads, const int32_t *lens, int64_t B, int32_t Lmax,
    int32_t min_seed_len, int32_t max_seeds, int32_t n_threads,
    int32_t *s_lo, int32_t *s_hi, int32_t *s_qb, int32_t *s_len,
    int32_t *n_seeds) {
    smem::FM fm{occ_blocks, counts, primary, fm_n};

    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; b++) {
            const uint8_t *q = reads + b * Lmax;
            int len = lens[b];
            int32_t *slo = s_lo + b * max_seeds;
            int32_t *shi = s_hi + b * max_seeds;
            int32_t *sqb = s_qb + b * max_seeds;
            int32_t *sln = s_len + b * max_seeds;
            int64_t lo = 0, hi = 0;
            int span = 0, ns = 0;
            for (int pos = len - 1; pos >= 0; pos--) {
                int c = q[pos];
                bool valid = c < 4;
                bool ext_ok = false;
                int64_t nlo = 0, nhi = 0;
                if (valid && span > 0) {
                    int64_t rl, rh;
                    fm.occ2(c, lo, hi, &rl, &rh);
                    nlo = counts[c] + rl;
                    nhi = counts[c] + rh;
                    ext_ok = nhi > nlo;
                }
                if (span > 0 && !ext_ok && span >= min_seed_len
                        && ns < max_seeds) {
                    slo[ns] = (int32_t)lo;
                    shi[ns] = (int32_t)hi;
                    sqb[ns] = pos + 1;
                    sln[ns] = span;
                    ns++;
                }
                if (ext_ok) {
                    lo = nlo; hi = nhi; span++;
                } else if (valid && counts[c + 1] > counts[c]) {
                    lo = counts[c]; hi = counts[c + 1]; span = 1;
                } else {
                    lo = hi = 0; span = 0;
                }
            }
            if (span >= min_seed_len && ns < max_seeds) {
                slo[ns] = (int32_t)lo;
                shi[ns] = (int32_t)hi;
                sqb[ns] = 0;
                sln[ns] = span;
                ns++;
            }
            n_seeds[b] = ns;
        }
    };

    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt == 1 || B < 64) {
        work(0, B);
        return;
    }
    std::vector<std::thread> ts;
    int64_t step = (B + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t b0 = t * step, b1 = std::min(B, b0 + step);
        if (b0 >= b1) break;
        ts.emplace_back(work, b0, b1);
    }
    for (auto &th : ts) th.join();
}

extern "C" void locate_batch(
    const int32_t *occ_blocks, const int64_t *counts,
    int64_t primary, int64_t fm_n,
    const uint32_t *mark_words, const int32_t *mark_rank,
    const int32_t *sa_values, int32_t sa_rate,
    const int64_t *rows, int64_t N, int32_t n_threads, int64_t *out) {
    smem::FM fm{occ_blocks, counts, primary, fm_n};
    (void)sa_rate;   // the walk terminates at a marked row (<= sa_rate-1)

    auto marked = [&](int64_t r) -> bool {
        return (mark_words[r >> 5] >> (r & 31)) & 1u;
    };
    auto marked_value = [&](int64_t r) -> int64_t {
        uint32_t below = mark_words[r >> 5]
            & ((r & 31) ? ((1u << (r & 31)) - 1u) : 0u);
        return sa_values[mark_rank[r >> 5] + __builtin_popcount(below)];
    };
    auto work = [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; i++) {
            int64_t r = rows[i];
            int64_t steps = 0;
            while (!marked(r)) {
                int ch = fm.bwt_char(r);
                r = counts[ch] + fm.occ1(ch, r);
                steps++;
            }
            out[i] = marked_value(r) + steps;
        }
    };

    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt == 1 || N < 1024) {
        work(0, N);
        return;
    }
    std::vector<std::thread> ts;
    int64_t step = (N + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t i0 = t * step, i1 = std::min(N, i0 + step);
        if (i0 >= i1) break;
        ts.emplace_back(work, i0, i1);
    }
    for (auto &th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Cloud-EM for deep-candidate groups (reference align.c:431-543).
//
// The numpy/JAX EM paths vectorize the mate term as a [C, C_mate] product
// per entry — ideal for the common case (C <= ~100) but quadratic *memory*
// when an entry holds thousands of candidates (reference-scale repeat
// families under MAX_CANDIDATES = 5000, samdict.h:9).  This path replicates
// the same math with the reference's own loop shape: O(C * C_mate) time,
// O(C) memory.  Semantics identical to groups.run_em_host:
//   - two-phase update order (phase A = unpaired + later-inserted mates,
//     phase B = earlier-inserted) — pair members are always in different
//     phases, so in-place sequential updates equal the snapshot semantics,
//   - normalize_log_probs numerics (max-shift, log(1e-50) - log(n) floor,
//     exact 1.0 for single-candidate entries; src/util.c:129-163),
//   - cloud weights = expected coverage over active records, renormalized
//     within disjoint-set chains (align.c:125-143) or per-entry for
//     many_clouds platforms.
// ---------------------------------------------------------------------------

namespace emflat {

static const double LOG_EPS = -115.12925464970229;   // log(1e-50)

static void normalize_log_probs(double *p, int64_t n) {
    if (n <= 0) return;
    if (n == 1) { p[0] = 1.0; return; }
    double mx = p[0];
    for (int64_t i = 1; i < n; i++) mx = std::max(mx, p[i]);
    double thresh = LOG_EPS - log((double)n);
    double tot = 0.0;
    for (int64_t i = 0; i < n; i++) {
        double s = p[i] - mx;
        p[i] = s < thresh ? 0.0 : exp(s);
        tot += p[i];
    }
    if (tot > 0) for (int64_t i = 0; i < n; i++) p[i] /= tot;
}

}  // namespace emflat

extern "C" void em_run_flat(
    int64_t n_entries, const int64_t *cand_off,
    const int32_t *cloud, const int32_t *chrom, const int64_t *pos,
    const int8_t *rev, const double *score, const uint8_t *active,
    double *gammas,                 // in/out, flat [N]
    double *weights,                // in/out, [n_clouds]
    const int64_t *mate_entry, int64_t n_clouds, const int64_t *comp,
    int32_t many, int32_t iters,
    int64_t insert_min, int64_t insert_max, double unpaired_penalty) {
    std::vector<double> buf;
    std::vector<double> exp_cov((size_t)n_clouds);
    std::vector<double> chain_tot((size_t)n_clouds);

    auto update_entry = [&](int64_t e) {
        int64_t b = cand_off[e], n = cand_off[e + 1] - b;
        if (n <= 0) return;
        buf.resize((size_t)n);
        // cloud weight per candidate (+ per-entry normalization for
        // many_clouds platforms)
        double wtot = 0.0;
        if (many) {
            for (int64_t c = 0; c < n; c++) wtot += weights[cloud[b + c]];
        }
        int64_t m = mate_entry[e];
        int64_t mb = 0, mn = 0;
        if (m >= 0) { mb = cand_off[m]; mn = cand_off[m + 1] - mb; }
        for (int64_t c = 0; c < n; c++) {
            double w = weights[cloud[b + c]];
            if (many) w = wtot > 0 ? w / wtot : 0.0;
            double log_w = log(w > 0 ? w : 1e-300);
            double best = unpaired_penalty;
            int32_t icl = cloud[b + c], ich = chrom[b + c];
            int8_t irv = rev[b + c];
            int64_t ips = pos[b + c];
            for (int64_t c2 = 0; c2 < mn; c2++) {
                if (cloud[mb + c2] != icl || chrom[mb + c2] != ich
                    || rev[mb + c2] == irv) continue;
                double g = gammas[mb + c2];
                if (g == 0.0) continue;
                int64_t d = irv == 1 ? ips - pos[mb + c2]
                                     : pos[mb + c2] - ips;
                double pen = (d >= insert_min && d <= insert_max)
                             ? 0.0 : unpaired_penalty;
                double ms = pen + log(g);
                if (ms > best) best = ms;
            }
            buf[(size_t)c] = score[b + c] + log_w + best;
        }
        emflat::normalize_log_probs(buf.data(), n);
        for (int64_t c = 0; c < n; c++) gammas[b + c] = buf[(size_t)c];
    };

    for (int32_t it = 0; it < iters; it++) {
        // phase A: unpaired entries + the later-inserted pair member
        for (int64_t e = 0; e < n_entries; e++)
            if (!(mate_entry[e] >= 0 && e < mate_entry[e])) update_entry(e);
        // phase B: the earlier-inserted pair member (sees A's new gammas)
        for (int64_t e = 0; e < n_entries; e++)
            if (mate_entry[e] >= 0 && e < mate_entry[e]) update_entry(e);

        // weights <- expected coverage of active records
        std::fill(exp_cov.begin(), exp_cov.end(), 0.0);
        for (int64_t e = 0; e < n_entries; e++)
            for (int64_t c = cand_off[e]; c < cand_off[e + 1]; c++)
                if (active[c]) exp_cov[cloud[c]] += gammas[c];
        if (!many && n_clouds > 0) {
            std::fill(chain_tot.begin(), chain_tot.end(), 0.0);
            for (int64_t k = 0; k < n_clouds; k++)
                chain_tot[comp[k]] += exp_cov[k];
            for (int64_t k = 0; k < n_clouds; k++) {
                double t = chain_tot[comp[k]];
                weights[k] = t > 0 ? exp_cov[k] / t : exp_cov[k];
            }
        } else {
            for (int64_t k = 0; k < n_clouds; k++) weights[k] = exp_cov[k];
        }
    }
}

// ---------------------------------------------------------------------------
// Reference-compatible emission order + bucket assignment
// ---------------------------------------------------------------------------
// The reference preprocessor emits .ema-ncnt entries and assigns barcodes
// to buckets by iterating a std::unordered_map<uint32_t, ...>
// (cpp/count.cc:160-170, cpp/correct.cc:407-412) — an order that is
// implementation-defined but deterministic for a given libstdc++ and key
// insertion sequence.  To make our outputs byte-identical we replay the
// same insertion sequence into a real std::unordered_map built with the
// same libstdc++, and emit its iteration order.  Value type does not
// affect libstdc++ hashtable layout, so one replay serves both count
// (uint32->int64) and correct (uint32->Count).

#include <unordered_map>
#include <queue>
#include <tuple>

// keys: insertion sequence (duplicates keep the first occurrence, like
// map[k] = 0).  out_idx receives, in map-iteration order, the index of
// each distinct key's first occurrence in `keys`.  Returns the number of
// distinct keys written.
extern "C" int64_t umap_order_u32(const uint32_t *keys, int64_t n,
                                  int64_t *out_idx) {
    std::unordered_map<uint32_t, int64_t> m;  // default growth policy
    for (int64_t i = 0; i < n; i++) m.emplace(keys[i], i);
    int64_t w = 0;
    for (auto &kv : m) out_idx[w++] = kv.second;
    return w;
}

// Flat-array simulation of libstdc++'s _Hashtable insertion mechanics —
// same iteration order as umap_order_u32 (equality-tested against the
// real map on randomized key streams with duplicates and modular
// collisions in tests/test_native.py) at ~8x the speed: no per-node malloc, no
// pointer chasing through heap nodes.  Growth thresholds come from the
// REAL std::__detail::_Prime_rehash_policy in the linked libstdc++, so
// the rehash schedule is exact by construction; the singly-linked
// global-list mechanics below mirror _M_insert_bucket_begin and
// _M_rehash_aux (bits/hashtable.h): a node entering an empty bucket is
// pushed to the global head, a node entering an occupied bucket is
// inserted at that bucket's front, and rehash re-inserts nodes in old
// global order.  std::hash<uint32_t> is the identity.
// distinct != 0 asserts the caller pre-deduplicated keys: the duplicate
// probe walk (which cannot change the outcome) is skipped.
extern "C" int64_t umap_order_u32_sim(const uint32_t *keys, int64_t n,
                                      int64_t *out_idx, int32_t distinct) {
    // node ids / indices are int32 (keys fit: a uint32 key space holds
    // < 2^32 distinct keys and real inputs are << 2^31) — halves the
    // working set, which is what this loop is bound on
    if (n >= INT32_MAX) return -1;
    std::__detail::_Prime_rehash_policy pol(1.0f);
    std::vector<uint32_t> kv;     // node id -> key
    std::vector<int32_t> src;     // node id -> first-occurrence index
    std::vector<int32_t> nxt;     // node id -> next node in global list
    kv.reserve(n); src.reserve(n); nxt.reserve(n);
    // bucket -> "before node" of the bucket's first element:
    //   -1 = empty bucket, -2 = &before_begin, >=0 = node id
    std::vector<int32_t> before(1, -1);
    size_t bucket_count = 1;
    int32_t head = -1;            // before_begin._M_nxt

    for (int64_t i = 0; i < n; i++) {
        // the loop is bound on cache misses into before[] (random access
        // over a bucket array that grows to tens of MB); bucket_count is
        // constant between rehashes, so the miss D iterations ahead is
        // computable now (prefetches issued just before a rehash simply
        // touch a stale slot — harmless)
        if (i + 16 < n)
            __builtin_prefetch(&before[(size_t)keys[i + 16] % bucket_count],
                               1, 1);
        uint32_t k = keys[i];
        size_t b = (size_t)k % bucket_count;
        // duplicate probe: walk the bucket (ends where the successor's
        // bucket index changes, as _M_find_node does)
        bool found = false;
        if (!distinct && before[b] != -1) {
            int32_t p = before[b] == -2 ? head : nxt[before[b]];
            while (p != -1) {
                if (kv[p] == k) { found = true; break; }
                int32_t q = nxt[p];
                if (q == -1 || (size_t)kv[q] % bucket_count != b) break;
                p = q;
            }
        }
        if (found) continue;

        auto need = pol._M_need_rehash(bucket_count, kv.size(), 1);
        if (need.first) {
            size_t nb = need.second;
            std::vector<int32_t> nbefore(nb, -1);
            // materialize the global chain first so the re-insert pass can
            // prefetch nbefore[] (the chain itself can't be looked ahead)
            std::vector<int32_t> order;
            order.reserve(kv.size());
            for (int32_t p = head; p != -1; p = nxt[p]) order.push_back(p);
            head = -1;
            size_t bbegin_bkt = 0;   // bucket of the current global head
            const size_t cnt = order.size();
            for (size_t j = 0; j < cnt; j++) {
                if (j + 16 < cnt)
                    __builtin_prefetch(
                        &nbefore[(size_t)kv[order[j + 16]] % nb], 1, 1);
                int32_t p = order[j];
                size_t pb = (size_t)kv[p] % nb;
                if (nbefore[pb] == -1) {
                    nxt[p] = head;
                    if (head != -1) nbefore[bbegin_bkt] = p;
                    head = p;
                    nbefore[pb] = -2;
                    bbegin_bkt = pb;
                } else if (nbefore[pb] == -2) {
                    nxt[p] = head;
                    head = p;
                } else {
                    int32_t bef = nbefore[pb];
                    nxt[p] = nxt[bef];
                    nxt[bef] = p;
                }
            }
            before.swap(nbefore);
            bucket_count = nb;
            b = (size_t)k % bucket_count;
        }

        int32_t node = (int32_t)kv.size();
        kv.push_back(k);
        src.push_back((int32_t)i);
        nxt.push_back(-1);
        if (before[b] == -1) {
            // empty bucket: push to global head; the old head's bucket
            // now has `node` as its before-node
            nxt[node] = head;
            if (head != -1)
                before[(size_t)kv[head] % bucket_count] = node;
            head = node;
            before[b] = -2;
        } else if (before[b] == -2) {
            nxt[node] = head;
            head = node;
        } else {
            int32_t bef = before[b];
            nxt[node] = nxt[bef];
            nxt[bef] = node;
        }
    }

    int64_t w = 0;
    for (int32_t p = head; p != -1; p = nxt[p]) out_idx[w++] = src[p];
    return w;
}

// One-pass CIGAR tallies over a flat BAM-encoded op pool.  Replaces the
// numpy [B, max_ops] mask/where/sum stack (several 4M-element
// temporaries per emit batch) feeding the generative score
// (align.c:846-913 inputs) and the ref-span computations.  off[b] is
// record b's first op index in pool; ln[b] its op count.
extern "C" void cigar_stats_pool(const uint32_t *pool, const int64_t *off,
                                 const int32_t *ln, int64_t B,
                                 int64_t *m_bases, int64_t *indel_bases,
                                 int64_t *indel_runs, int64_t *clip_bases,
                                 int64_t *ref_len) {
    for (int64_t b = 0; b < B; b++) {
        const uint32_t *c = pool + off[b];
        const int32_t n = ln[b];
        int64_t mb = 0, ib = 0, ir = 0, cb = 0, rl = 0;
        for (int32_t i = 0; i < n; i++) {
            const uint32_t op = c[i] & 0xF;
            const int64_t l = c[i] >> 4;
            if (op == 0) { mb += l; rl += l; }
            else if (op == 1) { ib += l; ir++; }
            else if (op == 2) { ib += l; ir++; rl += l; }
            else if (op == 3 || op == 4) cb += l;
        }
        m_bases[b] = mb; indel_bases[b] = ib; indel_runs[b] = ir;
        clip_bases[b] = cb; ref_len[b] = rl;
    }
}

// Preproc barcode encoding (count.cc:130): 16 bases -> uint32, first
// base in the HIGH bits, hash_dna (ACGTacgt -> 0..3, else 0).  One pass
// over strided raw file/FASTQ bytes — replaces the numpy gather +
// 16-pass shift/or loop on 4M-row whitelists.
extern "C" void bc_encode_block(const uint8_t *data, int64_t n,
                                int64_t stride, uint32_t *out) {
    uint8_t lut[256];
    memset(lut, 0, sizeof lut);
    const char *b = "ACGTacgt";
    for (int i = 0; i < 8; i++) lut[(uint8_t)b[i]] = (uint8_t)(i & 3);
    for (int64_t r = 0; r < n; r++) {
        const uint8_t *p = data + r * stride;
        uint32_t v = 0;
        for (int i = 0; i < 16; i++) v = (v << 2) | lut[p[i]];
        out[r] = v;
    }
}

// Greedy min-heap bucket assignment (correct.cc:389-412): buckets are file
// indices 1..n_buckets (0 is ema-nobc); the priority queue orders by
// (current size, file index) and each barcode — visited in map-iteration
// order, i.e. sizes[] must already be in that order — goes to the top.
extern "C" void bucket_assign_pq(const int64_t *sizes, int64_t n,
                                 int32_t n_buckets, int32_t *out_bucket) {
    typedef std::pair<int64_t, int32_t> SB;
    std::priority_queue<SB, std::vector<SB>, std::greater<SB> > pq;
    for (int32_t i = 0; i < n_buckets; i++)
        pq.push(SB(0, i + 1));
    for (int64_t i = 0; i < n; i++) {
        SB top = pq.top();
        pq.pop();
        out_bucket[i] = top.second;
        top.first += sizes[i];
        pq.push(top);
    }
}

// ---------------------------------------------------------------------------
// Banded SW scoring on host (threaded vector-friendly DP)
// ---------------------------------------------------------------------------
// Same recurrences, outputs, and tie rules as ops/sw.sw_score_banded (the
// XLA kernel; see its docstring) — asserted bit-for-bit in
// tests/test_sw_banded.py.  CPU-path scorer (the TPU path keeps the
// Pallas kernel): each row runs as four stripes so gcc auto-vectorizes
// everything except one short scalar scan —
//   1. elementwise diag/vertical + packed scan keys (a<<9|k: on value
//      ties the larger k wins the prefix max == the NEAREST horizontal
//      gap source, the kernels' tie rule),
//   2. a serial prefix-max scan with twin cmov chains (value + start),
//   3. an elementwise branch-free merge (diag >= E >= F priority); the
//      fresh F/SF rows become next row's state by pointer swap,
//   4. a vector max-reduce + first-index row-best search.
// Every captured scalar is copied to a local first: reference captures
// may alias the int32 state arrays and would block vectorization (3x
// measured).  Windows are gathered straight from the packed text with
// out-of-text columns read as sentinel 5 (ops/chaining.py lets window
// lo go negative at contig starts).

namespace swb {

constexpr int32_t NEGS = -(1 << 28);

// clamp floor for scan-key packing: far below any reachable score (every
// H cell is >= fresh + sub >= -clip - mismatch after row 1), far above
// INT32_MIN >> 9 so (a << 9) cannot overflow
constexpr int32_t PLOW = -(1 << 21);

}  // namespace swb

extern "C" void sw_banded_native_scalar(
    const uint8_t *oriented, int64_t L, const int32_t *olens,
    const uint8_t *text, int64_t text_n,
    const int64_t *owners, const int64_t *win_lo, const int32_t *win_len,
    int64_t N, int32_t W,
    int32_t match, int32_t mismatch, int32_t gap_open, int32_t gap_extend,
    int32_t clip,
    int32_t *out_score, int32_t *out_qb, int32_t *out_qe,
    int32_t *out_ref_end, int32_t n_threads,
    const int32_t *wl /* per-candidate logical corridor; NULL = W */) {
    const int32_t NEGS = swb::NEGS;
    const int32_t goe = gap_open + gap_extend;

    auto run = [&](int64_t s, int64_t e) {
        // copy every captured scalar to a local: reference captures can
        // alias the int32 state arrays and block vectorization
        const int64_t Lc = L, text_nc = text_n;
        const int32_t Wc = W, matchc = match, mismatchc = mismatch;
        const int32_t gap_openc = gap_open, gap_extendc = gap_extend;
        const int32_t clipc = clip, goec = goe;
        const uint8_t *__restrict orientedc = oriented;
        const uint8_t *__restrict textc = text;
        const int32_t *__restrict olensc = olens;
        const int64_t *__restrict ownersc = owners;
        const int64_t *__restrict win_loc = win_lo;
        const int32_t *__restrict win_lenc = win_len;
        const int32_t *__restrict wlc = wl;
        std::vector<int32_t> HP(Wc + 2, NEGS), FP(Wc + 2, NEGS);
        std::vector<int32_t> SHP(Wc + 2, 0), SFP(Wc + 2, 0);
        std::vector<int32_t> HD(Wc + 1), SD(Wc + 1);
        std::vector<int32_t> FV(Wc + 2, NEGS), SF(Wc + 2, 0);
        std::vector<int32_t> S0(Wc + 1), AK(Wc + 1), PMV(Wc + 1), PMS(Wc + 1);
        std::vector<int32_t> CAND(Wc + 1);
        std::vector<uint8_t> wref;
        for (int64_t c = s; c < e; c++) {
            const uint8_t *__restrict read = orientedc + ownersc[c] * Lc;
            const int32_t rl = olensc[ownersc[c]];
            const int64_t lo = win_loc[c];
            const int32_t nl = win_lenc[c];
            const int32_t Wb = (wlc && wlc[c] < Wc) ? wlc[c] : Wc;
            wref.resize((size_t)nl);
            {
                int64_t a = lo < 0 ? 0 : lo;
                int64_t b = lo + nl; if (b > text_nc) b = text_nc;
                memset(wref.data(), 5, (size_t)nl);
                if (b > a) memcpy(wref.data() + (a - lo), textc + a, (size_t)(b - a));
            }
            std::fill(HP.begin(), HP.end(), NEGS);
            std::fill(FP.begin(), FP.end(), NEGS);
            std::fill(SHP.begin(), SHP.end(), 0);
            std::fill(SFP.begin(), SFP.end(), 0);
            std::fill(FV.begin(), FV.end(), NEGS);
            std::fill(SF.begin(), SF.end(), 0);

            int32_t bv = NEGS, bd = 0, bi = 0, bs = 0, bk = 0;
            int32_t prev_kmax = Wb;
            int32_t *__restrict hp = HP.data(), *__restrict fp = FP.data();
            int32_t *__restrict shp = SHP.data(), *__restrict sfp = SFP.data();
            int32_t *__restrict hd = HD.data(), *__restrict sd = SD.data();
            int32_t *__restrict fv = FV.data(), *__restrict sf = SF.data();
            int32_t *__restrict s0 = S0.data(), *__restrict ak = AK.data();
            int32_t *__restrict pmv = PMV.data(), *__restrict pms = PMS.data();
            int32_t *__restrict cand = CAND.data();

            for (int32_t i = 1; i <= rl; i++) {
                const int32_t rc = read[i - 1];
                const int32_t fresh = (i == 1) ? 0 : -clipc;
                const int32_t end_adj = (i == rl) ? 0 : -clipc;
                const int32_t fresh_s = i - 1;
                int32_t kmax = nl - i < Wb - 1 ? nl - i : Wb - 1;
                if (kmax < -1) kmax = -1;
                const uint8_t *__restrict wrow = wref.data() + (i - 1);
                const int32_t kn = kmax + 1;

                // pass 1: elementwise, all i32, branch-free
                for (int32_t k = 0; k < kn; k++) {
                    const int32_t fc = wrow[k];
                    const int32_t sub = (rc >= 4 || fc >= 4) ? -1
                        : (rc == fc ? matchc : -mismatchc);
                    const int32_t ph = hp[k];
                    const int32_t hdv = (ph >= fresh ? ph : fresh) + sub;
                    const int32_t sdv = ph >= fresh ? shp[k] : fresh_s;
                    const int32_t fo = hp[k + 1] - goec;
                    const int32_t fe = fp[k + 1] - gap_extendc;
                    const int32_t f = fo >= fe ? fo : fe;
                    const int32_t sfv = fo >= fe ? shp[k + 1] : sfp[k + 1];
                    hd[k] = hdv; sd[k] = sdv; fv[k] = f; sf[k] = sfv;
                    const int32_t h0v = hdv >= f ? hdv : f;
                    s0[k] = hdv >= f ? sdv : sfv;
                    int32_t a = h0v + k * gap_extendc;
                    a = a < swb::PLOW ? swb::PLOW : a;
                    // ties prefer larger k == nearest source (low 9 bits)
                    ak[k] = (a << 9) | k;
                }
                // serial scan: twin cmov chains (value+start)
                {
                    int32_t P = INT32_MIN, PS = 0;
                    for (int32_t k = 0; k < kn; k++) {
                        const int32_t a = ak[k];
                        const int32_t sv = s0[k];
                        const bool up = a >= P;
                        P = up ? a : P;
                        PS = up ? sv : PS;
                        pmv[k] = P; pms[k] = PS;
                    }
                }
                // merge: elementwise, branch-free; new F/SF rows become
                // fp/sfp by pointer swap below (no copy-through stores)
                for (int32_t k = 0; k < kn; k++) {
                    const int32_t P = pmv[k] >> 9;
                    const int32_t Ev = P - k * gap_extendc - gap_openc;
                    const int32_t hdv = hd[k];
                    const int32_t f = fv[k];
                    const int32_t ef = Ev >= f ? Ev : f;
                    const int32_t sef = Ev >= f ? pms[k] : sf[k];
                    const int32_t h = hdv >= ef ? hdv : ef;
                    const int32_t sh = hdv >= ef ? sd[k] : sef;
                    hp[k] = h; shp[k] = sh;
                }
                { int32_t *t = fp; fp = fv; fv = t; }
                { int32_t *t = sfp; sfp = sf; sf = t; }
                // row best: vector max-reduce, then first index
                if (kn > 0) {
                    const int32_t *__restrict cand = hp;
                    int32_t m = INT32_MIN;
                    for (int32_t k = 0; k < kn; k++) m = cand[k] > m ? cand[k] : m;
                    int32_t rbk = 0;
                    for (int32_t k = 0; k < kn; k++) if (cand[k] == m) { rbk = k; break; }
                    const int32_t rbv = m + end_adj;
                    const int32_t rbs = shp[rbk];
                    if (rbv > bv
                        || (rbv == bv && (2 * i + rbk < bd
                            || (2 * i + rbk == bd && i < bi)))) {
                        bv = rbv; bd = 2 * i + rbk; bi = i; bs = rbs; bk = rbk;
                    }
                }
                for (int32_t k = kn > 0 ? kn : 0;
                     k <= prev_kmax + 1 && k <= Wb + 1; k++) {
                    hp[k] = NEGS; fp[k] = NEGS; shp[k] = 0; sfp[k] = 0;
                }
                prev_kmax = kmax;
            }
            out_score[c] = bv; out_qb[c] = bs; out_qe[c] = bi;
            out_ref_end[c] = bi + bk;
        }
    };
    if (n_threads <= 1 || N < 2 * n_threads) { run(0, N); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (N + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        int64_t s = t * chunk, e = std::min(N, s + chunk);
        if (s >= e) break;
        ts.emplace_back(run, s, e);
    }
    for (auto &t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Barcode-correction neighbor scans (preproc/correct.py hot path)
// ---------------------------------------------------------------------------
// Native equivalents of Corrector._h1_neighbors/_h2_neighbors +
// _reduce_neighbors (see their docstrings for the reference citations,
// correct.cc:66-188).  The numpy path materializes [M, 1920] neighbor /
// prior / validity arrays and binary-searches a 4M-entry whitelist per
// neighbor; here each candidate's neighbors are enumerated in registers
// and probed against an open-addressing hash table (~1 cache miss per
// probe), threaded over candidates.  Enumeration order, the
// strictly-greater best update (numpy argmax first-max), and sequential
// f64 accumulation match the reference semantics; the numpy path remains
// as a cross-checked fallback (tests compare both).
//
// Empty slot sentinel is barcode 0 (AAA...A), which the whitelist loader
// rejects as invalid (count.py load_whitelist_file_order).

static inline uint32_t bc_hash_mix(uint32_t k) {
    // murmur3 finalizer: whitelists are structured; identity hashing
    // would cluster linear probes
    k ^= k >> 16; k *= 0x85ebca6bu; k ^= k >> 13; k *= 0xc2b2ae35u;
    k ^= k >> 16;
    return k;
}

extern "C" void bc_hash_build(const uint32_t *keys, const double *vals,
                              int64_t n, uint32_t *slots, double *svals,
                              int64_t S) {
    const uint32_t mask = (uint32_t)(S - 1);
    memset(slots, 0, (size_t)S * sizeof(uint32_t));
    for (int64_t i = 0; i < n; i++) {
        const uint32_t k = keys[i];
        uint32_t h = bc_hash_mix(k) & mask;
        while (slots[h] != 0 && slots[h] != k) h = (h + 1) & mask;
        slots[h] = k;
        svals[h] = vals[i];
    }
}

static inline double bc_hash_get(const uint32_t *slots, const double *svals,
                                 uint32_t mask, uint32_t k) {
    // Key 0 (all-A barcode) is the empty-slot sentinel and is never a
    // valid whitelist key; without this guard a k==0 probe would match
    // the first empty slot (s == k) and report a bogus HIT with an
    // uninitialized prior, diverging from the numpy fallback.
    if (k == 0) return -1.0;
    uint32_t h = bc_hash_mix(k) & mask;
    for (;;) {
        const uint32_t s = slots[h];
        if (s == k) return svals[h];
        if (s == 0) return -1.0;
        h = (h + 1) & mask;
    }
}

extern "C" void bc_hash_probe(const uint32_t *bcs, int64_t m,
                              const uint32_t *slots, const double *svals,
                              int64_t S, double *out, int32_t n_threads) {
    const uint32_t mask = (uint32_t)(S - 1);
    auto run = [&](int64_t s, int64_t e) {
        for (int64_t i = s; i < e; i++)
            out[i] = bc_hash_get(slots, svals, mask, bcs[i]);
    };
    if (n_threads <= 1 || m < 1 << 16) { run(0, m); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (m + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        int64_t s = t * chunk, e = std::min(m, s + chunk);
        if (s >= e) break;
        ts.emplace_back(run, s, e);
    }
    for (auto &t : ts) t.join();
}

// H1 / N-position scan, one row per miss candidate: neighbors enumerated
// position-major then substitute (i outer 0..15, j inner 0..3), matching
// _h1_neighbors' reshape order.
extern "C" void bc_h1_scan(const uint8_t *codes, const uint8_t *quals,
                           const uint8_t *pos_ok, const uint8_t *has_n,
                           int64_t M,
                           const uint32_t *slots, const double *svals,
                           int64_t S, const double *phred,
                           double *total, double *best_p,
                           uint32_t *best_bc, int32_t n_threads) {
    const uint32_t mask = (uint32_t)(S - 1);
    auto run = [&](int64_t s, int64_t e) {
        for (int64_t r = s; r < e; r++) {
            const uint8_t *c = codes + r * 16;
            const uint8_t *q = quals + r * 16;
            const uint8_t *po = pos_ok + r * 16;
            const int hn = has_n[r];
            uint32_t base = 0;
            for (int i = 0; i < 16; i++)
                base = (base << 2) | (uint32_t)(c[i] == 4 ? 0 : c[i]);
            double tot = 0.0, bp = 0.0;
            // numpy argmax returns index 0 on an all-zero row: nb[0] is
            // the (i=0, j=0) neighbor
            uint32_t bbc = base & ~(3u << 30);
            for (int i = 0; i < 16; i++) {
                if (!po[i]) continue;
                const int shift = 2 * (15 - i);
                const uint32_t cleared = base & ~(3u << shift);
                const double ph = phred[q[i] < 127 ? q[i] : 127];
                for (uint32_t j = 0; j < 4; j++) {
                    if (!hn && j == (uint32_t)c[i]) continue;
                    const uint32_t nb = cleared | (j << shift);
                    const double pr = bc_hash_get(slots, svals, mask, nb);
                    if (pr < 0.0) continue;
                    const double p = pr * ph;
                    tot += p;
                    if (p > bp) { bp = p; bbc = nb; }
                }
            }
            total[r] = tot;
            best_p[r] = bp;
            best_bc[r] = bbc;
        }
    };
    if (n_threads <= 1 || M < 256) { run(0, M); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (M + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        int64_t s = t * chunk, e = std::min(M, s + chunk);
        if (s >= e) break;
        ts.emplace_back(run, s, e);
    }
    for (auto &t : ts) t.join();
}

// H2 scan, one row per exact-hit candidate: pairs (i1 < i2) lexicographic,
// then j1 outer, j2 inner — _h2_neighbors' [M, P, 4, 4] reshape order.
// Quality weighting phred(max(q-1, 3)) per changed position
// (correct.cc:121-122).
extern "C" void bc_h2_scan(const uint8_t *codes, const uint8_t *quals,
                           int64_t M,
                           const uint32_t *slots, const double *svals,
                           int64_t S, const double *phred,
                           double *total, double *best_p,
                           uint32_t *best_bc, int32_t n_threads) {
    const uint32_t mask = (uint32_t)(S - 1);
    auto run = [&](int64_t s, int64_t e) {
        for (int64_t r = s; r < e; r++) {
            const uint8_t *c = codes + r * 16;
            const uint8_t *q = quals + r * 16;
            uint32_t base = 0;
            double pq[16];
            for (int i = 0; i < 16; i++) {
                base = (base << 2) | (uint32_t)(c[i] == 4 ? 0 : c[i]);
                int qi = q[i] - 1;
                if (qi < 3) qi = 3;
                pq[i] = phred[qi < 127 ? qi : 127];
            }
            double tot = 0.0, bp = 0.0;
            // nb[0] = pair (0,1), j1=0, j2=0
            uint32_t bbc = base & ~(3u << 30) & ~(3u << 28);
            for (int i1 = 0; i1 < 15; i1++) {
                const int sh1 = 2 * (15 - i1);
                const uint32_t cl1 = base & ~(3u << sh1);
                for (int i2 = i1 + 1; i2 < 16; i2++) {
                    const int sh2 = 2 * (15 - i2);
                    const uint32_t cl12 = cl1 & ~(3u << sh2);
                    const double w = pq[i1] * pq[i2];
                    for (uint32_t j1 = 0; j1 < 4; j1++) {
                        if (j1 == (uint32_t)c[i1]) continue;
                        const uint32_t nb1 = cl12 | (j1 << sh1);
                        for (uint32_t j2 = 0; j2 < 4; j2++) {
                            if (j2 == (uint32_t)c[i2]) continue;
                            const uint32_t nb = nb1 | (j2 << sh2);
                            const double pr =
                                bc_hash_get(slots, svals, mask, nb);
                            if (pr < 0.0) continue;
                            const double p = pr * w;
                            tot += p;
                            if (p > bp) { bp = p; bbc = nb; }
                        }
                    }
                }
            }
            total[r] = tot;
            best_p[r] = bp;
            best_bc[r] = bbc;
        }
    };
    if (n_threads <= 1 || M < 256) { run(0, M); return; }
    std::vector<std::thread> ts;
    int64_t chunk = (M + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        int64_t s = t * chunk, e = std::min(M, s + chunk);
        if (s >= e) break;
        ts.emplace_back(run, s, e);
    }
    for (auto &t : ts) t.join();
}

#if defined(__AVX512F__)
#include <immintrin.h>
// ---------------------------------------------------------------------------
// AVX-512 inter-candidate SIMD variant: 16 candidates per vector lane,
// serial (i, k) loops running the scalar recurrence per lane — no
// prefix scan at all, M/MS and the best trackers live in registers.
// Bit-exact vs sw_banded_native_scalar and the XLA kernel (asserted in
// tests/test_sw_banded.py); ~9x the striped scalar kernel per core.
// ---------------------------------------------------------------------------
namespace swb { constexpr int LN = 16; }
using swb::LN;
extern "C" void sw_banded_native_simd(
    const uint8_t *oriented, int64_t L, const int32_t *olens,
    const uint8_t *text, int64_t text_n,
    const int64_t *owners, const int64_t *win_lo, const int32_t *win_len,
    int64_t N, int32_t W,
    int32_t match, int32_t mismatch, int32_t gap_open, int32_t gap_extend,
    int32_t clip,
    int32_t *out_score, int32_t *out_qb, int32_t *out_qe,
    int32_t *out_ref_end, int32_t n_threads,
    const int32_t *wl /* per-candidate logical corridor; NULL = W */) {

    auto run = [&](int64_t blk_s, int64_t blk_e) {
        const int64_t Lc = L, text_nc = text_n;
        const int32_t Wc = W;
        const __m512i vneg = _mm512_set1_epi32(swb::NEGS);
        const __m512i vzero = _mm512_setzero_si512();
        const __m512i vfour = _mm512_set1_epi32(4);
        const __m512i vmatch = _mm512_set1_epi32(match);
        const __m512i vmism = _mm512_set1_epi32(-mismatch);
        const __m512i vneg1 = _mm512_set1_epi32(-1);
        const __m512i vgoe = _mm512_set1_epi32(gap_open + gap_extend);
        const __m512i vge = _mm512_set1_epi32(gap_extend);
        const __m512i vgo = _mm512_set1_epi32(gap_open);
        const uint8_t *__restrict orientedc = oriented;
        const uint8_t *__restrict textc = text;

        std::vector<uint8_t> readT, wrefT;
        std::vector<int32_t> st((size_t)(Wc + 2) * LN * 4 + 64);
        alignas(64) int32_t rlv[LN], nlv[LN], wlv[LN];

        for (int64_t b0 = blk_s; b0 < blk_e; b0 += LN) {
            const int nb = (int)std::min<int64_t>(LN, blk_e - b0);
            int32_t m_max = 0, nl_max = 0, Wg = 1;
            for (int l = 0; l < LN; l++) {
                const int64_t c = b0 + (l < nb ? l : 0);
                rlv[l] = l < nb ? olens[owners[c]] : 0;
                nlv[l] = l < nb ? win_len[c] : 0;
                wlv[l] = (l < nb && wl && wl[c] < Wc) ? wl[c] : Wc;
                if (l >= nb) wlv[l] = 0;
                m_max = std::max(m_max, rlv[l]);
                nl_max = std::max(nl_max, nlv[l]);
                Wg = std::max(Wg, wlv[l]);
            }
            readT.assign((size_t)m_max * LN, 4);
            const int32_t wrows = std::max(nl_max, m_max - 1 + Wc) + 1;
            wrefT.assign((size_t)wrows * LN, 5);
            for (int l = 0; l < nb; l++) {
                const int64_t c = b0 + l;
                const uint8_t *rd = orientedc + owners[c] * Lc;
                for (int32_t i = 0; i < rlv[l]; i++)
                    readT[(size_t)i * LN + l] = rd[i];
                const int64_t lo = win_lo[c];
                int64_t a = lo < 0 ? 0 : lo;
                int64_t b = lo + nlv[l]; if (b > text_nc) b = text_nc;
                for (int64_t t = a; t < b; t++)
                    wrefT[(size_t)(t - lo) * LN + l] = textc[t];
            }
            // interleaved state rows: [k][4][LN] = Hp, Fp, SHp, SFp
            int32_t *S = st.data();
            for (int32_t k = 0; k <= Wc + 1; k++) {
                int32_t *row = S + (size_t)k * 4 * LN;
                for (int l = 0; l < LN; l++) {
                    row[l] = swb::NEGS; row[LN + l] = swb::NEGS;
                    row[2 * LN + l] = 0; row[3 * LN + l] = 0;
                }
            }
            const __m512i vrl = _mm512_load_si512(rlv);
            const __m512i vnl = _mm512_load_si512(nlv);
            const __m512i vwl = _mm512_load_si512(wlv);

            __m512i bv = vneg, bd = vzero, bi = vzero, bs = vzero,
                    bk = vzero;

            for (int32_t i = 1; i <= m_max; i++) {
                const __m512i vi = _mm512_set1_epi32(i);
                const __m512i vfresh = _mm512_set1_epi32(i == 1 ? 0 : -clip);
                const __m512i vfresh_s = _mm512_set1_epi32(i - 1);
                const __mmask16 ivalid =
                    _mm512_cmple_epi32_mask(vi, vrl);
                const __m512i vend_adj = _mm512_mask_mov_epi32(
                    _mm512_set1_epi32(-clip),
                    _mm512_cmpeq_epi32_mask(vi, vrl), vzero);
                const __m512i vkmax = _mm512_min_epi32(
                    _mm512_sub_epi32(vnl, vi),
                    _mm512_sub_epi32(vwl, _mm512_set1_epi32(1)));
                const __m128i rbytes = _mm_loadu_si128(
                    (const __m128i *)(readT.data() + (size_t)(i - 1) * LN));
                const __m512i rcv = _mm512_cvtepu8_epi32(rbytes);
                const __mmask16 rcn =
                    _mm512_cmpge_epi32_mask(rcv, vfour);

                __m512i M = vneg, MS = vzero;
                __m512i rbv = vneg, rbk = vzero, rbs = vzero;
                __m512i kge = vzero;            // k * ge

                int32_t *row0 = S;
                __m512i HK = _mm512_loadu_si512(row0);
                __m512i SHK = _mm512_loadu_si512(row0 + 2 * LN);
                const uint8_t *wbase = wrefT.data() + (size_t)(i - 1) * LN;

                for (int32_t k = 0; k < Wg; k++) {
                    int32_t *rowk = S + (size_t)k * 4 * LN;
                    int32_t *rowk1 = rowk + 4 * LN;
                    const __m512i HK1 = _mm512_loadu_si512(rowk1);
                    const __m512i FK1 = _mm512_loadu_si512(rowk1 + LN);
                    const __m512i SHK1 = _mm512_loadu_si512(rowk1 + 2 * LN);
                    const __m512i SFK1 = _mm512_loadu_si512(rowk1 + 3 * LN);
                    const __m512i wcv = _mm512_cvtepu8_epi32(
                        _mm_loadu_si128(
                            (const __m128i *)(wbase + (size_t)k * LN)));

                    // sub
                    const __mmask16 anyn = rcn | _mm512_cmpge_epi32_mask(
                        wcv, vfour);
                    const __mmask16 eq =
                        _mm512_cmpeq_epi32_mask(rcv, wcv);
                    __m512i sub = _mm512_mask_mov_epi32(vmism, eq, vmatch);
                    sub = _mm512_mask_mov_epi32(sub, anyn, vneg1);

                    // diag
                    const __mmask16 phge =
                        _mm512_cmpge_epi32_mask(HK, vfresh);
                    const __m512i hdv = _mm512_add_epi32(
                        _mm512_max_epi32(HK, vfresh), sub);
                    const __m512i sdv =
                        _mm512_mask_mov_epi32(vfresh_s, phge, SHK);

                    // vertical
                    const __m512i fo = _mm512_sub_epi32(HK1, vgoe);
                    const __m512i fe = _mm512_sub_epi32(FK1, vge);
                    const __mmask16 foge = _mm512_cmpge_epi32_mask(fo, fe);
                    const __m512i f = _mm512_max_epi32(fo, fe);
                    const __m512i sfv =
                        _mm512_mask_mov_epi32(SFK1, foge, SHK1);

                    const __mmask16 h0d = _mm512_cmpge_epi32_mask(hdv, f);
                    const __m512i h0 = _mm512_max_epi32(hdv, f);
                    const __m512i s0 = _mm512_mask_mov_epi32(sfv, h0d, sdv);

                    // horizontal from the running max
                    const __m512i Ev = _mm512_sub_epi32(
                        _mm512_sub_epi32(M, kge), vgo);
                    const __mmask16 evf = _mm512_cmpge_epi32_mask(Ev, f);
                    const __m512i ef = _mm512_max_epi32(Ev, f);
                    const __m512i sef = _mm512_mask_mov_epi32(sfv, evf, MS);
                    const __mmask16 hde = _mm512_cmpge_epi32_mask(hdv, ef);
                    __m512i h = _mm512_max_epi32(hdv, ef);
                    __m512i sh = _mm512_mask_mov_epi32(sef, hde, sdv);

                    const __mmask16 valid = ivalid
                        & _mm512_cmple_epi32_mask(
                              _mm512_set1_epi32(k), vkmax);
                    h = _mm512_mask_mov_epi32(vneg, valid, h);
                    const __m512i fm = _mm512_mask_mov_epi32(vneg, valid, f);

                    _mm512_storeu_si512(rowk, h);
                    _mm512_storeu_si512(rowk + LN, fm);
                    _mm512_storeu_si512(rowk + 2 * LN, sh);
                    _mm512_storeu_si512(rowk + 3 * LN, sfv);

                    // running horizontal-gap max (>=: nearest source wins)
                    const __m512i A = _mm512_mask_mov_epi32(
                        vneg, valid, _mm512_add_epi32(h0, kge));
                    const __mmask16 up = _mm512_cmpge_epi32_mask(A, M);
                    M = _mm512_mask_mov_epi32(M, up, A);
                    MS = _mm512_mask_mov_epi32(MS, up, s0);

                    // row best (strict >: smallest k wins ties)
                    const __m512i cand = _mm512_mask_mov_epi32(
                        vneg, valid, _mm512_add_epi32(h, vend_adj));
                    const __mmask16 bu =
                        _mm512_cmpgt_epi32_mask(cand, rbv);
                    rbv = _mm512_mask_mov_epi32(rbv, bu, cand);
                    rbk = _mm512_mask_mov_epi32(rbk, bu,
                                                _mm512_set1_epi32(k));
                    rbs = _mm512_mask_mov_epi32(rbs, bu, sh);

                    HK = HK1; SHK = SHK1;
                    kge = _mm512_add_epi32(kge, vge);
                }
                // clear the k == Wg boundary row the next row reads at k+1
                {
                    int32_t *rowW = S + (size_t)Wg * 4 * LN;
                    _mm512_storeu_si512(rowW, vneg);
                    _mm512_storeu_si512(rowW + LN, vneg);
                    _mm512_storeu_si512(rowW + 2 * LN, vzero);
                    _mm512_storeu_si512(rowW + 3 * LN, vzero);
                }

                // row merge: score desc, then d = 2i + k asc, then i asc
                const __m512i rd = _mm512_add_epi32(
                    _mm512_add_epi32(vi, vi), rbk);
                const __mmask16 gt = _mm512_cmpgt_epi32_mask(rbv, bv);
                const __mmask16 eqv = _mm512_cmpeq_epi32_mask(rbv, bv);
                const __mmask16 dlt = _mm512_cmplt_epi32_mask(rd, bd);
                const __mmask16 deq = _mm512_cmpeq_epi32_mask(rd, bd);
                const __mmask16 ilt = _mm512_cmplt_epi32_mask(vi, bi);
                const __mmask16 better =
                    gt | (eqv & (dlt | (deq & ilt)));
                bv = _mm512_mask_mov_epi32(bv, better, rbv);
                bd = _mm512_mask_mov_epi32(bd, better, rd);
                bi = _mm512_mask_mov_epi32(bi, better, vi);
                bs = _mm512_mask_mov_epi32(bs, better, rbs);
                bk = _mm512_mask_mov_epi32(bk, better, rbk);
            }

            alignas(64) int32_t obv[LN], obs[LN], obi[LN], obk[LN];
            _mm512_store_si512(obv, bv);
            _mm512_store_si512(obs, bs);
            _mm512_store_si512(obi, bi);
            _mm512_store_si512(obk, bk);
            for (int l = 0; l < nb; l++) {
                const int64_t c = b0 + l;
                out_score[c] = obv[l];
                out_qb[c] = obs[l];
                out_qe[c] = obi[l];
                out_ref_end[c] = obi[l] + obk[l];
            }
        }
    };

    if (n_threads <= 1 || N < 2 * (int64_t)n_threads * LN) {
        run(0, N);
        return;
    }
    std::vector<std::thread> ts;
    int64_t nblk = (N + LN - 1) / LN;
    int64_t per = (nblk + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        int64_t s = t * per * LN, e = std::min<int64_t>(N, (t + 1) * per * LN);
        if (s >= e) break;
        ts.emplace_back(run, s, e);
    }
    for (auto &t : ts) t.join();
}
#endif  // __AVX512F__

// dispatch: SIMD where compiled in (the .so builds with -march=native
// on the machine that runs it), scalar otherwise or when
// EMA_TPU_SW_NATIVE_SCALAR=1
extern "C" void sw_banded_native(
    const uint8_t *oriented, int64_t L, const int32_t *olens,
    const uint8_t *text, int64_t text_n,
    const int64_t *owners, const int64_t *win_lo, const int32_t *win_len,
    int64_t N, int32_t W,
    int32_t match, int32_t mismatch, int32_t gap_open, int32_t gap_extend,
    int32_t clip,
    int32_t *out_score, int32_t *out_qb, int32_t *out_qe,
    int32_t *out_ref_end, int32_t n_threads,
    const int32_t *wl /* per-candidate logical corridor; NULL = W */) {
#if defined(__AVX512F__)
    static const bool force_scalar = [] {
        const char *e = getenv("EMA_TPU_SW_NATIVE_SCALAR");
        return e && (*e == '1' || *e == 't' || *e == 'y');
    }();
    if (!force_scalar) {
        sw_banded_native_simd(oriented, L, olens, text, text_n, owners,
                              win_lo, win_len, N, W, match, mismatch,
                              gap_open, gap_extend, clip, out_score,
                              out_qb, out_qe, out_ref_end, n_threads, wl);
        return;
    }
#endif
    sw_banded_native_scalar(oriented, L, olens, text, text_n, owners,
                            win_lo, win_len, N, W, match, mismatch,
                            gap_open, gap_extend, clip, out_score,
                            out_qb, out_qe, out_ref_end, n_threads, wl);
}

// ---------------------------------------------------------------------------
// BWA index import: rank-sampled .sa -> our value-sampled locate structure.
//
// The reference loads a prebuilt BWA FM-index directly (bwa_idx_load,
// reference src/bwabridge.c:77-96).  Our occ layout is converted from the
// .bwt file in numpy (index/bwa_import.py); this kernel converts BWA's
// rank-space sampled suffix array (.sa stores SA[k*intv]) into the rows
// whose SA VALUE is divisible by sa_rate — the structure our fixed-trip
// device locate needs (index/build.py).
//
// Method: the LF map over the n2+1 BWT rows is a single cycle (one
// sentinel).  Walking LF from every sampled row until the next sampled row
// partitions the cycle exactly, so the total work is n2+1 LF steps and
// every (row, value) pair is visited exactly once.  Segments are
// independent; CH of them are interleaved round-robin so the random
// occ-block loads overlap (memory-level parallelism) instead of forming
// one dependent chain.

// prefix masks for a 128-base block viewed as 4 u64 words: row off ->
// 2*off one-bits from the LSB (4 KB, cache-resident across the walk)
static const uint64_t *lf_prefix_masks() {
    static uint64_t m[128][4];
    static bool init = false;
    if (!init) {
        for (int off = 0; off < 128; off++) {
            int nb = off;
            for (int w = 0; w < 4; w++) {
                int take = nb > 32 ? 32 : nb;
                m[off][w] = take >= 32 ? ~0ull
                                       : ((1ull << (2 * take)) - 1ull);
                nb -= take;
                if (nb < 0) nb = 0;
            }
        }
        init = true;
    }
    return &m[0][0];
}

static inline int32_t lf_step_blocks(const int32_t *blocks,
                                     const int64_t *counts,
                                     int32_t primary, int32_t k,
                                     const uint64_t *masks) {
    if (k == primary) return 0;                 // full-string row -> $ row
    const int32_t adj = k - (k > primary);      // skip the $ row
    const int32_t *row = blocks + (int64_t)(adj >> 7) * 12;
    const uint32_t *words32 = (const uint32_t *)(row + 4);
    const int32_t off = adj & 127;
    const int32_t c = (int32_t)((words32[off >> 4] >> (2 * (off & 15))) & 3u);
    const uint64_t pat = 0x5555555555555555ull * (uint64_t)c;
    const uint64_t *m = masks + 4 * off;
    // branch-free masked popcount over the whole block (the words may be
    // 4-byte aligned only: assemble u64s from u32 pairs)
    int32_t cnt = row[c];
    for (int w = 0; w < 4; w++) {
        uint64_t x = ((uint64_t)words32[2 * w + 1] << 32) | words32[2 * w];
        x ^= pat;
        x = ~(x | (x >> 1)) & 0x5555555555555555ull & m[w];
        cnt += (int32_t)__builtin_popcountll(x);
    }
    return (int32_t)counts[c] + cnt;
}

extern "C" int64_t bwa_sa_import_locate(
    const int32_t *occ_blocks, const int64_t *counts,
    int32_t primary, int64_t n2,
    const int64_t *sa_start_vals /* [n_sa]: SA[k*sa_intv], incl row 0 */,
    int64_t n_sa, int64_t sa_intv, int64_t sa_rate,
    uint32_t *mark_words /* [(n2+32)/32] */,
    int32_t *mark_rank /* same length */,
    int32_t *sa_values /* capacity n2/sa_rate + 1 */) {
    const int CH = 32;
    const uint64_t *masks = lf_prefix_masks();
    const int64_t n_words = (n2 + 1 + 31) / 32;

    // phase 1: segmented LF walk writing SA values densely by row
    // (-1 = unsampled; the bitmap falls out of a sequential scan in
    // phase 2, avoiding a second random read-modify-write stream)
    std::vector<int32_t> val_by_row((size_t)n2 + 1, -1);
    int32_t rows[CH];
    int64_t vals[CH];
    int live[CH];
    int64_t next_seg = 0;
    int n_live = 0;
    for (int i = 0; i < CH; i++) live[i] = 0;

    auto start_chain = [&](int slot) {
        if (next_seg < n_sa) {
            int64_t seg = next_seg++;
            rows[slot] = (int32_t)(seg * sa_intv);
            vals[slot] = sa_start_vals[seg];
            live[slot] = 1;
            n_live++;
        }
    };
    for (int i = 0; i < CH; i++) start_chain(i);

    while (n_live > 0) {
        for (int i = 0; i < CH; i++) {
            if (!live[i]) continue;
            if (vals[i] % sa_rate == 0)
                val_by_row[(size_t)rows[i]] = (int32_t)vals[i];
            int32_t nr = lf_step_blocks(occ_blocks, counts, primary,
                                        rows[i], masks);
            if (nr % sa_intv == 0) {       // next segment's start: done
                live[i] = 0;
                n_live--;
                start_chain(i);
            } else {
                rows[i] = nr;
                vals[i] = vals[i] == 0 ? n2 : vals[i] - 1;
                __builtin_prefetch(
                    occ_blocks +
                    (int64_t)((nr - (nr > primary)) >> 7) * 12, 0, 1);
            }
        }
    }

    // phase 2: one sequential pass builds bitmap words, per-word prefix
    // ranks, and the compacted value array
    int64_t w = 0;
    const int64_t n_rows = n2 + 1;
    for (int64_t wi = 0; wi < n_words; wi++) {
        mark_rank[wi] = (int32_t)w;
        uint32_t bits = 0;
        const int64_t base = wi << 5;
        const int64_t hi = base + 32 < n_rows ? base + 32 : n_rows;
        for (int64_t r = base; r < hi; r++) {
            int32_t v = val_by_row[(size_t)r];
            if (v >= 0) {
                bits |= 1u << (r & 31);
                sa_values[w++] = v;
            }
        }
        mark_words[wi] = bits;
    }
    return w;
}
