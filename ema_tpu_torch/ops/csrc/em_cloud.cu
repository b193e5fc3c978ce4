// The cloud EM of every barcode group of one dispatch in one launch, for
// Hopper (sm_90a).  Built by ema_tpu_torch/ops/_build.py with nvcc into a
// shared library with a plain C interface, called through ctypes (wrapper:
// ema_tpu_torch/ops/em_cloud.py; the flat pack and the plain version:
// ema_tpu_torch/core/em.py, ``pack_states`` and ``em_run_flat``).
//
// Replaces no Pallas kernel: the JAX package runs its EM as XLA ops
// (ema_tpu/core/em_jax.py).  On the card it replaces the port's eager
// chain of core/em.em_run (about 35 torch ops a phase, 5 iterations x 2
// phases, each launch a host dispatch on the main thread) and its
// sort-based scatter-sum (core/em._scatter_sum, index_put_ with
// accumulate) with one launch.
//
// The mathematics is em_run's (the reference's align.c:431-543), in
// float64 throughout:
//   - init: each entry's gammas are normalize_log_probs of its scores (max
//     shift, the log(1e-50) - log(n) floor, exactly 1.0 for an entry of
//     one candidate; src/util.c:129-163), and the weights are the cloud
//     weights of those gammas over every candidate;
//   - each iteration updates phase A (unpaired entries and the later-
//     inserted mate of a pair) then phase B (the earlier-inserted mate,
//     which sees A's new gammas): new = score + log(cloud weight) + the
//     best mate term, the mate term being 0 inside the insert window and
//     UNPAIRED_PENALTY outside it, plus the log of the mate candidate's
//     gamma, over the mate candidates on the same chromosome, the other
//     strand and the same cloud, floored at UNPAIRED_PENALTY; then the
//     weights of the active candidates;
//   - cloud weights are the sums of gammas per cloud, normalised within
//     each chain (``comp``) or, with ``many`` (the many-clouds platforms),
//     left as they are and normalised per entry when read.
//
// Layout (core/em.pack_states): flat and unpadded, as native em_run_flat
// takes one group.  Group g owns entries [e_off[g], e_off[g+1]) and clouds
// [k_off[g], k_off[g+1]); entry e owns candidates [cand_off[e],
// cand_off[e+1]).  mate and comp are local to their group.  Two lists in
// CSR form give the sums their order: cloud_cands[cloud_cand_off[k] ..]
// are the group-local candidates of cloud k, ascending, and
// comp_clouds[comp_cloud_off[k] ..] the group-local clouds whose chain is
// k, ascending.  Every sum is taken by one thread in that order, with no
// atomics, so two runs give the same bits, and the order is the one in
// which em_run's scatter-sum adds on the CPU.
//
// Design: one block per group.  The group's gammas and its two per-cloud
// planes (sums, then weights; chain totals) live in dynamic shared memory
// when 8 * (candidates + 2 * clouds) bytes fit the launch's size, which
// the wrapper sets to the largest such need of the launch up to 48 KB; a
// larger group keeps its gammas in the output and its cloud planes in a
// scratch of 2 doubles a cloud that the wrapper allocates.  The block's
// threads share out the entries of a phase (a thread updates one entry
// alone, in place: an entry reads only its mate's gammas, and mates are in
// opposite phases) and then the clouds.  The mate term is computed from
// the mate's candidates as they are read: no [E, C, C] plane is built.
//
// What bounds it: not bytes (a bench dispatch moves about 1 MB, 0.3 us at
// 3.35 TB/s) nor float64 operations, but latency: 5 iterations of 4 block
// barriers, each behind one thread's chain of dependent float64 log and
// exp over an entry's candidates, on as many blocks as the dispatch has
// groups (tens, on 132 SMs).

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxSmem = 48 * 1024;   // ops/em_cloud.SMEM_MAX; no opt-in
constexpr double kLogEps = -115.12925464970229;   // log(1e-50)
constexpr uint8_t kRev = 1, kActive = 2;          // flags bits

struct Args {
    const int32_t *e_off, *k_off, *cand_off, *mate;
    const double *score;
    const int32_t *cloud, *chrom;
    const int64_t *pos;
    const uint8_t *flags;
    const int32_t *comp, *cloud_cand_off, *cloud_cands, *comp_cloud_off,
        *comp_clouds;
    double *out, *scratch;
    int32_t many, iters;
    int64_t insert_min, insert_max;
    double penalty;
    int64_t smem_bytes;
};

// normalize_log_probs of p[0, n) in place (em_run's normalize_log_probs,
// native emflat::normalize_log_probs)
__device__ void normalize(double *p, int n) {
    if (n <= 0) return;
    if (n == 1) {
        p[0] = 1.0;
        return;
    }
    double mx = p[0];
    for (int c = 1; c < n; ++c) mx = fmax(mx, p[c]);
    const double thresh = kLogEps - log((double)n);
    double total = 0.0;
    for (int c = 0; c < n; ++c) {
        const double s = p[c] - mx;
        const double v = s >= thresh ? exp(s) : 0.0;
        p[c] = v;
        total += v;
    }
    for (int c = 0; c < n; ++c) p[c] = total > 0 ? p[c] / total : 0.0;
}

// The weights of the group's nk clouds from the gammas of every candidate
// (all) or of the active ones.  Ends with the block synchronised.
__device__ void cloud_weights(const Args &a, const double *gam, double *w,
                              double *tot, int c0, int k0, int nk,
                              bool all) {
    for (int k = threadIdx.x; k < nk; k += kThreads) {
        double acc = 0.0;
        const int j1 = a.cloud_cand_off[k0 + k + 1];
        for (int j = a.cloud_cand_off[k0 + k]; j < j1; ++j) {
            const int i = a.cloud_cands[j];
            if (all || (a.flags[c0 + i] & kActive)) acc += gam[i];
        }
        w[k] = acc;
    }
    __syncthreads();
    if (a.many) return;
    for (int c = threadIdx.x; c < nk; c += kThreads) {
        double acc = 0.0;
        const int j1 = a.comp_cloud_off[k0 + c + 1];
        for (int j = a.comp_cloud_off[k0 + c]; j < j1; ++j)
            acc += w[a.comp_clouds[j]];
        tot[c] = acc;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nk; k += kThreads) {
        const double t = tot[a.comp[k0 + k]];
        if (t > 0) w[k] = w[k] / t;
    }
    __syncthreads();
}

// One entry's new gammas (em_run's _recompute for entry e, global index)
__device__ void update_entry(const Args &a, double *gam, const double *w,
                             int c0, int e0, int e) {
    const int b = a.cand_off[e], n = a.cand_off[e + 1] - b;
    if (n <= 0) return;
    const int m = a.mate[e];
    int mb = 0, me = 0;
    if (m >= 0) {
        mb = a.cand_off[e0 + m];
        me = a.cand_off[e0 + m + 1];
    }
    double wtot = 0.0;
    if (a.many)
        for (int c = 0; c < n; ++c) wtot += w[a.cloud[b + c]];
    double *p = gam + (b - c0);
    for (int c = 0; c < n; ++c) {
        const int i = b + c;
        const int icl = a.cloud[i];
        double wv = w[icl];
        if (a.many) wv = wtot > 0 ? wv / wtot : 0.0;
        const double log_w = log(wv > 0 ? wv : 1e-300);
        double best = a.penalty;
        if (m >= 0) {
            double bm = -INFINITY;
            const int ich = a.chrom[i];
            const bool irv = a.flags[i] & kRev;
            const int64_t ips = a.pos[i];
            for (int j = mb; j < me; ++j) {
                if (a.cloud[j] != icl || a.chrom[j] != ich
                    || bool(a.flags[j] & kRev) == irv)
                    continue;
                const double g = gam[j - c0];
                if (g == 0.0) continue;
                const int64_t d = irv ? ips - a.pos[j] : a.pos[j] - ips;
                const double pen = (d >= a.insert_min && d <= a.insert_max)
                                   ? 0.0 : a.penalty;
                bm = fmax(bm, pen + log(g > 0 ? g : 1.0));
            }
            best = fmax(bm, a.penalty);
        }
        p[c] = (a.score[i] + log_w) + best;
    }
    normalize(p, n);
}

__global__ void __launch_bounds__(kThreads) em_cloud_kernel(const Args a) {
    extern __shared__ double smem[];
    const int g = blockIdx.x;
    const int e0 = a.e_off[g], e1 = a.e_off[g + 1];
    const int k0 = a.k_off[g], nk = a.k_off[g + 1] - k0;
    const int c0 = a.cand_off[e0], nc = a.cand_off[e1] - c0;
    const bool fits = 8 * ((int64_t)nc + 2 * (int64_t)nk) <= a.smem_bytes;
    double *gam = fits ? smem : a.out + c0;
    double *w = fits ? smem + nc : a.scratch + 2 * (int64_t)k0;
    double *tot = w + nk;

    for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
        const int b = a.cand_off[e], n = a.cand_off[e + 1] - b;
        for (int c = 0; c < n; ++c) gam[b - c0 + c] = a.score[b + c];
        normalize(gam + (b - c0), n);
    }
    __syncthreads();
    cloud_weights(a, gam, w, tot, c0, k0, nk, true);
    for (int it = 0; it < a.iters; ++it) {
        for (int phase = 0; phase < 2; ++phase) {
            for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
                const int m = a.mate[e];
                const bool later = m >= 0 && e - e0 < m;   // phase B
                if (later == (phase == 1)) update_entry(a, gam, w, c0, e0, e);
            }
            __syncthreads();
        }
        cloud_weights(a, gam, w, tot, c0, k0, nk, false);
    }
    if (fits)
        for (int i = threadIdx.x; i < nc; i += kThreads) a.out[c0 + i] = gam[i];
}

}  // namespace

extern "C" {

// Runs the EM of G groups laid out as above and writes every candidate's
// gammas to out (float64, flat, in candidate order) on `stream`.  scratch
// holds 2 doubles a cloud of the launch; smem_bytes is the launch's
// dynamic shared memory, at most 48 KB (ops/em_cloud.SMEM_MAX).  Returns the
// launch's cudaGetLastError(); does not synchronise.
int em_cloud_launch(const void *e_off, const void *k_off,
                    const void *cand_off, const void *mate,
                    const void *score, const void *cloud, const void *chrom,
                    const void *pos, const void *flags, const void *comp,
                    const void *cloud_cand_off, const void *cloud_cands,
                    const void *comp_cloud_off, const void *comp_clouds,
                    void *out, void *scratch, int64_t G, int32_t many,
                    int32_t iters, int64_t insert_min, int64_t insert_max,
                    double penalty, int64_t smem_bytes, void *stream) {
    if (G <= 0) return 0;
    if (G > INT32_MAX || smem_bytes < 0 || smem_bytes > kMaxSmem
        || iters < 0)
        return (int)cudaErrorInvalidValue;
    const Args a{static_cast<const int32_t *>(e_off),
                 static_cast<const int32_t *>(k_off),
                 static_cast<const int32_t *>(cand_off),
                 static_cast<const int32_t *>(mate),
                 static_cast<const double *>(score),
                 static_cast<const int32_t *>(cloud),
                 static_cast<const int32_t *>(chrom),
                 static_cast<const int64_t *>(pos),
                 static_cast<const uint8_t *>(flags),
                 static_cast<const int32_t *>(comp),
                 static_cast<const int32_t *>(cloud_cand_off),
                 static_cast<const int32_t *>(cloud_cands),
                 static_cast<const int32_t *>(comp_cloud_off),
                 static_cast<const int32_t *>(comp_clouds),
                 static_cast<double *>(out), static_cast<double *>(scratch),
                 many, iters, insert_min, insert_max, penalty, smem_bytes};
    em_cloud_kernel<<<(unsigned)G, kThreads, (size_t)smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
