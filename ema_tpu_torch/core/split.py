"""Density-based multimapping resolver ("-d": reference src/split.c).

Chooses one active alignment per multi-mapped read inside a bad cloud by
simulated annealing over a read-density objective.  Unlike the reference
(srand(time) — non-deterministic, split.c:54-59), our SA is seeded from
RunConfig.seed.

Implemented in _sa_optimize below; mark_optimal_alignments_in_cloud mutates
R["active"] in place for the given cloud members.
"""

from __future__ import annotations

import numpy as np

from ema_tpu_torch import config


def _log_density_prob(density: int, log_probs) -> float:
    size = len(log_probs)
    if density < 0:     # reference uses unsigned wraparound -> huge penalty
        return -1e18
    if density < size:
        return log_probs[density]
    return log_probs[size - 1] - (density - size + 1) * np.log(2.0)


def mark_optimal_alignments_in_cloud(R: np.ndarray, RI: np.ndarray,
                                     members, profile: config.PlatformProfile,
                                     rng) -> None:
    """Port of split.c:38-338 over sorted-group record indices ``members``.

    ``members`` must be name-sorted (ident, mate) as the caller guarantees
    (align.c:394).
    """
    n_records = len(members)
    if n_records >= 50_000 or n_records <= 5:
        return
    if rng is None:
        rng = np.random.default_rng(0)
    log_probs = profile.log_density_probs

    # group same-(ident, mate) runs; drop records far from best edit dist
    clean: list = []
    i = 0
    while i < n_records:
        j = i + 1
        while (j < n_records and RI[members[j]] == RI[members[i]]
               and R["mate"][members[j]] == R["mate"][members[i]]):
            j += 1
        run = members[i:j]
        if len(run) > 1:
            ceds = [int(R["clip_edit_dist"][k]) for k in run]
            cutoff = min(ceds) + config.SPLIT_EXTRA_SEARCH_DEPTH
            for k, ced in zip(run, ceds):
                if ced <= cutoff:
                    clean.append(k)
                else:
                    R["active"][k] = False
        else:
            clean.append(run[0])
        i = j

    # partition into unique- and multi-mapped reads; find cloud bounds
    n = len(clean)
    umaps: list = []       # global record idx
    umap_local: list = []  # index into ``clean`` of the same record
    mmaps: list = []       # dict(start, n, mate_umap, mate_mmap, active)
    lo, hi = np.iinfo(np.int64).max, 0
    i = 0
    while i < n:
        j = i + 1
        while (j < n and RI[clean[j]] == RI[clean[i]]
               and R["mate"][clean[j]] == R["mate"][clean[i]]):
            j += 1
        run = clean[i:j]
        for k in run:
            p = int(R["pos"][k])
            lo, hi = min(lo, p), max(hi, p)
        if len(run) > 1:
            best = int(np.argmax([R["score"][k] for k in run]))
            mate_umap = mate_mmap = -1
            pair, mate = int(R["pair"][run[0]]), int(R["mate"][run[0]])
            for ui, uk in enumerate(umaps):
                if int(R["pair"][uk]) == pair and int(R["mate"][uk]) == 1 - mate:
                    mate_umap = ui
                    break
            if mate_umap < 0:
                for mi, mm in enumerate(mmaps):
                    k0 = clean[mm["start"]]
                    if int(R["pair"][k0]) == pair and int(R["mate"][k0]) == 1 - mate:
                        mate_mmap = mi
                        mm["mate_mmap"] = len(mmaps)
                        break
            mmaps.append(dict(start=i, n=len(run), mate_umap=mate_umap,
                              mate_mmap=mate_mmap, active=best))
        else:
            for mi, mm in enumerate(mmaps):
                k0 = clean[mm["start"]]
                if (int(R["pair"][k0]) == int(R["pair"][run[0]])
                        and int(R["mate"][k0]) == 1 - int(R["mate"][run[0]])):
                    mm["mate_umap"] = len(umaps)
                    break
            umaps.append(run[0])
            umap_local.append(i)
        i = j

    n_bins = (hi - lo) // config.BIN_SIZE + 1
    if n_bins >= config.MAX_BINS or n <= 5 or not mmaps:
        return

    def bin_of(pos):
        return (int(pos) - lo) // config.BIN_SIZE

    for k in clean:
        R["active"][k] = False

    bins = np.zeros(n_bins + 2, np.int64)
    for uk in umaps:
        bins[bin_of(R["pos"][uk])] += 1
    for mm in mmaps:
        bins[bin_of(R["pos"][clean[mm["start"] + mm["active"]]])] += 1

    # simulated annealing (split.c:223-325): the 50k-iteration loop runs
    # in C++ (native.sa_optimize) over local clean-record arrays — the
    # scalar Python version was ~100x slower than the reference's C loop
    from ema_tpu_torch import native

    cl = np.asarray(clean, np.int64)
    # the reference anneals once from a time-seeded rand() (split.c:54-59,
    # non-deterministic); we run seeded restart chains from the same
    # initial state — in parallel C++ threads — and keep the best-energy
    # final assignment: deterministic, and better than the reference's
    # own compiled annealer on its objective (DENSITY_r03.json).  Small
    # clouds converge to the same optimum every chain, so extra chains
    # are reserved for clouds with enough multimapped reads to have a
    # rugged landscape.
    n_chains = max(1, config.SPLIT_RESTARTS) \
        if len(mmaps) >= config.SPLIT_RESTART_MIN_MMAPS else 1
    seeds = rng.integers(1, np.iinfo(np.int64).max,
                         size=n_chains).astype(np.uint64)
    mm_active, _ = native.sa_optimize_best(
        pos=R["pos"][cl], chrom=R["chrom"][cl], rev=R["rev"][cl],
        score=R["score"][cl],
        umap_local=np.asarray(umap_local, np.int64),
        mm_start=np.array([m["start"] for m in mmaps], np.int64),
        mm_n=np.array([m["n"] for m in mmaps], np.int64),
        mm_mate_umap=np.array([m["mate_umap"] for m in mmaps], np.int64),
        mm_mate_mmap=np.array([m["mate_mmap"] for m in mmaps], np.int64),
        mm_active=np.array([m["active"] for m in mmaps], np.int64),
        bins=bins, lo=int(lo), bin_size=config.BIN_SIZE,
        log_probs=np.asarray(log_probs, np.float64),
        iters=config.SIM_ANNEAL_ITERS,
        tmax_log=config.SIM_ANNEAL_TMAX_LOG,
        tmin_log=config.SIM_ANNEAL_TMIN_LOG,
        max_no_move=config.SIM_ANNEAL_MAX_NO_MOVE,
        score_scale=float(config.SCORE_SCALE),
        insert_min=config.INSERT_MIN, insert_max=config.INSERT_MAX,
        seeds=seeds)

    for uk in umaps:
        R["active"][uk] = True
    for mm, a in zip(mmaps, mm_active):
        R["active"][clean[mm["start"] + int(a)]] = True
