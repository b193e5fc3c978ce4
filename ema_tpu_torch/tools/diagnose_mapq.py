"""Where the mapq spectrum's mass goes: the twin of tools/diagnose_mapq.py.

    python -m ema_tpu_torch.tools.diagnose_mapq [--device cuda|cpu]
        [--genome BP] [--pairs N] [--out FILE]

A record's mapq is min(gamma_mapq, score_mapq, bwa_approx_mapq), clamped
to [0, 60] (core/score.final_mapq, reference samrecord.c:142-148).  On a
world of exact repeat families (seed 2026; 8 Mbp and 20,000 pairs
requested by default, 4 families of 12 copies of len // 2500 bases)
aligned by the port's ``Aligner`` on the device, this tool spies on
``final_mapq`` where ``core/pipeline`` and ``core/samout`` call it (both
through the module ``core/score``, so the spy replaces the module's
attribute and is restored in a ``finally``) and reports, per final-mapq
bin, which term binds; the raw histograms of the approx and gamma
terms; and, through ``Aligner.replay_sink``, whether each multi-candidate
read's second best lies at the best's locus (within 150 bp) or at
another, with the quantiles of second best over best.  Prints one JSON
line; writes a file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, sync)

BUCKETS = ((0, 10), (10, 20), (20, 30), (30, 40), (40, 50), (50, 61))


def repeat_world(genome_bp: int, n_pairs_req: int):
    """(genome, sim tuple): exact copies of 4 units, 12 each."""
    from ema_tpu_torch.tools import simulate as sim

    rng = np.random.default_rng(2026)
    genome = sim.rand_genome(rng, genome_bp)
    unit_len = genome_bp // 2500
    for _ in range(4):
        src = int(rng.integers(0, genome_bp - unit_len))
        unit = genome[src:src + unit_len].copy()
        for _ in range(12):
            at = int(rng.integers(0, genome_bp - unit_len))
            genome[at:at + unit_len] = unit
    pairs = sim.simulate_pairs(
        rng, sim.to_str(genome), n_barcodes=max(n_pairs_req // 60, 1),
        frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=30_000,
        read_len=100, err=0.003)
    return genome, pairs


def capture(genome, pairs, dev) -> tuple:
    """Align with the spy on final_mapq and the candidate sink: (terms
    {gamma, score, bwa: arrays}, candidate stats, SAM lines)."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core import score as score_mod
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.index import build_index

    ids, bc_strs, bcs, s1, q1, s2, q2, truth = pairs
    idx = build_index({"chr": genome})
    terms = {"gamma": [], "score": [], "bwa": []}
    orig_final = score_mod.final_mapq

    def spy_final(gamma, score_mapq, bwa_mapq):
        terms["gamma"].append(np.atleast_1d(
            score_mod.gamma_mapq(gamma)).copy())
        terms["score"].append(np.atleast_1d(np.asarray(score_mapq)).copy())
        terms["bwa"].append(np.atleast_1d(np.asarray(bwa_mapq)).copy())
        return orig_final(gamma, score_mapq, bwa_mapq)

    stats = {"two_plus": 0, "same_locus_2nd": 0, "other_locus_2nd": 0,
             "sub_ratio": []}
    lock = threading.Lock()

    def sink(batch, cs):
        N = cs.owner.shape[0]
        if not N:
            return
        order = np.lexsort((np.arange(N), -cs.sw.astype(np.int64),
                            cs.owner))
        own_s = cs.owner[order]
        first = np.ones(N, bool)
        first[1:] = own_s[1:] != own_s[:-1]
        starts = np.nonzero(first)[0]
        counts = np.diff(np.concatenate([starts, [N]]))
        multi = counts >= 2
        b_i = order[starts[multi]]
        s_i = order[starts[multi] + 1]
        same = ((cs.chrom[b_i] == cs.chrom[s_i])
                & (np.abs(cs.gpos[b_i].astype(np.int64)
                          - cs.gpos[s_i].astype(np.int64)) <= 150))
        with np.errstate(divide="ignore", invalid="ignore"):
            r = cs.sw[s_i] / np.maximum(cs.sw[b_i], 1)
        with lock:                  # chunks call the sink from threads
            stats["two_plus"] += int(multi.sum())
            stats["same_locus_2nd"] += int(same.sum())
            stats["other_locus_2nd"] += int((~same).sum())
            stats["sub_ratio"].append(r.astype(np.float32))

    aligner = Aligner(idx, config.RunConfig(), device=dev)
    aligner.replay_sink = sink
    score_mod.final_mapq = spy_final
    try:
        t0 = time.time()
        sam = aligner.align_batch_to_sam(ReadBatch.from_pairs(
            ids, bcs, s1, q1, s2, q2))
        sync(dev)
        log(f"aligned in {time.time() - t0:.1f}s; {len(sam)} records")
    finally:
        score_mod.final_mapq = orig_final
    if not terms["gamma"]:
        raise RuntimeError("diagnose_mapq: the spy saw no final_mapq call")
    return {k: np.concatenate(v).astype(np.int64)
            for k, v in terms.items()}, stats, sam


def decompose(terms, stats) -> dict:
    """The payload's analysis fields from the captured terms."""
    g, s, b = terms["gamma"], terms["score"], terms["bwa"]
    final = np.clip(np.minimum(np.minimum(g, s), b), 0, 60)
    decomp = {}
    for lo, hi in BUCKETS:
        m = (final >= lo) & (final < hi)
        n = int(m.sum())
        binds = {}
        if n:
            binds = {f"{name}_binds_pct": round(100.0 * float(
                (t[m] == final[m]).mean()), 1)
                for name, t in (("gamma", g), ("score", s), ("bwa", b))}
        decomp[f"mapq_{lo}_{hi - 1}"] = {"n": n, **binds}
    gc = np.clip(g, 0, 60)
    ratios = (np.concatenate(stats["sub_ratio"]) if stats["sub_ratio"]
              else np.zeros(0, np.float32))
    return {
        "records": int(final.shape[0]),
        "final_decomposition": decomp,
        "bwa_approx_raw_hist": {f"{lo}_{hi - 1}": int(((b >= lo)
                                                        & (b < hi)).sum())
                                for lo, hi in BUCKETS},
        "gamma_mapq_raw_hist": {f"{lo}_{hi - 1}": int(((gc >= lo)
                                                        & (gc < hi)).sum())
                                for lo, hi in BUCKETS},
        "multi_candidate_reads": stats["two_plus"],
        "second_best_same_locus": stats["same_locus_2nd"],
        "second_best_other_locus": stats["other_locus_2nd"],
        "sub_over_score_quantiles": {
            q: round(float(np.quantile(ratios, float(q))), 3)
            for q in ("0.1", "0.5", "0.9")} if ratios.size else {},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.diagnose_mapq",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--genome", type=int, default=8_000_000)
    ap.add_argument("--pairs", type=int, default=20_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)
    genome, pairs = repeat_world(a.genome, a.pairs)
    log(f"{len(pairs[0])} pairs on {a.genome / 1e6:.1f} Mbp with repeats")
    terms, stats, _ = capture(genome, pairs, dev)
    emit({"what": ("mapq decomposition on a repeat-family world: which of "
                   "the three terms binds in each final-mapq bin"),
          "n_pairs": len(pairs[0]), **decompose(terms, stats),
          "device": str(dev), "card": card}, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
