"""Candidate-set recall of the port against brute-force ground truth on a
repeat-family world: the twin of tools/chain_recall.py.

    python -m ema_tpu_torch.tools.chain_recall [--device cuda|cpu]
        [--genome BP] [--pairs N] [--out FILE]

The chaining (ops/chaining.py) keeps more than BWA-MEM's weight filter
would and prunes later on SW scores, so the question is recall: does the
candidate set hold every locus a score-based oracle calls eligible?
Reads are simulated from planted repeat families whose copy positions
are known (``build_world``), so every in-repeat read's plausible loci (the
same offset in each copy of its family) can be listed; each is scored in
both orientations by the host's native banded scorer
(``native.sw_banded_native``, whatever ``--device`` says, so the oracle
does not lean on the device kernel whose candidates it judges) over a
128-lane corridor.  A locus is
eligible within the pipeline's score margin of the read's best
(EXTRA_SEARCH_DEPTH - 1 edits); recall is the share of eligible loci that
the pipeline's candidates (taken through ``Aligner.replay_sink``) hold,
also by edit distance to the best (d0, d_le3, d_le6, d_le11).
``main`` runs SMEM and greedy seeding on a 12 Mbp world of 30,000 pairs
requested (seed 2026) and prints one JSON line; writes a file only where
``--out`` says.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device)


def build_world(rng, genome_bp, n_pairs, div_rates=(0.0, 0.005, 0.01,
                                                    0.02, 0.05),
                n_fam=3, n_copies=10, err=0.003):
    """A genome with repeat families at known, disjoint copy positions
    (diverged copies included) and simulated pairs.  Returns (genome,
    families, sim tuple), families = [(unit_len, [copy starts]), ...]
    (0-based)."""
    from ema_tpu_torch.tools import simulate as sim_mod

    genome = sim_mod.rand_genome(rng, genome_bp)
    unit_len = max(genome_bp // 1500, 2000)
    families = []
    taken = []
    for _ in range(n_fam):
        src = int(rng.integers(0, genome_bp - unit_len))
        unit = genome[src:src + unit_len].copy()
        starts = [src]
        for c in range(n_copies - 1):
            at = int(rng.integers(0, genome_bp - unit_len))
            if any(abs(at - t) < unit_len for t in taken + starts):
                continue
            cp = unit.copy()
            rate = div_rates[c % len(div_rates)]
            if rate:
                nmut = int(rate * unit_len)
                p = rng.integers(0, unit_len, nmut)
                cp[p] = (cp[p] + rng.integers(1, 4, nmut)) % 4
            genome[at:at + unit_len] = cp
            starts.append(at)
        taken.extend(starts)
        families.append((unit_len, sorted(starts)))
    sim = sim_mod.simulate_pairs(
        rng, sim_mod.to_str(genome), n_barcodes=max(n_pairs // 60, 1),
        frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=20_000,
        read_len=100, err=err)
    return genome, families, sim


def measure_recall(genome, families, sim, cfg=None, margin_extra=0,
                   device="cuda"):
    """Run the pipeline on ``device``, take its candidates, score every
    family-translated locus of each in-repeat read on the host and return
    the recall payload."""
    from ema_tpu_torch import config, native
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.index import build_index

    ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim
    n_pairs = len(ids)
    idx = build_index({"chr": genome})
    cfg = cfg or config.RunConfig()
    params = cfg.aligner
    batches = []
    aligner = Aligner(idx, cfg, device=device)
    aligner.replay_sink = lambda batch, cs: batches.append((batch, cs))
    batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)
    aligner.align_batch_to_sam(batch)

    # (pair id, mate) -> candidate positions; owners are chunk-local
    cands: dict = {}
    for b, cs in batches:
        for o, g in zip(cs.owner, cs.gpos):
            pr, mate = int(o) // 2, int(o) % 2
            cands.setdefault((b.ids[pr], mate), []).append(int(g))

    # a read must lie inside one copy so that its offset exists in all
    L = 100
    fam_of_pos = np.full(genome.shape[0], -1, np.int32)
    for fi, (ul, starts) in enumerate(families):
        for st in starts:
            fam_of_pos[st:st + ul] = fi
    # one edit inside the pipeline's edit-distance keep-window
    # (EXTRA_SEARCH_DEPTH), each edit match + mismatch on this world
    margin = ((config.EXTRA_SEARCH_DEPTH - 1)
              * (params.match + params.mismatch) + margin_extra)
    pad = 32
    jobs, ori_rows = [], []
    for i in range(n_pairs):
        t = truth[i]
        for mate, tp in ((0, t["pos1"]), (1, t["pos2"])):
            p0 = tp - 1
            fi = fam_of_pos[p0]
            if fi < 0 or fam_of_pos[min(p0 + L - 1,
                                        genome.shape[0] - 1)] != fi:
                continue
            ul, starts = families[fi]
            base = max(s for s in starts if s <= p0)
            off = p0 - base
            if off + L > ul:
                continue
            fw = np.asarray(batch.codes[2 * i + mate], np.uint8)[:L]
            rows = []
            for orient in (fw, (3 - fw)[::-1].copy()):
                rows.append(len(ori_rows))
                ori_rows.append(orient)
            jobs.append(((ids[i], mate), [s + off for s in starts], rows))
    if not jobs:
        return {"error": "no in-repeat reads"}

    oriented = np.stack(ori_rows)
    owners, wlo = [], []
    for _, loci, rows in jobs:
        for lx in loci:
            for r in rows:
                owners.append(r)
                wlo.append(lx - pad)
    W = 128
    n = len(owners)
    out = native.sw_banded_native(
        oriented, np.full(oriented.shape[0], L, np.int32), idx.text,
        np.asarray(owners, np.int64), np.asarray(wlo, np.int64),
        np.full(n, L + 2 * pad, np.int64), W, match=params.match,
        mismatch=params.mismatch, gap_open=params.gap_open,
        gap_extend=params.gap_extend, clip=params.clip_penalty,
        wl=np.full(n, W, np.int32))
    scores = np.asarray(out["score"], np.int64)

    # a locus scores the better of its two orientations; recall by the
    # locus's edit distance to the best locus
    per_mm = params.match + params.mismatch
    bands = [(0, "d0"), (3, "d_le3"), (6, "d_le6"),
             (config.EXTRA_SEARCH_DEPTH - 1, "d_le11")]
    k = 0
    n_eligible = n_hit = n_reads_cov = n_reads = 0
    band_tot = {nm: 0 for _, nm in bands}
    band_hit = {nm: 0 for _, nm in bands}
    miss_examples = []
    for key, loci, rows in jobs:
        nl = len(loci)
        sc = scores[k:k + 2 * nl].reshape(nl, 2).max(axis=1)
        k += 2 * nl
        best = int(sc.max())
        elig = [(lx, int(s)) for lx, s in zip(loci, sc)
                if s >= best - margin]
        got = np.asarray(sorted(cands.get(key, [])), np.int64)
        n_reads += 1
        hit = 0
        for lx, s in elig:
            n_eligible += 1
            j = int(np.searchsorted(got, lx - 2 * pad))
            ok = bool(j < got.shape[0] and got[j] <= lx + 2 * pad)
            n_hit += ok
            hit += ok
            delta_edits = (best - s) / per_mm
            for lim, nm in bands:
                if delta_edits <= lim:
                    band_tot[nm] += 1
                    band_hit[nm] += ok
            if not ok and len(miss_examples) < 10:
                miss_examples.append({"read": str(key), "locus": int(lx),
                                      "score": s, "best": best})
        n_reads_cov += hit == len(elig)
    return {
        "n_pairs": n_pairs,
        "in_repeat_reads": n_reads,
        "eligible_loci": n_eligible,
        "recalled_loci": n_hit,
        "recall_pct": round(100.0 * n_hit / max(n_eligible, 1), 4),
        "recall_by_edit_delta": {
            nm: {"n": band_tot[nm],
                 "recall_pct": round(100.0 * band_hit[nm]
                                     / max(band_tot[nm], 1), 4)}
            for _, nm in bands},
        "reads_fully_covered_pct": round(
            100.0 * n_reads_cov / max(n_reads, 1), 4),
        "score_margin": int(margin),
        "miss_examples": miss_examples,
    }


def main(argv=None) -> int:
    from ema_tpu_torch import config

    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.chain_recall",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--genome", type=int, default=12_000_000)
    ap.add_argument("--pairs", type=int, default=30_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)
    rng = np.random.default_rng(2026)
    genome, families, sim = build_world(rng, a.genome, a.pairs)
    log(f"{len(sim[0])} pairs; families: "
        f"{[(ul, len(st)) for ul, st in families]}")
    payload = {}
    for mode in ("smem", "greedy"):
        ap_mode = dataclasses.replace(config.DEFAULT_ALIGNER_PARAMS,
                                      seeding=mode)
        res = measure_recall(genome, families, sim,
                             cfg=config.RunConfig(aligner=ap_mode),
                             device=dev)
        log(f"{mode}: recall {res.get('recall_pct')}%")
        payload[mode] = res
    payload["what"] = (
        "candidate-set recall against brute-force ground truth on a "
        "diverged-repeat world: every family-translated locus of every "
        "in-repeat read scored by the host's native banded scorer in both "
        "orientations; eligible = within the pipeline's EXTRA_SEARCH_DEPTH "
        "score margin of the best locus")
    payload["device"] = str(dev)
    payload["card"] = card
    emit(payload, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
