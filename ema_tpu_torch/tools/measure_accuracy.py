"""Front-half accuracy of the port against simulation truth: the twin of
tools/measure_accuracy.py.

    python -m ema_tpu_torch.tools.measure_accuracy [--device cuda|cpu]
        [--genome BP] [--pairs N] [--err RATE] [--tol BP] [--out FILE]

A random genome (seed 2026; 32 Mbp and 80,000 pairs requested by
default) with four repeat families of 12 copies each, copies diverged at
0 to 4% (``plant_repeats``), so that reads map to several loci and the
mapq bins are populated; then simulated pairs aligned by the port's
``Aligner`` on the device.  Reported: the share of primary records within
``--tol`` bp of the simulated position (of the mapped, of all, of those
at mapq >= 30), the proper-pair share, and the error rate in each mapq
bin (calibration: a high mapq must mean few errors).  Prints one JSON
line (with ``device`` and ``card`` beside the align wall); writes a file
only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, sync)

DIV_RATES = (0.0, 0.002, 0.005, 0.01, 0.02, 0.04)
MAPQ_BINS = ((0, 10), (10, 20), (20, 30), (30, 40), (40, 50), (50, 61))


def plant_repeats(rng, genome, n_fam: int = 4, n_copies: int = 12) -> int:
    """Overwrite random stretches of ``genome`` (in place) with copies of
    ``n_fam`` units of len(genome) // 2500 bases, copy c diverged at
    DIV_RATES[c % 6]: exact copies make every in-repeat read's second
    best equal its best (mapq 0), diverged ones grade the mapq middle.
    Returns the unit length."""
    G = genome.shape[0]
    unit_len = G // 2500
    for _ in range(n_fam):
        src = int(rng.integers(0, G - unit_len))
        unit = genome[src:src + unit_len].copy()
        for c in range(n_copies):
            at = int(rng.integers(0, G - unit_len))
            cp = unit.copy()
            rate = DIV_RATES[c % len(DIV_RATES)]
            if rate:
                nmut = int(rate * unit_len)
                pos = rng.integers(0, unit_len, nmut)
                cp[pos] = (cp[pos] + rng.integers(1, 4, nmut)) % 4
            genome[at:at + unit_len] = cp
    return unit_len


def score_sam(sam, ids, truth, tol: int) -> dict:
    """The accuracy fields of a SAM's primary records against the truth."""
    truth_by_id = {ids[i]: truth[i] for i in range(len(ids))}
    n_primary = n_at = n_proper = n_mapped = 0
    mapq_tot = np.zeros(61, np.int64)
    mapq_err = np.zeros(61, np.int64)
    for ln in sam:
        if ln.startswith("@"):
            continue
        f = ln.split("\t")
        flag = int(f[1])
        if flag & (0x100 | 0x800):
            continue
        n_primary += 1
        if flag & 0x4:
            continue
        n_mapped += 1
        if flag & 0x2:
            n_proper += 1
        t = truth_by_id[f[0]]
        want = t["pos1"] if (flag & 0x40) else t["pos2"]
        ok = abs(int(f[3]) - want) <= tol
        n_at += ok
        mq = min(int(f[4]), 60)
        mapq_tot[mq] += 1
        mapq_err[mq] += not ok
    hi30_n = int(mapq_tot[30:].sum())
    hi30_err = int(mapq_err[30:].sum())
    calib = {}
    for lo, hi in MAPQ_BINS:
        tot = int(mapq_tot[lo:hi].sum())
        err = int(mapq_err[lo:hi].sum())
        calib[f"mapq_{lo}_{hi - 1}"] = {
            "n": tot, "err_rate": round(err / tot, 5) if tot else None}
    return {
        "primary_records": n_primary,
        "mapped_pct": round(100.0 * n_mapped / max(n_primary, 1), 3),
        "at_truth_pct_of_mapped": round(100.0 * n_at / max(n_mapped, 1), 3),
        "at_truth_pct_of_all": round(100.0 * n_at / max(n_primary, 1), 3),
        "at_truth_pct_mapq30plus": round(
            100.0 * (1 - hi30_err / max(hi30_n, 1)), 3),
        "proper_pair_pct": round(100.0 * n_proper / max(n_primary, 1), 3),
        "mapq_calibration": calib,
    }


def measure(dev, card: str, genome_bp: int, n_pairs_req: int,
            err: float = 0.003, tol: int = 5) -> dict:
    from ema_tpu_torch import config
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.index import build_index
    from ema_tpu_torch.tools import simulate as sim

    rng = np.random.default_rng(2026)
    t0 = time.time()
    genome = sim.rand_genome(rng, genome_bp)
    unit_len = plant_repeats(rng, genome)
    gs = sim.to_str(genome)
    idx = build_index({"chr20sim": genome})
    log(f"index: {genome_bp / 1e6:.1f} Mbp (4x12 repeat units of "
        f"{unit_len} bp) in {time.time() - t0:.0f}s")
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim.simulate_pairs(
        rng, gs, n_barcodes=max(n_pairs_req // 60, 1), frags_per_bc=(2, 4),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100, err=err)
    n_pairs = len(ids)
    aligner = Aligner(idx, config.RunConfig(), device=dev)
    t0 = time.time()
    sam = aligner.align_batch_to_sam(ReadBatch.from_pairs(
        ids, bcs, s1, q1, s2, q2))
    sync(dev)
    wall = time.time() - t0
    log(f"aligned {n_pairs} pairs in {wall:.1f}s on {dev} ({card})")
    return {
        "what": ("front-half accuracy against simulation truth on a "
                 "repeat-family world (seeding, chaining, banded SW, mate "
                 "rescue, mapq)"),
        "genome_bp": genome_bp,
        "n_pairs": n_pairs,
        "read_err_rate": err,
        "tol_bp": tol,
        **score_sam(sam, ids, truth, tol),
        "align_wall_s": wall,
        "pairs_per_sec": n_pairs / wall,
        "device": str(dev),
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.measure_accuracy",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--genome", type=int, default=32_000_000)
    ap.add_argument("--pairs", type=int, default=80_000)
    ap.add_argument("--err", type=float, default=0.003)
    ap.add_argument("--tol", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)
    emit(measure(dev, card, a.genome, a.pairs, a.err, a.tol), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
