"""BASELINE.md configs 3 and 4 through the port's real CLI: the twin of
tools/bench_configs.py.

    python -m ema_tpu_torch.tools.bench_configs config3 [--device cuda|cpu]
        [--genome BP] [--pairs N] [--out FILE]
    python -m ema_tpu_torch.tools.bench_configs config4 [--device cuda|cpu]
        [--buckets N] [--genome BP] [--pairs N] [--out FILE]

  (3) ``align -1/-2`` with EM and mate rescue, against a simulated
      genome of chr20's scale (32 Mbp by default);
  (4) ``align -x -d`` over many buckets (500 by default, 8 Mbp).

Neither human chr20 nor GRCh38 is in this repository, so both run on
simulated genomes (``tools/simulate``, seed 7, 100 bp pairs, ~60 a
barcode) through ``python -m ema_tpu_torch.cli`` subprocesses, the entry
points a user runs: the index built once, then a cold and a warm
``align`` (the cold run also builds or loads the kernels and the native
library).  config4 assigns a barcode to bucket crc32(barcode) % N.
Prints one JSON line (the warm run's pairs/s as ``value``, ``device``
and ``card``); writes a file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
import zlib

import numpy as np

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, run_cli, write_fasta)


def parse_stages(stderr: str) -> dict:
    """The stage table an ``align`` prints (':: name: 1.23s ...' lines of
    utils/metrics.Metrics.summary) as {stage: seconds}."""
    stages = {}
    for ln in stderr.splitlines():
        ln = ln.strip()
        if ln.startswith("::") and ":" in ln[3:]:
            name, _, rest = ln[2:].strip().partition(":")
            rest = rest.strip()
            if rest[:1].isdigit() and "s" in rest:
                try:
                    stages[name.strip()] = float(rest.split("s")[0])
                except ValueError:
                    pass
    return stages


def simulate(tmp: str, genome_bp: int, n_pairs: int, seed: int = 7):
    """ref.fa under ``tmp`` and the simulated pairs:
    (fasta path, ids, bc_strs, s1, q1, s2, q2)."""
    from ema_tpu_torch.tools import simulate as sim

    rng = np.random.default_rng(seed)
    gs = sim.to_str(sim.rand_genome(rng, genome_bp))
    fa = os.path.join(tmp, "ref.fa")
    write_fasta(fa, {"chr20sim": gs})
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim.simulate_pairs(
        rng, gs, n_barcodes=max(n_pairs // 60, 1), frags_per_bc=(2, 4),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100, err=0.003)
    return fa, ids, bc_strs, s1, q1, s2, q2


def _records(path: str) -> int:
    with open(path) as f:
        return sum(1 for ln in f if not ln.startswith("@"))


def config3(genome_bp: int, n_pairs: int, device: str, card: str) -> dict:
    """align -1/-2: the streaming pair-FASTQ mode, EM and mate rescue."""
    with tempfile.TemporaryDirectory() as tmp:
        fa, ids, bc_strs, s1, q1, s2, q2 = simulate(tmp, genome_bp, n_pairs)
        f1, f2 = os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq")
        with open(f1, "w") as a, open(f2, "w") as b:
            for i in range(len(ids)):
                rid = f"{ids[i]}:{bc_strs[i]}"
                a.write(f"@{rid}\n{s1[i]}\n+\n{q1[i]}\n")
                b.write(f"@{rid}\n{s2[i]}\n+\n{q2[i]}\n")
        t_index, _ = run_cli(["index", "-r", fa])
        log(f"index: {t_index:.1f}s for {genome_bp / 1e6:.1f} Mbp")
        out = os.path.join(tmp, "out.sam")
        args = ["align", "-r", fa, "--device", device, "-1", f1, "-2", f2,
                "-o", out]
        t_cold, _ = run_cli(args)
        t_warm, err = run_cli(args)
        n_rec = _records(out)
    if n_rec < 2 * len(ids):
        raise RuntimeError(f"config3: {n_rec} records for {len(ids)} pairs")
    return {
        "metric": "align_pair_fastq_pairs_per_sec",
        "value": len(ids) / t_warm,
        "unit": "pairs/s",
        "genome_bp": genome_bp,
        "n_pairs": len(ids),
        "index_build_s": t_index,
        "align_warm_wall_s": t_warm,
        "align_cold_wall_s": t_cold,
        "compile_s_est": max(t_cold - t_warm, 0.0),
        "stages_warm": parse_stages(err),
        "cold_pairs_per_sec": len(ids) / t_cold,
        "device": device,
        "card": card,
        "note": ("simulated genome of chr20's scale; the whole CLI path: "
                 "the streaming -1/-2 reader, EM, mate rescue, SAM "
                 "emission; the index built once and loaded by each "
                 "align; compile_s_est is the cold run's kernel and "
                 "library build or load"),
    }


def config4(n_buckets: int, n_pairs: int, genome_bp: int, device: str,
            card: str) -> dict:
    """align -x over many preproc buckets with -d (density optimisation)."""
    with tempfile.TemporaryDirectory() as tmp:
        fa, ids, bc_strs, s1, q1, s2, q2 = simulate(tmp, genome_bp, n_pairs)
        bdir = os.path.join(tmp, "bkt")
        os.makedirs(bdir)
        fhs = {}
        try:
            for i in range(len(ids)):
                k = zlib.crc32(bc_strs[i].encode()) % n_buckets
                if k not in fhs:
                    fhs[k] = open(os.path.join(bdir, f"ema-bin-{k:03d}"),
                                  "w")
                fhs[k].write(f"{bc_strs[i]} @{ids[i]} {s1[i]} {q1[i]} "
                             f"{s2[i]} {q2[i]}\n")
        finally:
            for fh in fhs.values():
                fh.close()
        buckets = sorted(os.path.join(bdir, n) for n in os.listdir(bdir))
        t_index, _ = run_cli(["index", "-r", fa])
        out = os.path.join(tmp, "out.sam")
        args = ["align", "-r", fa, "--device", device, "-x", "-d", "-o", out,
                *buckets]
        t_cold, _ = run_cli(args)
        t_warm, _ = run_cli(args)
        n_rec = sum(_records(p) for p in glob.glob(out + "*")
                    if os.path.isfile(p))
    if n_rec < 2 * len(ids):
        raise RuntimeError(f"config4: {n_rec} records for {len(ids)} pairs")
    return {
        "metric": "align_multibucket_pairs_per_sec",
        "value": len(ids) / t_warm,
        "unit": "pairs/s",
        "n_buckets": len(buckets),
        "n_pairs": len(ids),
        "genome_bp": genome_bp,
        "index_build_s": t_index,
        "align_warm_wall_s": t_warm,
        "align_cold_wall_s": t_cold,
        "compile_s_est": max(t_cold - t_warm, 0.0),
        "cold_pairs_per_sec": len(ids) / t_cold,
        "device": device,
        "card": card,
        "note": ("GRCh38's config scaled down: -x bucket mode with the "
                 "default small-bucket coalescing and -d density "
                 "optimisation; the index built once"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.bench_configs",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("which", choices=["config3", "config4"])
    add_device_arg(ap)
    ap.add_argument("--genome", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--buckets", type=int, default=500)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)
    if a.which == "config3":
        payload = config3(a.genome or 32_000_000, a.pairs, str(dev), card)
    else:
        payload = config4(a.buckets, a.pairs, a.genome or 8_000_000,
                          str(dev), card)
    emit(payload, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
