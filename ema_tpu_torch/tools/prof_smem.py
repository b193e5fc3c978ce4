"""SMEM seeding round by round on the bench world: the twin of
tools/prof_smem.py.

    python -m ema_tpu_torch.tools.prof_smem [--genome BP] [--pairs N]
        [--out FILE]

Host-only: SMEM seeding runs in the port's native C++ library on one
thread (``native.smem_seed_batch``), so ``--device`` does not apply and no
card is needed.  The rounds are isolated by parameters, not by code:

  smem r1 only               split_width=0, max_mem_intv=0
  smem r1+r2                 max_mem_intv=0
  smem r1+r2+r3 (no ktab)    the defaults
  smem r1+r2+r3 (ktab k10)   the defaults and a k = 10 k-mer table

beside the greedy seeder (``native.greedy_seed_batch``, 19 bp seeds, 16
a read), each the best of 3 runs over both mates of every pair.  Prints
one line a seeder on stderr and one JSON line: seconds, thousands of
reads/s and mean seeds a read by label, and ``card`` where the host has
one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ema_tpu_torch.tools._common import emit, log
from ema_tpu_torch.tools.bench import GENOME, N_PAIRS, bench_world

ROUNDS = (("smem r1 only", dict(split_width=0, max_mem_intv=0)),
          ("smem r1+r2", dict(max_mem_intv=0)),
          ("smem r1+r2+r3 (no ktab)", {}),
          ("smem r1+r2+r3 (ktab k10)", None))   # None: with the k-mer table


def measure(idx, pairs, reps: int = 3) -> dict:
    """The seeders on a built index and world; returns the JSON payload."""
    from ema_tpu_torch import native
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.utils.backend import gpu_info

    # every mate 1, then every mate 2, as the JAX tool orders them
    batch = ReadBatch.from_pairs(*pairs)
    codes = np.concatenate([batch.codes[0::2], batch.codes[1::2]])
    lens = np.concatenate([batch.lens[0::2], batch.lens[1::2]])
    n = codes.shape[0]
    args = (idx.occ_blocks, idx.counts, idx.primary, idx.fm_n, codes, lens)
    t0 = time.time()
    ktab = native.smem_kmer_table(idx.occ_blocks, idx.counts, idx.primary,
                                  idx.fm_n, k=10)
    ktab_s = time.time() - t0
    rows = {}

    def row(label, fn):
        best, out = float("inf"), None
        for _ in range(reps):
            t0 = time.time()
            out = fn()
            best = min(best, time.time() - t0)
        rows[label] = {"s": best, "k_reads_per_s": n / best / 1e3,
                       "mean_seeds": float(out[4].mean())}
        log(f"{label:28s} {best:6.2f}s  {n / best / 1e3:7.1f}k reads/s  "
            f"mean_seeds={out[4].mean():.2f}")

    row("greedy (old default)", lambda: native.greedy_seed_batch(
        *args, min_seed_len=19, max_seeds=16, n_threads=1))
    for label, kw in ROUNDS:
        kw = dict(kmer_tab=ktab) if kw is None else kw
        row(label, lambda kw=kw: native.smem_seed_batch(*args, n_threads=1,
                                                        **kw))
    return {"n_reads": n, "threads": 1, "ktab_build_s": ktab_s,
            "seeders": rows,
            "card": gpu_info() if torch.cuda.is_available() else "none"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.prof_smem",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--pairs", type=int, default=N_PAIRS)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    from ema_tpu_torch.index import build_index

    codes, pairs, _, _ = bench_world(genome=a.genome, pairs=a.pairs)
    idx = build_index({"chr1": codes})
    log(f"{len(pairs[0])} pairs, {2 * len(pairs[0])} reads")
    emit(measure(idx, pairs), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
