"""Per-stage walls of the align pipeline with one chunk worker: the twin
of tools/prof_pipeline.py.

    python -m ema_tpu_torch.tools.prof_pipeline [--device cuda|cpu]
        [--seeding greedy|smem] [--genome BP] [--pairs N] [--out FILE]

With ``inflight_chunks=1`` no two chunks overlap, so each stage's timer
(utils/metrics.Metrics) reads the wall it took, not thread-seconds
inflated by other chunks.  On the bench world (``tools/bench.
bench_world``), on the card by default: a warm-up pass, then 3 timed
passes.  Prints the stage table on stderr and one
JSON line: the best pass, pairs/s, the seeder, every pass's wall and
each stage's seconds a pass.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, sync)
from ema_tpu_torch.tools.bench import GENOME, N_PAIRS, bench_world


def measure(idx, pairs, dev, card: str, seeding=None, reps: int = 3) -> dict:
    """The stage walls on a built index and world; returns the JSON
    payload."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.utils.metrics import Metrics

    n_pairs = len(pairs[0])
    cfg = config.RunConfig(inflight_chunks=1)
    if seeding:
        cfg = dataclasses.replace(
            cfg, aligner=dataclasses.replace(cfg.aligner, seeding=seeding))
    aligner = Aligner(idx, cfg, device=dev)
    batch = ReadBatch.from_pairs(*pairs)
    t0 = time.time()
    aligner.align_batch_to_sam(batch)
    sync(dev)
    log(f"warmup: {time.time() - t0:.1f}s")
    met = Metrics()
    aligner.metrics = met
    passes = []
    for k in range(reps):
        t0 = time.time()
        aligner.align_batch_to_sam(batch)
        sync(dev)
        passes.append(time.time() - t0)
        log(f"pass {k}: {passes[-1]:.2f}s")
    aligner.metrics = None
    best = min(passes)
    log(f"best: {best:.2f}s = {n_pairs / best:.0f} pairs/s "
        f"(seeding={aligner.cfg.aligner.seeding})")
    met.report(sys.stderr)
    return {
        "n_pairs": n_pairs,
        "best_s": best,
        "pairs_per_sec": n_pairs / best,
        "seeding": aligner.cfg.aligner.seeding,
        "inflight_chunks": 1,
        "passes_s": passes,
        "stages_s_per_pass": {name: w / reps
                              for name, w in sorted(met.wall.items())},
        "device": str(dev),
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.prof_pipeline",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--seeding", choices=("greedy", "smem"), default=None)
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--pairs", type=int, default=N_PAIRS)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)

    from ema_tpu_torch.index import build_index

    codes, pairs, _, _ = bench_world(genome=a.genome, pairs=a.pairs)
    idx = build_index({"chr1": codes})
    log(f"{len(pairs[0])} pairs")
    emit(measure(idx, pairs, dev, card, a.seeding), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
