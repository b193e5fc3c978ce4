"""How far the host holds the align pipeline back: the twin of
tools/hostbound.py.

    python -m ema_tpu_torch.tools.hostbound [--device cuda|cpu] [--reps N]
        [--genome BP] [--pairs N] [--out FILE]

On the bench world (``tools/bench.bench_world``), in one process, each the
best of ``--reps`` runs (3 by default):

  full_wall           the whole pipeline (seed -> ... -> SAM)
  frontend_serial     candidate generation and record materialisation
                      only (seeding, SW on the device, traceback), the
                      chunks one after another
  frontend_overlap    the same with the pipeline's chunks in flight
  stage thread-seconds of one more full pass (utils/metrics.Metrics)

If full_wall is about frontend_overlap plus the host thread-seconds of
the group stages (EM, sweep, select+emit), the pass is serialised on the
host.  ``projected_host_cores_wall_s`` is what the pass would take if
this host's own cores (``os.cpu_count()``, ``host_cores``) shared the
group stages evenly beside the front end: max(frontend_overlap, group
thread-s / host_cores).  Prints one JSON line; writes a file only where
``--out`` says.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, sync)
from ema_tpu_torch.tools.bench import GENOME, N_PAIRS, bench_world

GROUP_STAGES = ("em[", "select+emit", "sweep")


def measure(idx, pairs, dev, card: str, reps: int = 3) -> dict:
    """The split on a built index and world; returns the JSON payload."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.utils.metrics import Metrics

    ids, bcs, s1, q1, s2, q2 = pairs
    n_pairs = len(ids)
    al = Aligner(idx, config.RunConfig(), device=dev)
    batch = ReadBatch.from_pairs(*pairs)
    t0 = time.time()
    al.align_batch_to_sam(batch)
    sync(dev)
    log(f"warmup: {time.time() - t0:.1f}s")

    def best(fn):
        b = float("inf")
        for _ in range(reps):
            t0 = time.time()
            fn()
            sync(dev)
            b = min(b, time.time() - t0)
        return b

    full_wall = best(lambda: al.align_batch_to_sam(batch))
    log(f"full_wall: {full_wall:.2f}s = {n_pairs / full_wall:.0f} pairs/s")
    B = al.cfg.batch_size

    def work(s):
        e = min(s + B, n_pairs)
        sub = ReadBatch.from_pairs(ids[s:e], bcs[s:e], s1[s:e], q1[s:e],
                                   s2[s:e], q2[s:e])
        return al.candidates_to_records(sub, al.generate_candidates(sub), s)

    def frontend_serial():
        for s in range(0, n_pairs, B):
            work(s)

    def frontend_overlap():
        with ThreadPoolExecutor(max_workers=al.cfg.inflight_chunks) as ex:
            list(ex.map(work, range(0, n_pairs, B)))

    fs = best(frontend_serial)
    fo = best(frontend_overlap)
    log(f"frontend serial {fs:.2f}s overlap {fo:.2f}s")

    met = Metrics()
    al.metrics = met
    t0 = time.time()
    al.align_batch_to_sam(batch)
    sync(dev)
    timed_wall = time.time() - t0
    al.metrics = None
    met.report(sys.stderr)
    stages = {name: w for name, w in sorted(met.wall.items())}
    group_host_s = sum(v for k, v in stages.items()
                       if any(t in k for t in GROUP_STAGES))
    cores = os.cpu_count() or 1
    projected = max(fo, group_host_s / cores)
    return {
        "what": ("how far the host holds the align pipeline back: the "
                 "whole pass against the candidate front end alone, and "
                 "the group stages' host thread-seconds"),
        "n_pairs": n_pairs,
        "full_wall_s": full_wall,
        "pairs_per_sec": n_pairs / full_wall,
        "frontend_serial_wall_s": fs,
        "frontend_overlap_wall_s": fo,
        "stages_thread_s": stages,
        "group_host_thread_s": group_host_s,
        "host_serialized_s": max(full_wall - fo, 0.0),
        "host_cores": cores,
        "projected_host_cores_wall_s": projected,
        "projected_host_cores_pairs_per_sec": (n_pairs / projected
                                               if projected else None),
        "timed_wall_with_metrics_s": timed_wall,
        "device": str(dev),
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.hostbound",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--pairs", type=int, default=N_PAIRS)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)

    from ema_tpu_torch.index import build_index

    codes, pairs, _, _ = bench_world(genome=a.genome, pairs=a.pairs)
    idx = build_index({"chr1": codes})
    emit(measure(idx, pairs, dev, card, a.reps), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
