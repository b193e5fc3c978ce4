"""In-process A/B of align configurations on the bench world: the twin of
tools/ab_align.py.

    python -m ema_tpu_torch.tools.ab_align [--device cuda|cpu] [--reps N]
        [--check-equal] [--genome BP] [--pairs N] [--out FILE] NAME...

Pairs/s on one card moves with its host from call to call, so two
configurations are compared in one process on one world
(``tools/bench.bench_world``), their timed passes alternating.  NAME is
one of SPECS or a ``+``-combination (``seeddev+t6+b8192``: ``bN`` sets
the batch size, ``tN`` the chunks in flight); ``pallas`` and ``banded``
both mean the sw_banded kernel, the port of the Pallas banded scorer.
Each configuration takes one warm-up pass, then ``--reps`` timed passes
(3 by default) in turns.  ``--check-equal`` first asserts that every
configuration gives the first one's SAM, record for record.

Prints one line per pass on stderr and one JSON line: ``pairs_per_sec_best``
by configuration, each configuration's pass walls (``passes_s``) and
their median (``median_s``), ``device`` and ``card``.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, sync)
from ema_tpu_torch.tools.bench import GENOME, N_PAIRS, bench_world

SPECS = {
    "devem": dict(device_em=True),
    "hostem": dict(device_em=False),
    "pallas": dict(sw="banded"),
    "banded": dict(sw="banded"),
    "banded16": dict(sw="banded16"),
    "scan": dict(sw="scan"),
    "greedy": dict(seeding="greedy"),
    "smem": dict(seeding="smem"),
    "seednat": dict(seed_impl="native"),    # host C++ greedy seed+locate
    "seeddev": dict(seed_impl="device"),    # index/fm.seed_locate_reads
    "tier64": dict(sw_tier="1"),            # sw_banded_packed for wl <= 64
    "notier": dict(sw_tier="0"),
    "default": dict(),
}


def settings(name: str) -> dict:
    """The Aligner settings of a configuration name: sw_impl, seed_impl,
    device_em, batch_size, inflight_chunks and seeding (None: the
    Aligner's default)."""
    spec = {}
    for part in name.split("+"):
        if part in SPECS:
            spec.update(SPECS[part])
        elif part.startswith("b") and part[1:].isdigit():
            spec["batch"] = int(part[1:])
        elif part.startswith("t") and part[1:].isdigit():
            spec["inflight"] = int(part[1:])
        else:
            raise SystemExit(f"unknown config spec: {part}")
    sw = spec.get("sw")
    # the pair-packed tier splits the banded scorer's calls, as
    # EMA_TPU_SW_TIER64=1 does
    if spec.get("sw_tier") == "1" and sw in (None, "banded"):
        sw = "tier64"
    return dict(sw_impl=sw or "banded", seed_impl=spec.get("seed_impl"),
                device_em=spec.get("device_em"),
                batch_size=spec.get("batch"),
                inflight_chunks=spec.get("inflight"),
                seeding=spec.get("seeding"))


def make_aligner(idx, name: str, dev):
    from ema_tpu_torch import config
    from ema_tpu_torch.core.pipeline import Aligner

    s = settings(name)
    ap = config.DEFAULT_ALIGNER_PARAMS
    if s["seeding"]:
        ap = dataclasses.replace(ap, seeding=s["seeding"])
    cfg = config.RunConfig(
        device_em=s["device_em"], batch_size=s["batch_size"],
        inflight_chunks=s["inflight_chunks"], aligner=ap)
    return Aligner(idx, cfg, device=dev, sw_impl=s["sw_impl"],
                   seed_impl=s["seed_impl"])


def run(idx, pairs, names, dev, card: str, reps: int = 3,
        check_equal: bool = False) -> dict:
    """The A/B on a built index and world; returns the JSON payload."""
    from ema_tpu_torch.core.batch import ReadBatch

    n_pairs = len(pairs[0])
    aligners = {n: make_aligner(idx, n, dev) for n in names}

    def one_pass(al) -> tuple:
        t0 = time.time()
        lines = al.align_batch_to_sam(ReadBatch.from_pairs(*pairs))
        sync(dev)
        return time.time() - t0, lines

    sams = {}
    for n, al in aligners.items():
        dt, sams[n] = one_pass(al)
        log(f"warmup[{n}]: {dt:.1f}s")
    if check_equal:
        base = sams[names[0]]
        for n in names[1:]:
            if sams[n] != base:
                raise SystemExit(f"ab_align: SAM output differs between "
                                 f"{names[0]} and {n}")
        log(f"SAM outputs identical across {names} ({len(base)} records)")
    del sams
    times = {n: [] for n in names}
    for r in range(reps):
        for n in names:
            dt, lines = one_pass(aligners[n])
            if len(lines) != 2 * n_pairs:
                raise SystemExit(f"ab_align: {n} gave {len(lines)} records "
                                 f"for {n_pairs} pairs")
            times[n].append(dt)
            log(f"rep{r} {n}: {dt:.2f}s ({n_pairs / dt:.0f} pairs/s)")
    return {
        "pairs_per_sec_best": {n: round(n_pairs / min(t), 1)
                               for n, t in times.items()},
        "passes_s": times,
        "median_s": {n: statistics.median(t) for n, t in times.items()},
        "n_pairs": n_pairs,
        "checked_equal": check_equal,
        "device": str(dev),
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.ab_align",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check-equal", action="store_true")
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--pairs", type=int, default=N_PAIRS)
    ap.add_argument("--out", default=None)
    ap.add_argument("names", nargs="*", default=["devem", "hostem"])
    a = ap.parse_args(argv)
    names = a.names or ["devem", "hostem"]
    for n in names:
        settings(n)                     # an unknown name fails before work
    dev, card = open_device(ap.prog, a.device)

    from ema_tpu_torch.index import build_index

    codes, pairs, _, _ = bench_world(genome=a.genome, pairs=a.pairs)
    idx = build_index({"chr1": codes})
    log(f"{len(pairs[0])} pairs; configs={names} reps={a.reps}")
    emit(run(idx, pairs, names, dev, card, a.reps, a.check_equal), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
