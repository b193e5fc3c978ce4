"""Two checkouts of this repository in turns on one card: the SW kernels'
times on the synthetic chained and rescue sets (chip_smoke.sw_cases; the
banded scorer also on the mixed set), the bench world's pairs/s under the
default scorer (chip_smoke._main_run) and the times of sw_banded,
sw_banded16, sw_banded_packed (on the corridors of at most 64 lanes) and
sw_batch on the chained call that run recorded, and of sw_banded on its
recorded rescue call, A, B, B, A; where a checkout's sw_banded or
sw_banded_packed takes a thread form (ops/sw.FORM_GROUPS), each form is
timed too.  Every kernel time is given
twice: the wrapper's call (CUDA events around gather_score, which also pays
its checks and the readback of the bounds) and the SW kernels alone
(torch.profiler).

    python -m ema_tpu_torch.tools.ab_smoke DIR_A DIR_B [--skip-kernel]
        [--skip-main] [--rounds=N] [--sass]

Two versions are compared only inside one call, on one card: each turn
is a subprocess started in that checkout, so it builds and loads that
checkout's kernels and native library and nothing of the other's.  A
checkout is any directory with a ``chip_smoke.py`` and its
``ema_tpu_torch`` (for a parent commit: ``git archive <commit> | tar -x -C
DIR``); ``--rounds=N`` repeats the four turns N times.  Prints each
turn's numbers, then both sides' kernel times and pass rates side by side
with the card's name and power limit.  Fails if a turn fails.  ``--sass``
first builds sw_batch.cu, sw_banded16.cu, sw_banded_packed.cu and
sw_banded.cu of both checkouts and prints, for every instantiation, the
SASS instructions of its main loop over the cells one pass covers per
thread (its first template argument: rows a thread for sw_batch, registers
of two lanes for sw_banded16, lanes a thread for the row sweeps).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

TURN = r"""
import json, sys, time
import torch
import chip_smoke as cs
import ema_tpu_torch
from ema_tpu_torch.ops import _build
from ema_tpu_torch.utils.backend import gpu_info, resolve_device

want = sys.argv[1].split(",")
dev = resolve_device("cuda")
card = gpu_info()
_build.load_all()
res = {"card": card}
from ema_tpu_torch.ops import sw
from ema_tpu_torch.ops.sw import gather_score
from torch.profiler import ProfilerActivity, profile
SCORERS = ("banded", "banded16", "packed", "scan")
# the SW kernels' __global__ functions (a checkout from before
# ops/sw.KERNEL_SYMBOL ran sw_banded as rowsweep_kernel)
SW_KERNELS = tuple(getattr(sw, "KERNEL_SYMBOL", {}).values()) or (
    "rowsweep_kernel", "sw_banded16_kernel", "sw_banded_packed_kernel",
    "sw_batch_kernel")
# the thread forms of sw_banded and the packed kernel, where this
# checkout's launch takes one
FORMS = {s: getattr(sw, "FORM_GROUPS", {}).get(s, ())
         for s in ("banded", "packed")}


def timed(fn, reps):
    # [ms of a wrapper call (CUDA events), ms of its SW kernels alone
    # (torch.profiler's device time of the kernels named SW_KERNELS)]: the
    # call also pays the wrapper's checks and readback, in any checkout
    call_ms = cs._time_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if any(k in e.key for k in SW_KERNELS):
            us += getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
    return [call_ms, us / reps / 1e3]


if "kernel" in want:
    # each kernel at its pipeline shape and on the rescue set (the packed
    # tier on its wl <= 64 half), 20 and 10 launches after a warm-up
    cases = cs.sw_cases(dev)
    res["kernel"] = {}
    for scorer, names in (("banded", ("chained", "rescue", "mixed")),
                          ("banded16", ("chained", "rescue")),
                          ("packed", ("chained_w64",)),
                          ("scan", ("chained", "rescue"))):
        for cname in names:
            c = cases[cname]
            reps = 20 if cname.startswith("chained") else 10
            res["kernel"][f"{scorer} {cname}"] = timed(
                lambda: cs._call(gather_score, c, scorer), reps)
    for scorer, cname in (("packed", "chained_w64"), ("banded", "chained"),
                          ("banded", "rescue")):
        c = cases[cname]
        for group in FORMS[scorer]:
            res["kernel"][f"{scorer} {cname} form {group}"] = timed(
                cs._planned(c, scorer, group)[1], 20)
    del cases
if "main" in want:
    genome, pairs, truth, _ = cs.bench_world()
    idx = ema_tpu_torch.build_index({"chr1": genome})
    _, st, rec = cs._main_run(dev, card, idx, pairs, truth, "banded")
    res["main"] = {"passes": st["passes"], "n_pairs": len(pairs[0]),
                   "launches": st["launches"]}
    # this checkout's kernels on the chained call its own run recorded
    # (an older checkout records one flat call, the first, a chained one)
    import numpy as np
    c = rec.get("chained", rec)
    put = lambda a, t: torch.from_numpy(np.ascontiguousarray(a, t)).to(dev)
    wl = np.maximum(c["wl"], 1)

    def call_args(keep):
        return (torch.from_numpy(idx.text).to(dev), c["oriented_dev"],
                c["olens_dev"], put(c["owners"][keep], np.int32),
                put(c["win_lo"][keep], np.int64),
                put(c["win_len"][keep], np.int32), put(wl[keep], np.int32))

    args = call_args(np.arange(len(wl)))
    # the packed tier takes the corridors of at most 64 lanes
    small = call_args(np.nonzero(wl <= sw.PACKED_MAX_WL)[0])
    ms = {s: timed(lambda: gather_score(*(small if s == "packed" else args),
                                        scorer=s, **cs.SW_KW), 20)
          for s in SCORERS}
    names = ("text", "oriented", "olens", "owners", "win_lo", "win_len",
             "wl")
    for scorer, a in (("packed", small), ("banded", args)):
        for group in FORMS[scorer]:
            ms[f"{scorer} form {group}"] = timed(
                cs._planned(dict(zip(names, a)), scorer, group)[1], 20)
    # sw_banded on the recorded rescue call (one or two candidates)
    r = rec["rescue"]
    rescue = (torch.from_numpy(idx.text).to(dev), r["oriented_dev"],
              r["olens_dev"], put(r["owners"], np.int32),
              put(r["win_lo"], np.int64), put(r["win_len"], np.int32),
              put(np.maximum(r["win_len"], 1), np.int32))
    ms["banded rescue"] = timed(
        lambda: gather_score(*rescue, scorer="banded", **cs.SW_KW), 20)
    for group in FORMS["banded"]:
        ms[f"banded rescue form {group}"] = timed(
            cs._planned(dict(zip(names, rescue)), "banded", group)[1], 20)
    rl = c["olens_dev"].cpu().numpy()[c["owners"]].astype(np.int64)
    res["recorded"] = {"ms": ms, "N": int(len(c["owners"])),
                       "N_rescue": int(len(r["owners"])),
                       "N_packed": int((wl <= sw.PACKED_MAX_WL).sum()),
                       "cells": int((rl * wl).sum()),
                       "max_wl": int(c["wl"].max())}
print("AB_RESULT " + json.dumps(res), flush=True)
"""


def run_turn(path: str, want: str) -> dict:
    """One turn in the checkout at ``path``; its AB_RESULT record."""
    r = subprocess.run([sys.executable, "-c", TURN, want], cwd=path,
                       capture_output=True, text=True, timeout=1500)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        raise RuntimeError(f"turn in {path} failed:\n{r.stderr[-4000:]}")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB_RESULT ")]
    return json.loads(line[-1][len("AB_RESULT "):])


# __global__ functions that an older checkout's SW kernels had (its
# sw_banded ran the shared two-pass row sweep of sw_rowsweep.cuh)
LEGACY_SYMBOLS = (("sw_banded", "rowsweep_kernel"),)


def print_sass(sides: dict) -> None:
    """The main-loop SASS instruction counts of both checkouts' sw_batch,
    sw_banded16, sw_banded_packed and sw_banded, built here with this
    checkout's flags."""
    import os
    import tempfile

    from ema_tpu_torch.ops import _build
    from ema_tpu_torch.ops.sw import KERNEL_SYMBOL
    from ema_tpu_torch.tools import bench_sw

    with tempfile.TemporaryDirectory() as tmp:
        for side, path in sides.items():
            for kernel, stem in (*KERNEL_SYMBOL.items(), *LEGACY_SYMBOLS):
                lanes = 2 if kernel == "sw_banded16" else 1
                so = os.path.join(tmp, f"{side}_{kernel}.so")
                src = os.path.join(path, "ema_tpu_torch", "ops", "csrc",
                                   f"{kernel}.cu")
                if not os.path.exists(so):
                    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                    so, src], check=True,
                                   capture_output=True)
                loops = bench_sw.sass_loops_in(so, stem)
                for args, loop in sorted(loops.items()):
                    first = int(args.split("E")[0].lstrip("Li"))
                    cells = first * lanes
                    per = (None if loop["loop"] is None
                           else loop["loop"] / cells)
                    print(f"{side} {path} sass {kernel} {stem}<{args}>: "
                          f"{loop['loop']} instructions in the loop of "
                          f"{loop['total']} / {cells} cells = {per} a cell; "
                          f"{loop['loop_opcodes']}", flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = [a for a in argv if a.startswith("--")]
    dirs = [a for a in argv if not a.startswith("--")]
    rounds = [int(f.split("=", 1)[1]) for f in flags
              if f.startswith("--rounds=")]
    flags = [f for f in flags if not f.startswith("--rounds=")]
    if len(dirs) != 2 or set(flags) - {"--skip-kernel", "--skip-main",
                                       "--sass"}:
        sys.stderr.write(__doc__)
        return 1
    want = ",".join(p for p in ("kernel", "main")
                    if f"--skip-{p}" not in flags)
    sides = {"A": dirs[0], "B": dirs[1]}
    if "--sass" in flags:
        print_sass(sides)
    turns = {"A": [], "B": []}
    for side in "ABBA" * (rounds[-1] if rounds else 1):
        print(f"=== turn {side}: {sides[side]}", flush=True)
        turns[side].append(run_turn(sides[side], want))
    card = turns["A"][0]["card"]
    for side in "AB":
        got = turns[side]
        if "kernel" in want:
            for k in sorted(got[0]["kernel"]):
                print(f"{side} {sides[side]} {k}: [call ms, kernels ms] "
                      f"{[t['kernel'][k] for t in got]}, card: {card}")
        if "main" in want:
            rates = [t["main"]["n_pairs"] / p for t in got
                     for p in t["main"]["passes"]]
            print(f"{side} {sides[side]} [call ms, kernels ms] by scorer on "
                  f"its recorded chained call: "
                  f"{[t['recorded'] for t in got]}, card: {card}")
            print(f"{side} {sides[side]} bench world, default scorer: median "
                  f"{statistics.median(rates)} pairs/s over {len(rates)} "
                  f"passes {sorted(rates)}, sw_banded launches over 4 "
                  f"passes {[t['main']['launches'] for t in got]}, "
                  f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
