"""Two checkouts of this repository in turns on one card: the SW kernels'
times (chip_smoke.phase_kernel), the bench world's pairs/s under the
default scorer (chip_smoke._main_run) and sw_banded's time on the chained
call that run recorded, A, B, B, A.

    python -m ema_tpu_torch.tools.ab_smoke DIR_A DIR_B [--skip-kernel]
        [--skip-main] [--rounds=N]

Two versions are compared only inside one call, on one card: each turn
is a subprocess started in that checkout, so it builds and loads that
checkout's kernels and native library and nothing of the other's.  A
checkout is any directory with a ``chip_smoke.py`` and its
``ema_tpu_torch`` (for a parent commit: ``git archive <commit> | tar -x -C
DIR``); ``--rounds=N`` repeats the four turns N times.  Prints each
turn's numbers, then both sides' sw_banded times and
pass rates side by side with the card's name and power limit.  Fails if
a turn fails.
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
if "kernel" in want:
    res["kernel"] = {k: {f: v[f] for f in ("ms", "plain_ms")}
                     for k, v in cs.phase_kernel(dev, card).items()}
if "main" in want:
    genome, pairs, truth, _ = cs.bench_world()
    idx = ema_tpu_torch.build_index({"chr1": genome})
    _, st, rec = cs._main_run(dev, card, idx, pairs, truth, "banded")
    res["main"] = {"passes": st["passes"], "n_pairs": len(pairs[0]),
                   "launches": st["launches"]}
    # this checkout's sw_banded on the chained call its own run recorded
    # (an older checkout records one flat call, the first, a chained one)
    import numpy as np
    from ema_tpu_torch.ops.sw import gather_score
    c = rec.get("chained", rec)
    put = lambda a, t: torch.from_numpy(np.ascontiguousarray(a, t)).to(dev)
    args = (torch.from_numpy(idx.text).to(dev), c["oriented_dev"],
            c["olens_dev"], put(c["owners"], np.int32),
            put(c["win_lo"], np.int64), put(c["win_len"], np.int32),
            put(np.maximum(c["wl"], 1), np.int32))
    ms = cs._time_ms(lambda: gather_score(*args, scorer="banded",
                                          **cs.SW_KW), 20)
    rl = c["olens_dev"].cpu().numpy()[c["owners"]].astype(np.int64)
    res["recorded"] = {"ms": ms, "N": int(len(c["owners"])),
                       "cells": int((rl * np.maximum(c["wl"], 1)).sum()),
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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = [a for a in argv if a.startswith("--")]
    dirs = [a for a in argv if not a.startswith("--")]
    rounds = [int(f.split("=", 1)[1]) for f in flags
              if f.startswith("--rounds=")]
    flags = [f for f in flags if not f.startswith("--rounds=")]
    if len(dirs) != 2 or set(flags) - {"--skip-kernel", "--skip-main"}:
        sys.stderr.write(__doc__)
        return 1
    want = ",".join(p for p in ("kernel", "main")
                    if f"--skip-{p}" not in flags)
    sides = {"A": dirs[0], "B": dirs[1]}
    turns = {"A": [], "B": []}
    for side in "ABBA" * (rounds[-1] if rounds else 1):
        print(f"=== turn {side}: {sides[side]}", flush=True)
        turns[side].append(run_turn(sides[side], want))
    card = turns["A"][0]["card"]
    for side in "AB":
        got = turns[side]
        if "kernel" in want:
            for k in sorted(got[0]["kernel"]):
                print(f"{side} {sides[side]} {k}: kernel ms "
                      f"{[t['kernel'][k]['ms'] for t in got]}, plain ms "
                      f"{[t['kernel'][k]['plain_ms'] for t in got]}, "
                      f"card: {card}")
        if "main" in want:
            rates = [t["main"]["n_pairs"] / p for t in got
                     for p in t["main"]["passes"]]
            print(f"{side} {sides[side]} sw_banded on its recorded chained "
                  f"call: {[t['recorded'] for t in got]}, card: {card}")
            print(f"{side} {sides[side]} bench world, default scorer: median "
                  f"{statistics.median(rates)} pairs/s over {len(rates)} "
                  f"passes {sorted(rates)}, sw_banded launches over 4 "
                  f"passes {[t['main']['launches'] for t in got]}, "
                  f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
