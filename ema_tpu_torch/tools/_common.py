"""What the port's tools share: the ``--device`` flag and the card
it names, the JSON line each prints, and the port's CLI as a subprocess.

A tool runs on the card unless ``--device cpu`` asks for the CPU; where
there is no card it exits non-zero with one line on stderr, never falling
back.  Every timing stands beside ``card``: the card's name and power
limit as nvidia-smi prints them (``utils/backend.gpu_info``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from ema_tpu_torch.utils.backend import gpu_info, resolve_device

# the checkout that holds the package: the CLI subprocesses import it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exits 1 where there is no "
                         "card) or cpu")


def open_device(tool: str, spec: str) -> tuple:
    """(torch.device, card) for ``--device``; exits 1 with one line on
    stderr where the device cannot be had.  ``card`` is the card's name
    and power limit, or ``cpu`` for the CPU."""
    try:
        dev = resolve_device(spec)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{tool}: {e}") from None
    return dev, gpu_info() if dev.type == "cuda" else "cpu"


def sync(dev) -> None:
    """Wait for the device's queued work (a timing ends here)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def emit(payload: dict, out=None) -> None:
    """Print ``payload`` as one JSON line on stdout and, where ``out``
    names a file, write it there too."""
    line = json.dumps(payload)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def run_cli(args, **kw) -> tuple:
    """``python -m ema_tpu_torch.cli *args`` in a subprocess that must
    succeed; returns (wall seconds, its stderr)."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "ema_tpu_torch.cli", *args],
                       env=cli_env(), stderr=subprocess.PIPE, text=True,
                       **kw)
    wall = time.time() - t0
    if r.returncode:
        raise RuntimeError(f"ema_tpu_torch.cli {' '.join(args[:1])} failed "
                           f"(exit {r.returncode}):\n{r.stderr[-3000:]}")
    return wall, r.stderr


def write_fasta(path: str, contigs: dict, width: int = 70) -> None:
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")
