"""Scaling measurement for the sharded candidate step
(ema_tpu/parallel/bench_scaling.py).

BASELINE.md's north star includes >=80% reads/s scaling efficiency from
1 to N devices.  ``measure`` times the candidate step (seed -> locate ->
SW -> best) on a 1-device mesh and on the full ('data', 'cand') mesh, at
a fixed per-device batch (weak scaling), and reports efficiency =
(throughput_N / N) / throughput_1.  ``partition_check`` checks that the
step splits the batch 1/N per data cell and performs its cross-cell
reductions.

    python -m ema_tpu_torch.parallel.bench_scaling [--timing]

runs on every visible card (exits 1 where there is none).  Where the
mesh's cells share a card, the timing measures one card's time-sharing,
not scaling.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

STATIC = dict(max_seeds=4, hits_per_seed=4, window_pad=12, min_seed_len=19)


def _cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_scaling: no devices given and "
                           "torch.cuda.is_available() is false")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _world(genome_bases: int, devices, rng):
    """A random one-contig index and its FM arrays and text on the first
    device."""
    from ema_tpu_torch.index import build_index
    from ema_tpu_torch.index.fm import FMIndexArrays

    genome = rng.integers(0, 4, genome_bases).astype(np.uint8)
    idx = build_index({"c1": genome})
    dev = torch.device(devices[0])
    return (idx, FMIndexArrays.from_index(idx, dev),
            torch.from_numpy(idx.text).to(dev))


def _reads(rng, idx, n_rows: int, read_len: int, dev):
    starts = rng.integers(0, idx.n - read_len, n_rows)
    r = np.stack([idx.text[s:s + read_len] for s in starts])
    return (torch.from_numpy(r.astype(np.int32)).to(dev),
            torch.full((n_rows,), read_len, dtype=torch.int32, device=dev))


def measure(per_device_pairs: int = 512, read_len: int = 100,
            genome_bases: int = 500_000, repeats: int = 3,
            devices=None) -> dict:
    from ema_tpu_torch.parallel import make_mesh, make_sharded_candidate_step
    from ema_tpu_torch.parallel.mesh import factor_devices

    devices = list(devices) if devices is not None else _cards()
    n = len(devices)
    rng = np.random.default_rng(0)
    idx, fm, text = _world(genome_bases, devices, rng)

    def time_mesh(mesh_devices):
        nd, nc = factor_devices(len(mesh_devices))
        mesh = make_mesh(nd, nc, mesh_devices)
        step = make_sharded_candidate_step(mesh, fm, text, **STATIC)
        reads, lens = _reads(rng, idx, per_device_pairs * nd, read_len,
                             mesh.grid[0][0])
        out = step(reads, lens)
        _ = int(out.n_aligned)                  # build + settle
        best = float("inf")
        for _ in range(repeats):
            t0 = time.time()
            out = step(reads, lens)
            _ = int(out.n_aligned)
            _sync(mesh_devices)
            best = min(best, time.time() - t0)
        return reads.shape[0] / best

    t1 = time_mesh(devices[:1])
    tn = time_mesh(devices)
    eff = (tn / n) / t1 if t1 > 0 else 0.0
    return {
        "metric": "candidate_step_scaling_efficiency",
        "n_devices": n,
        "reads_per_s_1dev": round(t1, 1),
        "reads_per_s_ndev": round(tn, 1),
        "value": round(eff, 3),
        "unit": "fraction",
    }


def partition_check(n_devices: int | None = None, devices=None) -> dict:
    """Per-cell work-partition check (meaningful on any host).

    Asserts that the sharded step gives each data cell 1/N of the batch
    and performs the expected cross-cell reductions.  torch has no
    compiled program to read, so ``collectives_in_hlo`` (the JAX name,
    kept) lists the reductions the step recorded doing: ``cand-argmax``
    over the candidate shards and ``data-sum`` of the statistics.
    """
    from ema_tpu_torch.parallel import make_mesh, make_sharded_candidate_step
    from ema_tpu_torch.parallel.mesh import factor_devices

    devices = list(devices) if devices is not None else _cards()
    if n_devices:
        devices = devices[:n_devices]
    n = len(devices)
    nd, nc = factor_devices(n)
    rng = np.random.default_rng(0)
    idx, fm, text = _world(60_000, devices, rng)
    mesh = make_mesh(nd, nc, devices)
    step = make_sharded_candidate_step(mesh, fm, text, **STATIC)

    B, L = 4 * nd, 80
    reads, lens = _reads(rng, idx, B, L, mesh.grid[0][0])
    out = step(reads, lens)
    n_aligned = int(out.n_aligned)
    # 1/N rows per cell on the data axis
    rows_ok = (len(step.cell_rows) == n
               and all(r == B // nd for r in step.cell_rows.values()))
    colls = list(step.collectives)
    return {
        "metric": "candidate_step_work_partition",
        "n_devices": n,
        "mesh": {"data": nd, "cand": nc},
        "rows_per_device": B // nd,
        "partition_ok": bool(rows_ok),
        "collectives_in_hlo": colls,
        "aligned": n_aligned,
        "batch": B,
        "ok": bool(rows_ok and colls and n_aligned >= B // 2),
        "note": ("torch compiles no program: collectives_in_hlo lists the "
                 "cross-cell reductions the step performed; cells that "
                 "share a card measure no scaling"),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        sys.stderr.write("error: bench_scaling runs on the cards, and "
                         "torch.cuda.is_available() is false\n")
        return 1
    print(json.dumps(measure() if "--timing" in argv
                     else partition_check()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
