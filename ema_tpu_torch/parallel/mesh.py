"""Device-mesh construction helpers (ema_tpu/parallel/mesh.py).

Axis convention, as in the JAX package:
  - ``data``: read pairs / barcode groups, the outermost data-parallel
    axis;
  - ``cand``: per-read candidate windows (seed-hit expansion slots),
    which splits the SW scoring work for one read across cells and is
    recombined with an argmax.

torch has no mesh type: a ``DeviceMesh`` is an ``(n_data, n_cand)`` grid
of ``torch.device`` with one CUDA stream per cell whose device is a card.
The same device may fill several cells (``["cuda:0", "cuda:0"]``): each
cell then keeps its own stream on that card.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from ema_tpu_torch.utils.backend import resolve_device

DATA_AXIS = "data"
CAND_AXIS = "cand"


def mesh_axes() -> tuple:
    return (DATA_AXIS, CAND_AXIS)


class DeviceMesh:
    """A ``(n_data, n_cand)`` grid of devices, with a stream per card
    cell (None on the CPU)."""

    def __init__(self, grid: List[List[torch.device]]):
        self.grid = grid
        self.streams = [[torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in row] for row in grid]
        self.shape = {DATA_AXIS: len(grid), CAND_AXIS: len(grid[0])}
        self.size = self.shape[DATA_AXIS] * self.shape[CAND_AXIS]

    @property
    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in row-major first-cell order."""
        return list(dict.fromkeys(d for row in self.grid for d in row))

    @contextlib.contextmanager
    def cell(self, d: int, c: int = 0):
        """Run the body on cell ``(d, c)``: its stream is made current
        (after it waits for the caller's stream, whose tensors the body
        reads).  Yields the cell's device."""
        dev, stream = self.grid[d][c], self.streams[d][c]
        if stream is None:
            yield dev
            return
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            yield dev

    def join(self, d: int, c: int, *tensors) -> None:
        """Make the caller's stream wait for cell ``(d, c)``'s work and
        mark ``tensors`` (made on the cell's stream) as used by it."""
        stream = self.streams[d][c]
        if stream is None:
            return
        cur = torch.cuda.current_stream(self.grid[d][c])
        cur.wait_stream(stream)
        for t in tensors:
            if t.device.type == "cuda":
                t.record_stream(cur)


def make_mesh(n_data: Optional[int] = None, n_cand: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """Build a ('data', 'cand') mesh over ``devices`` (default: every
    visible card, which raises where there is none).

    With only ``devices`` given, uses all of them on the data axis.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no devices given and "
                               "torch.cuda.is_available() is false")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if n_data is None:
        n_data = n // n_cand
    if n_data * n_cand != n:
        raise ValueError(f"mesh {n_data}x{n_cand} != {n} devices")
    return DeviceMesh([devices[d * n_cand:(d + 1) * n_cand]
                       for d in range(n_data)])


def factor_devices(n: int) -> tuple:
    """Pick a (n_data, n_cand) split for n devices: cand=2 when even."""
    if n % 2 == 0 and n >= 4:
        return n // 2, 2
    return n, 1
