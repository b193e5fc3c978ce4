"""Stage timing / throughput counters and the CLI's ``--profile``.

The counterpart of ema_tpu/utils/metrics.py: every pipeline stage reports
into a ``Metrics`` registry (counts, wall seconds, derived rates) that the
CLI prints as a summary table; ``device_trace`` is a ``torch.profiler``
trace where the JAX package wraps jax.profiler.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict, Optional

import torch


class Metrics:
    """Accumulates per-stage wall time and item counts."""

    def __init__(self) -> None:
        self.wall: Dict[str, float] = {}
        self.items: Dict[str, int] = {}
        self._t0 = time.time()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0):
        t = time.time()
        try:
            yield
        finally:
            dt = time.time() - t
            with self._lock:
                self.wall[name] = self.wall.get(name, 0.0) + dt
                if n_items:
                    self.items[name] = self.items.get(name, 0) + n_items

    def add(self, name: str, n_items: int) -> None:
        with self._lock:
            self.items[name] = self.items.get(name, 0) + n_items

    def summary(self) -> str:
        total = time.time() - self._t0
        lines = [f":: total wall time: {total:.2f}s"]
        for name in sorted(self.wall):
            w = self.wall[name]
            n = self.items.get(name, 0)
            rate = f" ({n / w:.0f}/s)" if n and w > 0 else ""
            cnt = f" n={n}" if n else ""
            lines.append(f"::   {name}: {w:.2f}s{cnt}{rate}")
        return "\n".join(lines)

    def report(self, stream=sys.stderr) -> None:
        stream.write(self.summary() + "\n")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device: torch.device):
    """A torch.profiler trace around a region when ``log_dir`` is set:
    host activity, and CUDA activity when ``device`` is a card, written
    to ``log_dir/trace.json`` (Chrome trace format)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
