"""Device profiling for the CLI's ``--profile``.

The counterpart of ema_tpu/utils/metrics.py:device_trace, which wraps
jax.profiler; the stage timers (``Metrics``) there are jax-free and the
port imports them as they are.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


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
