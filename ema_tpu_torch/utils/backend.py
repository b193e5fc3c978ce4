"""Device selection for the port: explicit, and never a silent fallback.

The counterpart of ema_tpu/utils/backend.py without its backend probe
and XLA compile cache (backend.py:45-133): a CUDA device that is asked for
and absent raises.  ``_tune_malloc`` is copied as it is.
"""

from __future__ import annotations

import subprocess

import torch

_malloc_tuned = False


def _tune_malloc() -> None:
    """Keep large numpy temporaries on the heap instead of mmap.

    The batched pipeline allocates multi-MB arrays (seed planes, record
    tables, SAM blobs) fresh every chunk; glibc serves >128 KB requests
    via mmap and returns them to the kernel on free, so every chunk
    re-faults its pages.  Raising M_MMAP_THRESHOLD and disabling trim
    makes freed blocks reusable.  mallopt applies to the running
    process, so this works without a launcher env.
    """
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 256 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, 256 << 20)
    except (OSError, AttributeError):
        pass           # non-glibc platforms: nothing to tune


def resolve_device(spec) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a torch.device -> device.

    Raises if CUDA is asked for and absent (or the index is out of
    range), and for any other device type.
    """
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {spec!r} requested but "
                               "torch.cuda.is_available() is false")
        n = torch.cuda.device_count()
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if not 0 <= idx < n:
            raise RuntimeError(f"device {spec!r} requested but only {n} "
                               "CUDA device(s) exist")
        return torch.device("cuda", idx)
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {spec!r} (cpu or cuda)")


def gpu_info() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]
