"""Build and load the port's CUDA kernels: one nvcc call per
``csrc/<name>.cu`` into a plain-C shared library, bound with ctypes.

Nothing compiles at import: the first CUDA call of a kernel builds its
source for ``sm_90a`` into ``build/ema_tpu_torch/`` at the checkout root,
keyed by a hash of the source, the shared headers and the flags, and
later calls (and later processes) load the cached library.
``load_all()`` starts every missing build at once, one nvcc process per
source.  A failed build raises; there is no fallback.

Each library exports ``<name>_launch`` with the argument types that
``KERNELS`` gives it (the SW signature, the one with a permutation of
sw_banded and sw_banded16, the ALU probe's or the cloud EM's; every SW
kernel takes a thread form after max_wl, 0 for the launch's own choice)
and, for the banded kernels, ``<name>_max_wl``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ema_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# (text, text_n, oriented, L, olens, owners, win_lo, win_len, wl, N,
#  max_wl, match, mismatch, gap_open, gap_extend, clip, out, stream)
SW_ARGTYPES = [_p, _i64, _p, _i64, _p, _p, _p, _p, _p, _i64, _i32,
               _i32, _i32, _i32, _i32, _i32, _p, _p]
# sw_banded, sw_banded16: (..., wl, perm, perm_off, N, max_wl, ...): slot
# c scores candidate perm[perm_off + c]
SW_BANDED_ARGTYPES = SW_ARGTYPES[:9] + [_p, _i64] + SW_ARGTYPES[9:]


def _with_group(argtypes):
    """Every SW kernel: (..., max_wl, group, match, ...)."""
    at = argtypes.index(_i32) + 1
    return argtypes[:at] + [_i32] + argtypes[at:]


# (x, out, n, K, unroll, form, stream)
PROBE_ARGTYPES = [_p, _p, _i64, _i32, _i32, _i32, _p]
# (the 14 arrays of ops/em_cloud.FIELDS, out, scratch, G, many, iters,
#  insert_min, insert_max, penalty, smem_bytes, stream)
EM_CLOUD_ARGTYPES = [_p] * 16 + [_i64, _i32, _i32, _i64, _i64,
                                 ctypes.c_double, _i64, _p]
# kernel -> the argument types of its <name>_launch
KERNELS = {"sw_banded": _with_group(SW_BANDED_ARGTYPES),
           "sw_banded16": _with_group(SW_BANDED_ARGTYPES),
           "sw_banded_packed": _with_group(SW_ARGTYPES),
           "sw_batch": _with_group(SW_ARGTYPES),
           "alu_probe": PROBE_ARGTYPES,
           "em_cloud": EM_CLOUD_ARGTYPES}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Build the missing libraries of ``names``, all nvcc runs at once."""
    todo = [(n, _so_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{err}")
            continue
        # ptxas -v: registers, spills and shared memory per kernel
        so.with_suffix(".log").write_text(err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def _bind(name: str) -> SimpleNamespace:
    lib = ctypes.CDLL(str(_so_path(name)))
    launch = getattr(lib, f"{name}_launch")
    launch.restype = ctypes.c_int
    launch.argtypes = KERNELS[name]
    max_wl = getattr(lib, f"{name}_max_wl", None)
    if max_wl is not None:
        max_wl.restype = ctypes.c_int
        max_wl.argtypes = []
    return SimpleNamespace(name=name, lib=lib, launch=launch, max_wl=max_wl)


def load_library(name: str) -> SimpleNamespace:
    """Kernel ``name`` (building it on first use): ``.launch`` and, for
    the banded kernels, ``.max_wl``."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}")
    with _lock:
        if name not in _libs:
            _compile([name])
            _libs[name] = _bind(name)
        return _libs[name]


def load_all() -> dict:
    """Every kernel, the missing ones built in parallel."""
    with _lock:
        _compile([n for n in KERNELS if n not in _libs])
        for n in KERNELS:
            if n not in _libs:
                _libs[n] = _bind(n)
        return dict(_libs)


def ptxas_log(name: str) -> str:
    """What ptxas -v said when ``name`` was built (registers, spills)."""
    log = _so_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
