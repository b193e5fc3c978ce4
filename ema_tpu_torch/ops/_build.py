"""Build and load the sw_banded CUDA kernel (nvcc into a plain-C shared
library, bound with ctypes).

Nothing compiles at import: the first CUDA call builds
``csrc/sw_banded.cu`` for ``sm_90a`` into ``build/ema_tpu_torch/`` at the
checkout root, keyed by a hash of the source and the flags, and later
calls (and later processes) load the cached library.  A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "csrc" / "sw_banded.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ema_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_library() -> ctypes.CDLL:
    """The built sw_banded library (building it on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        key = hashlib.sha256(_SRC.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"libsw_banded_{key[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                str(_SRC)], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed for {_SRC} "
                                   f"(exit {r.returncode}):\n{r.stderr}")
            # ptxas -v: registers, spills and shared memory per kernel
            so.with_suffix(".log").write_text(r.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.sw_banded_max_wl.restype = ctypes.c_int
        lib.sw_banded_max_wl.argtypes = []
        lib.sw_banded_launch.restype = ctypes.c_int
        lib.sw_banded_launch.argtypes = [
            p, i64, p, i64, p, p, p, p, p, i64, i32,
            i32, i32, i32, i32, i32, p, p]
        _lib = lib
        return lib
