"""tests/torch_handover.py's load of the JAX package's native library.

The JAX package builds ``libema_native.so`` on first use through one shared
temporary file, so processes that find it missing at once (the xdist
workers of a fresh checkout) rename each other's build away.  The port's
tests load it through ``jax_native_lib``, which serialises the build under
a lock file beside the library and retries a load that a builder outside
the lock broke.
"""

import os
import shutil
import subprocess
import sys
import types

import pytest

import ema_tpu.native
from torch_handover import jax_native_lib

HERE = os.path.dirname(os.path.abspath(__file__))
# one worker: import the copy of ema_tpu/native at argv[1] and load its
# library through the helper
WORKER = """
import importlib.util, sys
sys.path.insert(0, sys.argv[2])
from torch_handover import jax_native_lib
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
lib = jax_native_lib(mod)
print("loaded", lib.sais_u8 is not None)
"""


def test_concurrent_first_loads_all_succeed(tmp_path):
    """Four processes load a fresh copy of the library (no .so yet) at
    once: every one gets it, and the one shared temporary file is gone."""
    src = os.path.dirname(ema_tpu.native.__file__)
    for name in ("__init__.py", "ema_native.cpp"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path / "__init__.py"), HERE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.split() == ["loaded", "True"], err
    assert (tmp_path / "libema_native.so").exists()
    assert not (tmp_path / "libema_native.so.tmp").exists()


def test_a_broken_load_is_retried(tmp_path):
    """A load that an unlocked builder broke (its rename took the shared
    temporary file away) is retried under the lock; a failure that lasts
    is raised."""
    calls = []

    def get_lib():
        calls.append(1)
        if len(calls) == 1:
            raise FileNotFoundError("libema_native.so.tmp")
        return "lib"

    fake = types.SimpleNamespace(_SO=str(tmp_path / "libfake.so"),
                                 get_lib=get_lib)
    assert jax_native_lib(fake) == "lib" and len(calls) == 2
    assert (tmp_path / "libfake.so.lock").exists()

    def broken():
        raise OSError("file too short")

    with pytest.raises(OSError, match="too short"):
        jax_native_lib(types.SimpleNamespace(_SO=fake._SO, get_lib=broken),
                       tries=2)
