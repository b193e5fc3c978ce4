"""Hand state built with the JAX package over to the port, for the tests
that run one input through both.

The port (``ema_tpu_torch``) imports nothing of ``ema_tpu`` and its code
never sees an ``ema_tpu`` object: an index crosses as plain numpy arrays
and scalars (``ema_tpu_torch.index.build.index_from_arrays``), a
``RunConfig`` and a ``GroupState`` as their fields.  Arrays are shared, not
copied.

``jax_native_lib`` (and the module fixture ``jax_native_built``, which a
test module takes by importing it) loads the JAX package's native library
with its build serialised across processes: see its docstring.
"""

from __future__ import annotations

import dataclasses
import fcntl
import subprocess
import time

import pytest

from ema_tpu_torch import config as port_config_mod
from ema_tpu_torch.core import groups as port_groups
from ema_tpu_torch.core import pipeline as port_pipeline
from ema_tpu_torch.index.build import index_from_arrays
from ema_tpu_torch.index.sharded import sharded_index_from_arrays


def jax_native_lib(native=None, tries: int = 3):
    """``ema_tpu.native.get_lib()`` (or ``native.get_lib()``) under an
    exclusive ``flock`` on a lock file beside the library.

    The JAX package builds its library on first use: every process that
    finds it missing runs g++ into the one shared ``libema_native.so.tmp``
    and renames that into place, so two processes that build at once (the
    xdist workers of a fresh checkout, where ``*.so`` is not committed)
    rename each other's file away, and one of them fails with
    FileNotFoundError in its first test that reaches the library.  Under
    the lock the port's tests build one at a time and the rest load the
    finished library.  A process that builds outside the lock (a test of
    the JAX package itself) can still break a load or a build here, so a
    failed one is retried while the lock is held."""
    if native is None:
        from ema_tpu import native
    with open(native._SO + ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for attempt in range(tries):
            try:
                return native.get_lib()
            except (OSError, subprocess.CalledProcessError):
                if attempt + 1 == tries:
                    raise
                time.sleep(1.0)


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """The JAX package's native library, built or loaded once per module
    before its first test (``jax_native_lib``)."""
    return jax_native_lib()


def fields_of(obj) -> dict:
    """The one-line ``ema_tpu`` -> dict helper: a dataclass's fields by
    name (not recursive)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def port_index(idx):
    """The port's ``ReferenceIndex`` / ``ShardedIndex`` over the arrays of
    the JAX package's."""
    if hasattr(idx, "shards"):
        return sharded_index_from_arrays([fields_of(s) for s in idx.shards])
    return index_from_arrays(fields_of(idx))


def port_config(cfg):
    """The port's ``RunConfig`` with the values of the JAX package's
    (None stays None)."""
    if cfg is None:
        return None
    kw = fields_of(cfg)
    kw["platform"] = port_config_mod.PlatformProfile(
        **fields_of(cfg.platform))
    kw["aligner"] = port_config_mod.AlignerParams(**fields_of(cfg.aligner))
    return port_config_mod.RunConfig(**kw)


def port_profile(profile):
    return port_config_mod.PlatformProfile(**fields_of(profile))


def port_states(states) -> list:
    """The port's ``GroupState`` for each of the JAX package's (the arrays
    are shared, so copy first where both sides update gammas)."""
    return [port_groups.GroupState(**fields_of(st)) for st in states]


def Aligner(index, cfg=None, **kw):
    """The port's ``Aligner`` on an index and a config that may come from
    the JAX package."""
    return port_pipeline.Aligner(port_index(index), port_config(cfg), **kw)


def ShardedAligner(index, cfg=None, **kw):
    return port_pipeline.ShardedAligner(port_index(index), port_config(cfg),
                                        **kw)
