"""The port's banded SW (ema_tpu_torch/ops/sw.py) against the JAX package.

On the CPU the port runs the plain PyTorch versions; they must equal the
JAX row sweep, the Pallas kernel in interpret mode, the JAX pipeline's
gather + score and the native host scorer exactly (int32 outputs, no
tolerance).  The CUDA kernel itself is held against the same plain
versions on the card by chip_smoke.py.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ema_tpu import native
from ema_tpu.core.pipeline import _gather_score
from ema_tpu.ops.sw import sw_score_banded
from ema_tpu.ops.sw_pallas import sw_score_banded_pallas
from ema_tpu_torch.ops.sw import (LAUNCHES, LaunchCounter, gather_score,
                                  gather_score_ref, reset_counts,
                                  sw_score_banded_ref)
from ema_tpu_torch.utils.backend import resolve_device
from torch_handover import jax_native_built  # noqa: F401 (autouse)

KEYS = ("score", "qb", "qe", "ref_end")


def _planted(rng, B, m, n):
    """Reads/windows with bases 0-5, similarity planted at random
    offsets (so gaps, clips and N scoring all occur)."""
    reads = rng.integers(0, 6, (B, m)).astype(np.int32)
    rlens = rng.integers(1, m + 1, B).astype(np.int32)
    refs = rng.integers(0, 6, (B, n)).astype(np.int32)
    for b in range(B):
        off = int(rng.integers(0, 30))
        L = min(int(rlens[b]), n - off)
        keep = rng.random(L) < 0.9
        refs[b, off:off + L] = np.where(keep, reads[b, :L],
                                        refs[b, off:off + L])
    return reads, rlens, refs


@pytest.mark.parametrize("B,m,W", [(64, 37, 128), (48, 100, 128),
                                   (32, 100, 256)])
def test_row_sweep_equals_jax_and_pallas(B, m, W):
    rng = np.random.default_rng(B + m + W)
    n = m + W + 20
    reads, rlens, refs = _planted(rng, B, m, n)
    nlens = rng.integers(m // 2, n + 1, B).astype(np.int32)
    wl = rng.integers(1, W + 1, B).astype(np.int32)
    wl[:2] = [1, W]

    got = sw_score_banded_ref(
        torch.from_numpy(reads), torch.from_numpy(rlens),
        torch.from_numpy(refs), torch.from_numpy(nlens), W,
        wl=torch.from_numpy(wl)).numpy()
    jargs = (jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(refs),
             jnp.asarray(nlens), W)
    want = sw_score_banded(*jargs, wl=jnp.asarray(wl))
    pallas = sw_score_banded_pallas(*jargs, interpret=True,
                                    wl=jnp.asarray(wl))
    for c, k in enumerate(KEYS):
        np.testing.assert_array_equal(got[:, c], np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[:, c], np.asarray(pallas[k]),
                                      err_msg="pallas " + k)


def _gather_inputs(rng, rescue: bool):
    R, L, n = 24, 100, 4000
    text = rng.integers(0, 4, n).astype(np.uint8)
    oriented = rng.integers(0, 5, (R, L)).astype(np.uint8)
    olens = rng.integers(37, L + 1, R).astype(np.int32)
    pos = rng.integers(0, n - L, R)
    for r in range(R):                 # reads drawn from the text
        keep = rng.random(L) < 0.95
        oriented[r] = np.where(keep, text[pos[r]:pos[r] + L], oriented[r])
    N = 64
    owners = rng.integers(0, R, N).astype(np.int64)
    if rescue:                         # corridor = whole window, ~700
        win_len = rng.integers(680, 705, N).astype(np.int32)
        win_lo = (pos[owners] - rng.integers(0, 500, N)).astype(np.int64)
        wl = win_len.copy()
    else:
        win_len = rng.integers(90, 260, N).astype(np.int32)
        win_lo = (pos[owners] - rng.integers(0, 60, N)).astype(np.int64)
        wl = np.minimum(rng.integers(1, 129, N), win_len).astype(np.int32)
        wl[0] = 1
    win_lo[:6] = -rng.integers(1, 80, 6)          # before the text start
    win_lo[6:12] = n - rng.integers(1, 150, 6)     # past the text end
    return text, oriented, olens, owners, win_lo, win_len, wl


@pytest.mark.parametrize("rescue", [False, True])
def test_gather_score_equals_pipeline_gather_and_native(rescue):
    rng = np.random.default_rng(11 + rescue)
    text, oriented, olens, owners, win_lo, win_len, wl = _gather_inputs(
        rng, rescue)
    t = {k: torch.from_numpy(v) for k, v in dict(
        text=text, oriented=oriented, olens=olens,
        owners=owners.astype(np.int32), win_lo=win_lo, win_len=win_len,
        wl=wl).items()}
    got = gather_score(t["text"], t["oriented"], t["olens"], t["owners"],
                       t["win_lo"], t["win_len"], t["wl"]).numpy()
    ref = gather_score_ref(t["text"], t["oriented"], t["olens"],
                           t["owners"], t["win_lo"], t["win_len"],
                           t["wl"]).numpy()
    np.testing.assert_array_equal(got, ref)

    w_max = -(-int(win_len.max()) // 64) * 64
    w_band = -(-int(wl.max()) // 128) * 128
    jax_out = _gather_score(
        jnp.asarray(text), jnp.asarray(oriented), jnp.asarray(olens),
        jnp.asarray(owners.astype(np.int32)), jnp.asarray(win_lo),
        jnp.asarray(win_len), jnp.asarray(wl), w_max=w_max, w_band=w_band,
        match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5,
        sw_impl="banded")
    nat = native.sw_banded_native(oriented, olens, text, owners, win_lo,
                                  win_len, w_band, wl=wl)
    for c, k in enumerate(KEYS):
        np.testing.assert_array_equal(got[:, c], np.asarray(jax_out[k]),
                                      err_msg="jax " + k)
        np.testing.assert_array_equal(got[:, c], nat[k],
                                      err_msg="native " + k)


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.default_rng(5)
    text, oriented, olens, owners, win_lo, win_len, wl = _gather_inputs(
        rng, False)
    reset_counts()
    gather_score(torch.from_numpy(text), torch.from_numpy(oriented),
                 torch.from_numpy(olens),
                 torch.from_numpy(owners.astype(np.int32)),
                 torch.from_numpy(win_lo), torch.from_numpy(win_len),
                 torch.from_numpy(wl))
    assert all(c.value == 0 for c in LAUNCHES.values())


def test_gather_score_rejects_bad_inputs():
    text = torch.zeros(100, dtype=torch.uint8)
    oriented = torch.zeros((2, 10), dtype=torch.uint8)
    olens = torch.full((2,), 10, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    lo = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="owners"):
        gather_score(text, oriented, olens, lo, lo, one, one)
    meta = {k: v.to("meta") for k, v in dict(
        text=text, oriented=oriented, olens=olens, one=one, lo=lo).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        gather_score(meta["text"], meta["oriented"], meta["olens"],
                     meta["one"], meta["lo"], meta["one"], meta["one"])


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the absent-card error "
                    "cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_launch_counter_loses_no_update_under_threads():
    """Chunks score on a thread pool; the counter must not drop adds."""
    counter = LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == 32 * 2000
    counter.reset()
    assert counter.value == 0
