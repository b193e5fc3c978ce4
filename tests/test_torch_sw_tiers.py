"""The port's other SW scorers (ema_tpu_torch/ops/sw.py) and the Aligner's
choice of scorer, against the JAX package.

The plain versions of the int16 banded kernel, the pair-packed 64-lane
tier and the anti-diagonal scorer must equal the JAX package's kernels
(Pallas in interpret mode, XLA) exactly, int32 outputs with no
tolerance, on inputs made from a numpy seed.  The CUDA kernels are held
against the same plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ema_tpu import config
from ema_tpu.core import pipeline as jax_pipeline
from ema_tpu.core.pipeline import _gather_score
from ema_tpu.index import build_index
from ema_tpu.ops.sw import sw_score_banded, sw_score_batch
from ema_tpu.ops.sw_pallas import (sw_score_banded_pallas16,
                                   sw_score_banded_pallas_packed,
                                   sw_score_batch_pallas)
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.core.pipeline import resolve_sw_impl
from ema_tpu_torch.ops import sw as port_sw
from ema_tpu_torch.ops.sw import (CALLS, LAUNCHES, gather_score,
                                  reset_counts, sw_score_banded16_ref,
                                  sw_score_banded_packed_ref,
                                  sw_score_batch_ref)
from simulate import rand_genome, simulate_pairs, to_str
from torch_handover import Aligner
from torch_handover import jax_native_built  # noqa: F401 (autouse)

KEYS = ("score", "qb", "qe", "ref_end")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _assert_same(got, want, what):
    for c, k in enumerate(KEYS):
        np.testing.assert_array_equal(got[:, c], np.asarray(want[k]),
                                      err_msg=f"{what} {k}")


# ----------------------------------------------------------------------
# plain versions against the JAX kernels
# ----------------------------------------------------------------------

def test_banded16_ref_equals_pallas16():
    """The inputs of test_wl_masking_identical_across_kernels
    (tests/test_sw_banded.py:271)."""
    rng = np.random.default_rng(3)
    B, m, W = 32, 80, 128
    n = m + W + 20
    reads = rng.integers(0, 5, (B, m)).astype(np.int32)
    rlens = rng.integers(40, m + 1, B).astype(np.int32)
    refs = rng.integers(0, 6, (B, n)).astype(np.int32)
    nlens = rng.integers(90, n + 1, B).astype(np.int32)
    wl = rng.integers(1, W + 1, B).astype(np.int32)

    got = sw_score_banded16_ref(_t(reads), _t(rlens), _t(refs), _t(nlens),
                                W, wl=_t(wl)).numpy()
    args = _j(reads, rlens, refs, nlens)
    _assert_same(got, sw_score_banded_pallas16(
        *args, W, interpret=True, wl=jnp.asarray(wl)), "pallas16")
    _assert_same(got, sw_score_banded(*args, W, wl=jnp.asarray(wl)),
                 "xla banded")


def test_banded16_ref_keeps_int16_state_and_no_alignment_score():
    """State is int16 all through; a candidate with no valid cell reports
    the int32 NEG, as sw_pallas.py:643-645 normalises NEG16."""
    reads = torch.full((2, 6), 4, dtype=torch.int32)
    rlens = torch.tensor([0, 6], dtype=torch.int32)
    refs = torch.zeros((2, 10), dtype=torch.int32)
    nlens = torch.tensor([10, 0], dtype=torch.int32)
    wl = torch.tensor([4, 4], dtype=torch.int32)
    got = sw_score_banded16_ref(reads, rlens, refs, nlens, 4, wl=wl)
    assert got.dtype == torch.int32
    assert got[:, 0].tolist() == [port_sw.NEG, port_sw.NEG]
    assert got[:, 1:].abs().sum() == 0
    with pytest.raises(ValueError, match="int16"):
        sw_score_banded16_ref(reads, rlens, refs, nlens, 9000,
                              wl=torch.full((2,), 9000, dtype=torch.int32))


@pytest.mark.parametrize("B,m", [(9, 40), (16, 33), (3, 25)])
def test_packed_ref_equals_pallas_packed(B, m):
    """The cases of test_packed_pair_kernel_exact
    (tests/test_sw_banded.py:342), odd batch sizes included."""
    rng = np.random.default_rng(7 + B + m)
    n = m + 80
    reads = rng.integers(0, 5, (B, m)).astype(np.int32)
    rlens = rng.integers(10, m + 1, B).astype(np.int32)
    refs = rng.integers(0, 6, (B, n)).astype(np.int32)
    for b in range(B):
        off = int(rng.integers(0, 30))
        L = min(int(rlens[b]), n - off)
        keep = rng.random(L) < 0.9
        refs[b, off:off + L] = np.where(keep, reads[b, :L],
                                        refs[b, off:off + L])
    nlens = rng.integers(m, n + 1, B).astype(np.int32)
    wl = rng.integers(1, 65, B).astype(np.int32)

    got = sw_score_banded_packed_ref(_t(reads), _t(rlens), _t(refs),
                                     _t(nlens), _t(wl)).numpy()
    args = _j(reads, rlens, refs, nlens)
    _assert_same(got, sw_score_banded_pallas_packed(
        *args, jnp.asarray(wl), interpret=True), "pallas packed")
    _assert_same(got, sw_score_banded(*args, 128, wl=jnp.asarray(wl)),
                 "xla banded")


def test_packed_ref_keeps_start_rows_past_256():
    """m = 360, wl = 40, a 3-base deletion in the read after row 300: the
    port's packed tier equals sw_score_banded, while the JAX packed kernel
    keeps only the start row modulo 256 (its P & 255,
    sw_pallas.py:746-754) -- the inherited fault this pins."""
    rng = np.random.default_rng(360)
    B, m, wl_c = 4, 360, 40
    n = m + 64
    text = rng.integers(0, 4, n + 3).astype(np.int32)
    reads = np.zeros((B, m), np.int32)
    refs = np.zeros((B, n), np.int32)
    for b in range(B):
        cut = 300 + 10 * b
        src = np.concatenate([text[:cut], text[cut + 3:]])   # deletion
        reads[b] = src[:m]
        reads[b, :cut - 40] = rng.integers(0, 4, cut - 40)   # noise before
        refs[b] = text[:n]
    rlens = np.full(B, m, np.int32)
    nlens = np.full(B, n, np.int32)
    wl = np.full(B, wl_c, np.int32)

    got = sw_score_banded_packed_ref(_t(reads), _t(rlens), _t(refs),
                                     _t(nlens), _t(wl)).numpy()
    args = _j(reads, rlens, refs, nlens)
    want = sw_score_banded(*args, 128, wl=jnp.asarray(wl))
    _assert_same(got, want, "xla banded")
    assert (got[:, 1] >= 256).all()
    jax_packed = sw_score_banded_pallas_packed(*args, jnp.asarray(wl),
                                               interpret=True)
    np.testing.assert_array_equal(np.asarray(jax_packed["qb"]),
                                  got[:, 1] % 256)
    for k in ("score", "qe", "ref_end"):
        np.testing.assert_array_equal(np.asarray(jax_packed[k]),
                                      np.asarray(want[k]))


def test_packed_ref_refuses_wide_corridors():
    z = torch.zeros((1, 4), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="wl <= 64"):
        sw_score_banded_packed_ref(z, one, z, one,
                                   torch.tensor([65], dtype=torch.int32))


@pytest.mark.parametrize("seed,B,m,W", [(0, 16, 24, 48), (1, 8, 33, 80)])
def test_batch_ref_equals_scan_and_pallas(seed, B, m, W):
    """The cases of tests/test_sw_pallas.py:11."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, m)).astype(np.int32)
    reads[rng.random((B, m)) < 0.05] = 4
    rl = rng.integers(m // 2, m + 1, B).astype(np.int32)
    refs = rng.integers(0, 4, (B, W)).astype(np.int32)
    wl = rng.integers(10, W + 1, B).astype(np.int32)
    for i in range(0, B, 2):
        L = int(rl[i])
        s = int(rng.integers(0, W - L)) if W > L else 0
        refs[i, s:s + L] = reads[i, :L]

    got = sw_score_batch_ref(_t(reads), _t(rl), _t(refs), _t(wl)).numpy()
    args = _j(reads, rl, refs, wl)
    _assert_same(got, sw_score_batch(*args), "xla scan")
    _assert_same(got, sw_score_batch_pallas(*args, interpret=True),
                 "pallas")


def test_batch_ref_zero_and_empty_rows():
    """tests/test_sw_pallas.py:34: all-N reads, a zero-length read and a
    zero-length window."""
    B, m, W = 8, 16, 32
    reads = np.full((B, m), 4, np.int32)
    rl = np.full(B, m, np.int32)
    rl[0] = 0
    refs = np.zeros((B, W), np.int32)
    wl = np.full(B, W, np.int32)
    wl[1] = 0
    got = sw_score_batch_ref(_t(reads), _t(rl), _t(refs), _t(wl)).numpy()
    args = _j(reads, rl, refs, wl)
    _assert_same(got, sw_score_batch(*args), "xla scan")
    _assert_same(got, sw_score_batch_pallas(*args, interpret=True),
                 "pallas")


# ----------------------------------------------------------------------
# gather_score's scorers
# ----------------------------------------------------------------------

def _gather_inputs(rng, N=96, wl_max=128):
    R, L, n = 24, 100, 4000
    text = rng.integers(0, 4, n).astype(np.uint8)
    oriented = rng.integers(0, 5, (R, L)).astype(np.uint8)
    olens = rng.integers(0, L + 1, R).astype(np.int32)
    pos = rng.integers(0, n - L, R)
    for r in range(R):                 # reads drawn from the text
        keep = rng.random(L) < 0.95
        oriented[r] = np.where(keep, text[pos[r]:pos[r] + L], oriented[r])
    owners = rng.integers(0, R, N).astype(np.int32)
    win_len = rng.integers(0, 260, N).astype(np.int32)
    win_lo = (pos[owners] - rng.integers(0, 60, N)).astype(np.int64)
    wl = np.maximum(np.minimum(rng.integers(1, wl_max + 1, N), win_len),
                    1).astype(np.int32)
    win_lo[:6] = -rng.integers(1, 80, 6)          # before the text start
    win_lo[6:12] = n - rng.integers(1, 150, 6)     # past the text end
    return [_t(a) for a in (text, oriented, olens, owners, win_lo, win_len,
                            wl)]


@pytest.mark.parametrize("scorer", ["banded16", "packed"])
def test_banded_tiers_equal_banded_through_the_gather(scorer):
    rng = np.random.default_rng(21)
    args = _gather_inputs(rng, wl_max=64 if scorer == "packed" else 300)
    got = gather_score(*args, scorer=scorer).numpy()
    want = gather_score(*args, scorer="banded").numpy()
    np.testing.assert_array_equal(got, want)


def test_scan_through_the_gather_equals_jax_pipeline_gather():
    rng = np.random.default_rng(22)
    text, oriented, olens, owners, win_lo, win_len, wl = _gather_inputs(
        rng, N=48)
    got = gather_score(text, oriented, olens, owners, win_lo, win_len, wl,
                       scorer="scan").numpy()
    w_max = -(-int(win_len.max()) // 64) * 64
    jax_out = _gather_score(
        *_j(text.numpy(), oriented.numpy(), olens.numpy(), owners.numpy(),
            win_lo.numpy(), win_len.numpy(), wl.numpy()),
        w_max=w_max, w_band=128, match=1, mismatch=4, gap_open=6,
        gap_extend=1, clip=5, sw_impl="scan")
    _assert_same(got, jax_out, "jax scan")


def test_counts_on_cpu_calls_but_no_launches():
    rng = np.random.default_rng(23)
    args = _gather_inputs(rng, N=16, wl_max=64)
    reset_counts()
    for scorer in ("banded", "banded16", "packed", "scan"):
        gather_score(*args, scorer=scorer)
    gather_score(*args, scorer="packed")
    assert {s: c.value for s, c in CALLS.items()} == {
        "banded": 1, "banded16": 1, "packed": 2, "scan": 1}
    assert all(c.value == 0 for c in LAUNCHES.values())
    with pytest.raises(ValueError, match="unknown scorer"):
        gather_score(*args, scorer="pallas")


# ----------------------------------------------------------------------
# the Aligner's scorer choice
# ----------------------------------------------------------------------

def test_resolve_sw_impl_follows_the_jax_switches(monkeypatch):
    monkeypatch.delenv("EMA_TPU_SW_IMPL", raising=False)
    monkeypatch.delenv("EMA_TPU_SW_TIER64", raising=False)
    assert resolve_sw_impl() == "banded"
    for env, want in (("scan", "scan"), ("banded", "banded"),
                      ("banded_pallas", "banded"), ("banded16", "banded16"),
                      ("native", "native"), ("bogus", "banded")):
        monkeypatch.setenv("EMA_TPU_SW_IMPL", env)
        assert resolve_sw_impl() == want, env
    monkeypatch.setenv("EMA_TPU_SW_TIER64", "1")
    for env, want in (("banded", "tier64"), ("banded_pallas", "tier64"),
                      ("banded16", "banded16"), ("scan", "scan"),
                      ("native", "native")):
        monkeypatch.setenv("EMA_TPU_SW_IMPL", env)
        assert resolve_sw_impl() == want, env
    monkeypatch.delenv("EMA_TPU_SW_IMPL")
    assert resolve_sw_impl() == "tier64"
    # an explicit choice wins over the environment
    assert resolve_sw_impl("scan") == "scan"
    assert resolve_sw_impl("banded_pallas") == "banded"
    with pytest.raises(ValueError, match="sw_impl"):
        resolve_sw_impl("pallas")


@pytest.fixture(scope="module")
def repeat_world():
    """The world of tests/test_sw_banded.py:237-255: 300 kbp with a
    12-copy repeat family, 30 barcodes and two contig-edge overhangs."""
    rng = np.random.default_rng(4242)
    g = rand_genome(rng, 300_000)
    unit = g[40_000:41_500].copy()
    for k in range(12):
        g[50_000 + k * 1_600:50_000 + k * 1_600 + 1_500] = unit
    gs = to_str(g)
    ids, _, bcs, s1, q1, s2, q2, _ = simulate_pairs(
        rng, gs, n_barcodes=30, frags_per_bc=(2, 3),
        pairs_per_frag=(10, 20), frag_len=20_000, read_len=100, err=0.005)
    ids += ["edgeA", "edgeB"]
    bcs += [bcs[0], bcs[0]]
    s1 += ["A" * 40 + gs[:60], gs[-60:] + "C" * 40]
    q1 += ["I" * 100] * 2
    s2 += [gs[200:300], gs[-300:-200]]
    q2 += ["I" * 100] * 2
    return build_index({"c": g}), (ids, bcs, s1, q1, s2, q2)


def _port_sam(world, sw_impl):
    idx, pairs = world
    al = Aligner(idx, config.RunConfig(batch_size=512, seed=7),
                 device="cpu", sw_impl=sw_impl)
    return sorted(al.align_batch_to_sam(ReadBatch.from_pairs(*pairs)))


@pytest.fixture(scope="module")
def repeat_banded_sam(repeat_world):
    return _port_sam(repeat_world, "banded")


@pytest.mark.parametrize("sw_impl", ["scan", "native"])
def test_repeat_world_equals_jax_aligner(sw_impl, repeat_world,
                                         repeat_banded_sam, monkeypatch):
    idx, pairs = repeat_world
    monkeypatch.setenv("EMA_TPU_SW_IMPL", sw_impl)
    jax_al = jax_pipeline.Aligner(idx, config.RunConfig(batch_size=512,
                                                        seed=7))
    assert jax_al._sw_impl == sw_impl
    want = sorted(jax_al.align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs)))
    got = _port_sam(repeat_world, sw_impl)
    assert len(got) >= 2 * len(pairs[0])
    assert got == want
    assert got == repeat_banded_sam


@pytest.mark.parametrize("sw_impl", ["banded16", "tier64"])
def test_repeat_world_banded_tiers_equal_banded(sw_impl, repeat_world,
                                                repeat_banded_sam):
    reset_counts()
    got = _port_sam(repeat_world, sw_impl)
    assert got == repeat_banded_sam
    if sw_impl == "tier64":
        # the split really sent the small corridors down the packed path
        assert CALLS["packed"].value > 0 and CALLS["banded"].value > 0
        assert CALLS["banded16"].value == 0
    else:
        assert CALLS["banded16"].value > 0
        assert CALLS["banded"].value == CALLS["packed"].value == 0
