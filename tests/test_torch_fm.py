"""The port's FM-index ops (ema_tpu_torch.index.fm) against the JAX
package's (ema_tpu.index.fmindex) and the native host ops, bit for bit,
on the CPU, at sa_rate 2 and 4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ema_tpu import native
from ema_tpu.index import fmindex
from ema_tpu.index.build import build_index
from ema_tpu_torch.index import fm
from torch_handover import jax_native_built  # noqa: F401 (autouse)
from torch_handover import port_index


def _world(kind, sa_rate):
    rng = np.random.default_rng(3)
    if kind == "random":
        genome = rng.integers(0, 4, 6000, dtype=np.uint8)
    else:                             # deep repeats: wide SA intervals
        unit = rng.integers(0, 4, 150, dtype=np.uint8)
        genome = np.concatenate([np.tile(unit, 40),
                                 rng.integers(0, 4, 2000, dtype=np.uint8)])
    idx = build_index({"c": genome}, sa_rate=sa_rate)
    assert idx.sa_rate == sa_rate
    return (idx, fmindex.FMIndexArrays.from_index(idx),
            fm.FMIndexArrays.from_index(port_index(idx), torch.device("cpu")),
            genome)


@pytest.fixture(scope="module", params=[
    ("random", 2), ("random", 4), ("repeat", 2), ("repeat", 4)],
    ids=lambda p: f"{p[0]}-sa{p[1]}")
def world(request):
    return _world(*request.param)


def _reads(rng, genome, B=96, L=90):
    """Reads drawn from either strand with ~3% substitutions and N bases,
    mixed lengths including reads shorter than a seed, an all-N read and
    an empty one."""
    starts = rng.integers(0, genome.shape[0] - L, B)
    codes = np.stack([genome[s:s + L] for s in starts]).astype(np.uint8)
    rc = rng.random(B) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    mut = rng.random((B, L)) < 0.03
    codes = np.where(mut, rng.integers(0, 5, (B, L)), codes).astype(np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    lens[:4] = [5, 18, 0, L]
    codes[3] = 4
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 4)
    return codes.astype(np.uint8), lens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_index_words_carry_the_high_bit(world):
    """The occ words and the mark bitmap hold words >= 2^31, which torch
    sees as negative int32: the shifts in fm.py must not sign-extend."""
    idx, _, tfm, _ = world
    assert (idx.occ_blocks[:, 4:] < 0).any()
    assert (idx.sa_mark_words >= 1 << 31).any()
    assert (tfm.sa_mark_words < 0).any()


def test_rank_and_extend_backward_match_jax(world):
    idx, jfm, tfm, _ = world
    rng = np.random.default_rng(1)
    n1 = idx.fm_n + 1
    k = np.concatenate([rng.integers(0, n1 + 1, 3000),
                        [0, 1, n1, n1 - 1, idx.primary, idx.primary + 1],
                        np.arange(0, n1, 128)]).astype(np.int32)
    for c in range(4):
        cc = np.full(k.shape, c, np.int32)
        got = fm.rank(tfm, _t(cc), _t(k)).numpy()
        want = np.asarray(fmindex.rank(jfm, jnp.asarray(cc), jnp.asarray(k)))
        np.testing.assert_array_equal(got, want)
    lo = np.sort(rng.integers(0, n1 + 1, (2, 2000)), axis=0).astype(np.int32)
    c = rng.integers(0, 4, 2000).astype(np.int32)
    got = fm.extend_backward(tfm, _t(lo[0]), _t(lo[1]), _t(c))
    want = fmindex.extend_backward(jfm, jnp.asarray(lo[0]),
                                   jnp.asarray(lo[1]), jnp.asarray(c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_locate_matches_jax_and_native_on_every_row(world):
    idx, jfm, tfm, _ = world
    rows = np.arange(idx.fm_n + 1, dtype=np.int32)
    got = fm.locate(tfm, _t(rows)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(fmindex.locate(jfm, jnp.asarray(rows))))
    np.testing.assert_array_equal(got, native.locate_batch(idx, rows))
    np.testing.assert_array_equal(np.sort(got), np.arange(idx.fm_n + 1))


def test_seed_reads_match_jax_and_native(world):
    idx, jfm, tfm, genome = world
    codes, lens = _reads(np.random.default_rng(5), genome)
    got = [a.numpy() for a in fm.seed_reads(tfm, _t(codes), _t(lens))]
    want = [np.asarray(a) for a in fmindex.seed_reads(
        jfm, jnp.asarray(codes), jnp.asarray(lens))]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    host = native.greedy_seed_batch(idx.occ_blocks, idx.counts, idx.primary,
                                    idx.fm_n, codes, lens, min_seed_len=19,
                                    max_seeds=16)
    np.testing.assert_array_equal(got[4], host[4])
    live = np.arange(16)[None, :] < got[4][:, None]
    for g, h in zip(got[:4], host[:4]):
        np.testing.assert_array_equal(np.where(live, g, 0),
                                      np.where(live, h, 0))
    assert got[4].sum() > 0 and got[4][:4].tolist()[:3] == [0, 0, 0]


@pytest.mark.parametrize("max_hits,budget", [(3000, 4096), (16, 4096),
                                             (3000, 16)])
def test_seed_locate_reads_matches_jax_and_two_step(world, max_hits, budget):
    """The fused call equals the JAX program on every slot, and the host
    two-step path (host compaction + native locate) on its hits; budget
    16 overflows, and the caller then takes the two-step path."""
    from ema_tpu_torch.core.pipeline import _compact_seed_hits

    idx, jfm, tfm, genome = world
    codes, lens = _reads(np.random.default_rng(7), genome, B=40)
    kw = dict(max_seeds=16, min_seed_len=19, max_hits=max_hits,
              budget=budget, max_occ=30)
    packed, total, frac = fm.seed_locate_reads(tfm, _t(codes), _t(lens),
                                               **kw)
    jp, jt, jf = fmindex.seed_locate_reads(jfm, jnp.asarray(codes),
                                           jnp.asarray(lens), **kw)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    assert int(total) == int(jt)
    np.testing.assert_array_equal(frac.numpy(), np.asarray(jf))

    s = fm.seed_reads(tfm, _t(codes), _t(lens))
    owner, qb, slen, rows = _compact_seed_hits(
        [a.numpy() for a in s[:4]], s[4].numpy(), max_hits)
    assert int(total) == owner.shape[0]
    n = min(int(total), budget)
    for got, want in zip(packed.numpy()[:, :n],
                         (owner, qb, slen, native.locate_batch(idx, rows))):
        np.testing.assert_array_equal(got, want[:n])
    assert int(total) > budget or budget != 16


def test_expand_seed_hits_matches_jax_near_int32_limit():
    """int64 sampling == the JAX int32 split form, at widths where the
    plain int32 product i * width would overflow (width > 2^31 / 3000)."""
    lo = np.array([10, 0, 5, 1, 7, 0, 3], np.int32)
    width = np.array([490, 715_827, 715_828, 1_000_000, 2**31 - 9, 0, -4],
                     np.int64)
    hi = (lo + width).astype(np.int32)
    assert 2999 * int(width[3]) > 2**31 - 1
    for max_hits in (8, 3000):
        rows, valid = fm.expand_seed_hits(_t(lo), _t(hi), max_hits)
        jr, jv = fmindex.expand_seed_hits(jnp.asarray(lo), jnp.asarray(hi),
                                          max_hits)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    assert rows.dtype == torch.int64 and int(rows.max()) < 2**31

