"""The port's cloud EM (ema_tpu_torch.core.em) against the JAX package.

On the CPU the torch EM runs the same float64 program it runs on the card;
it must equal em_jax (x64, as tests/conftest.py sets it) and the host EM
(groups.run_em_host_batch, run_em_native) to rtol 1e-9 / atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _copy_states as _copy
from chip_smoke import deep_em_group
from ema_tpu import config
from ema_tpu.core import em_jax, groups
from ema_tpu_torch.core import em
from test_em_jax import _synthetic_group
from torch_handover import port_states

TOL = dict(rtol=1e-9, atol=1e-12)
CPU = torch.device("cpu")


def _states(platform, seed=3):
    """GroupStates of one emit batch: EM-gated groups of several sizes,
    one group under the 30-pair gate and, unless many_clouds, one group
    deeper than EM_NATIVE_C."""
    rng = np.random.default_rng(seed)
    profile = config.get_platform_profile(platform)
    out = []
    for n_pairs in (45, 31, 60, 5):
        recs, idents, _ = _synthetic_group(rng, n_pairs=n_pairs,
                                           profile=profile)
        out.append(groups.sweep_group(recs, idents, profile,
                                      n_pairs_in_group=n_pairs))
    recs, idents = deep_em_group()
    out.append(groups.sweep_group(recs, idents, profile))
    assert out[3].needs_em is False
    assert out[4].cmask.shape[1] > groups.EM_NATIVE_C and out[4].needs_em
    return out


@pytest.mark.parametrize("shape", [(20, 7), (3, 6, 5), (4, 1)])
def test_normalize_log_probs_matches_jax_and_numpy(shape):
    from ema_tpu.utils.logprobs import normalize_log_probs_batch

    rng = np.random.default_rng(0)
    p = -rng.random(shape) * 30
    p.reshape(-1)[::5] = -200.0                   # below the 1e-50 floor
    mask = rng.random(shape) < 0.7
    flat = mask.reshape(-1, shape[-1])
    flat[0] = False                               # an empty row
    if flat.shape[0] > 1:
        flat[1] = False
        flat[1, -1] = True                        # a single-candidate row
    got = em.normalize_log_probs(torch.from_numpy(p),
                                 torch.from_numpy(mask)).numpy()
    want = np.asarray(em_jax.normalize_log_probs_jnp(p, mask))
    np.testing.assert_allclose(got, want, **TOL)
    host = normalize_log_probs_batch(p.reshape(-1, shape[-1]),
                                     flat).reshape(shape)
    np.testing.assert_allclose(got, host, **TOL)
    assert got.dtype == np.float64


def _random_inputs(seed, narrow):
    """The padded batch of test_em_jax.py:75, with one group gated off and
    (``narrow``) the integer planes narrowed as the dispatch uploads them."""
    rng = np.random.default_rng(seed)
    G, E, C, NC = 3, 10, 4, 12
    sh = (G, E, C)
    mate = np.broadcast_to((np.arange(E) ^ 1).astype(np.int32), (G, E)).copy()
    mate[1, 4:6] = -1                                 # unpaired entries
    kw = dict(
        score=-rng.random(sh) * 12, cmask=rng.random(sh) < 0.7,
        active=rng.random(sh) < 0.9,
        cand_cloud=rng.integers(0, NC, sh).astype(np.int32),
        rec_chrom=rng.integers(0, 2, sh).astype(np.int32),
        rec_pos=rng.integers(1, 5_000, sh).astype(np.int32),
        rec_rev=rng.integers(0, 2, sh).astype(np.int32),
        mate_entry=mate, emask=np.ones((G, E), bool),
        comp=np.broadcast_to(np.arange(NC, dtype=np.int32) // 3,
                             (G, NC)).copy(),
        run_em=np.array([True, False, True]))
    kw["cmask"][:, :, 0] = True
    kw["emask"][2, 8:] = False
    kw["cmask"][2, 8:] = False
    tk = dict(kw)
    if narrow:
        for k in ("cand_cloud", "rec_chrom", "mate_entry", "comp"):
            tk[k] = kw[k].astype(np.int16)
        tk["rec_rev"] = kw["rec_rev"].astype(np.int8)
    return kw, tk


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("narrow", [False, True])
def test_em_run_matches_em_jax(many, narrow):
    kw, tk = _random_inputs(4, narrow)
    want_g, want_w = em_jax.em_run(
        em_jax.EMInputs(**{k: jnp.asarray(v) for k, v in kw.items()}),
        many=many)
    got_g, got_w = em.em_run(
        em.EMInputs(**{k: torch.from_numpy(v) for k, v in tk.items()}),
        many=many)
    assert got_g.dtype == torch.float64 and got_w.dtype == torch.float64
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    # the gated-off group keeps its score-normalized init gammas
    init = em.normalize_log_probs(torch.from_numpy(kw["score"][1]),
                                  torch.from_numpy(kw["cmask"][1]))
    np.testing.assert_array_equal(got_g[1].numpy(), init.numpy())


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_em_run_on_swept_groups_matches_em_jax(platform):
    """em_run on the packed states of real sweeps == em_jax.em_run."""
    states = [st for st in _states(platform) if st.needs_em
              and st.cmask.shape[1] <= groups.EM_NATIVE_C]
    d, (G, E, C, NC) = groups._pack_states(states)
    d["run_em"] = np.ones(G, bool)
    many = states[0].many
    want_g, want_w = em_jax.em_run(
        em_jax.EMInputs(**{k: jnp.asarray(v) for k, v in d.items()}),
        many=many)
    got_g, got_w = em.em_run(
        em.EMInputs(**{k: torch.from_numpy(v) for k, v in d.items()}),
        many=many)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_dispatch_matches_host_native_and_jax(platform):
    """dispatch_em_batch on the CPU == run_em_host_batch (per-group numpy
    and C++ for the deep group) == groups.dispatch_em_device_batch."""
    states = _states(platform)
    host, dev, jx, nat = (_copy(states) for _ in range(4))
    dev = port_states(dev)
    groups.run_em_host_batch(host)
    wait = em.dispatch_em_batch(dev, CPU)
    wait()
    groups.dispatch_em_device_batch(jx)()
    for st in nat:
        if st.needs_em:
            groups.run_em_native(st)
    for s0, h, d, j, n in zip(states, host, dev, jx, nat):
        np.testing.assert_allclose(d.gammas, h.gammas, **TOL)
        np.testing.assert_allclose(d.gammas, j.gammas, **TOL)
        np.testing.assert_allclose(d.gammas, n.gammas, **TOL)
        assert d.gammas.shape == s0.cmask.shape
    # the gated group kept its sweep gammas; EM moved the others
    np.testing.assert_array_equal(dev[3].gammas, states[3].gammas)
    assert not np.allclose(dev[0].gammas, states[0].gammas)


def test_dispatch_is_deterministic_and_skips_empty():
    states = _states("10x")
    a, b = port_states(_copy(states)), port_states(_copy(states))
    em.dispatch_em_batch(a, CPU)()
    em.dispatch_em_batch(b, CPU)()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.gammas, y.gammas)
    # no EM-gated group: nothing to launch
    small = port_states(st for st in _copy(states) if not st.needs_em)
    em.dispatch_em_batch(small, CPU)()
    assert em.dispatch_em_batch([], CPU)() is None


def test_deep_group_gammas_concentrate():
    """The deep pair's in-cloud candidate wins through the native flat EM
    that dispatch_em_batch sends it to (test_em_jax.py:140)."""
    recs, idents = deep_em_group()
    [st] = port_states([groups.sweep_group(
        recs, idents, config.get_platform_profile("10x"))])
    em.dispatch_em_batch([st], CPU)()
    deep = np.nonzero(st.cmask.sum(axis=1) > groups.EM_NATIVE_C)[0]
    assert deep.size == 2
    for e in deep:
        best = int(np.argmax(st.gammas[e]))
        assert st.R["pos"][st.cand_rec[e, best]] < 10_000
        assert st.gammas[e, best] > 0.9
