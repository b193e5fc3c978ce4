"""The port's cloud EM (ema_tpu_torch.core.em) against the JAX package.

On the CPU the dispatch runs em_run, the plain version of the card's
cloud-EM kernel, on the kernel's flat pack; it must equal em_jax (x64, as
tests/conftest.py sets it) and the host EM (groups.run_em_host_batch,
run_em_native) to rtol 1e-9 / atol 1e-12.  The kernel itself runs only on
a card (chip_smoke.phase_em); here a numpy emulation of its per-block
arithmetic (``emulate_em_cloud``) is held to em_run and em_jax.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _copy_states as _copy
from chip_smoke import deep_em_group
from ema_tpu import config
from ema_tpu.core import em_jax, groups
from ema_tpu_torch.core import em
from ema_tpu_torch.core import groups as port_groups
from ema_tpu_torch.ops import em_cloud
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


# --- the flat pack and the cloud-EM kernel (csrc/em_cloud.cu) ------------

def _single_candidate_group(rng, n_pairs, bc=11):
    """A group whose every mate has one candidate: its entries normalise
    to exactly 1.0 before and after the EM."""
    from ema_tpu.core.records import empty_records

    recs = empty_records(2 * n_pairs)
    for p in range(n_pairs):
        anchor = 50_000 + 300 * p
        for mate in (0, 1):
            i = 2 * p + mate
            recs["pair"][i], recs["mate"][i] = p, mate
            recs["pos"][i] = anchor + 200 * mate
            recs["rev"][i], recs["bc"][i] = mate, bc
            recs["score"][i] = -float(rng.random() * 8)
    return recs, np.array([f"s{p}" for p in range(n_pairs) for _ in (0, 1)],
                          dtype=object)


def _kernel_batch(platform, seed=5):
    """One dispatch's groups (the port's GroupStates): an empty group, one
    under the 30-pair gate, one of single candidates, shallow EM-gated
    groups, one deeper than EM_NATIVE_C and one too large for the kernel's
    shared memory (more than SMEM_MAX / 8 candidates)."""
    from ema_tpu.core.records import empty_records

    rng = np.random.default_rng(seed)
    profile = config.get_platform_profile(platform)
    out = [groups.sweep_group(empty_records(0), np.zeros(0, object),
                              profile)]
    for n_pairs in (5, 45, 1700):
        recs, idents, _ = _synthetic_group(rng, n_pairs=n_pairs,
                                           profile=profile)
        out.append(groups.sweep_group(recs, idents, profile,
                                      n_pairs_in_group=n_pairs))
    out.append(groups.sweep_group(*_single_candidate_group(rng, 40),
                                  profile, n_pairs_in_group=40))
    out.append(groups.sweep_group(*deep_em_group(), profile))
    return port_states(out)


def _shallow(states):
    return [st for st in states
            if st.needs_em and st.cmask.shape[1] <= groups.EM_NATIVE_C]


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_kernel_batch_holds_every_kind_of_group(platform):
    states = _kernel_batch(platform)
    empty, shut, small, big, single, deep = states
    assert empty.n_entries == 0 and not empty.needs_em
    assert not shut.needs_em
    assert deep.needs_em and deep.cmask.shape[1] > groups.EM_NATIVE_C
    assert single.needs_em and single.cmask.shape[1] == 1
    pack = em.pack_states(_shallow(states))
    n_cand = np.diff(pack.cand_off[pack.e_off])
    smem, fits = em_cloud.smem_plan(n_cand, np.diff(pack.k_off))
    assert fits.tolist() == [True, False, True]     # small, big, single
    assert 0 < smem <= em_cloud.SMEM_MAX
    assert 8 * (n_cand[1] + 2 * big.n_clouds) > em_cloud.SMEM_MAX


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_flat_pack_layout(platform):
    """The pack holds each group's cmask-selected candidates in order, and
    its two CSR lists give every cloud's candidates and every chain's
    clouds in ascending order."""
    states = _shallow(_kernel_batch(platform))
    pack = em.pack_states(states)
    for (name, dtype), a in zip(em_cloud.FIELDS, pack, strict=True):
        assert a.dtype == dtype and a.ndim == 1 and a.flags.c_contiguous
    for g, st in enumerate(states):
        e0, e1 = pack.e_off[g], pack.e_off[g + 1]
        k0, k1 = pack.k_off[g], pack.k_off[g + 1]
        c0, c1 = pack.cand_off[e0], pack.cand_off[e1]
        cm, R = st.cmask, st.R
        rows = R[st.cand_rec[cm]]
        np.testing.assert_array_equal(np.diff(pack.cand_off[e0:e1 + 1]),
                                      cm.sum(axis=1))
        np.testing.assert_array_equal(pack.mate[e0:e1], st.mate_entry)
        np.testing.assert_array_equal(pack.score[c0:c1], rows["score"])
        np.testing.assert_array_equal(pack.cloud[c0:c1], st.cand_cloud[cm])
        np.testing.assert_array_equal(pack.chrom[c0:c1], rows["chrom"])
        np.testing.assert_array_equal(pack.pos[c0:c1], rows["pos"])
        np.testing.assert_array_equal(pack.flags[c0:c1] & 1, rows["rev"])
        np.testing.assert_array_equal(
            pack.flags[c0:c1] >> 1, rows["active"] & ~rows["duplicate"])
        np.testing.assert_array_equal(pack.comp[k0:k1], st.comp)
        for k in range(k1 - k0):
            members = pack.cloud_cands[pack.cloud_cand_off[k0 + k]:
                                       pack.cloud_cand_off[k0 + k + 1]]
            np.testing.assert_array_equal(
                members, np.nonzero(pack.cloud[c0:c1] == k)[0])
            chain = pack.comp_clouds[pack.comp_cloud_off[k0 + k]:
                                     pack.comp_cloud_off[k0 + k + 1]]
            np.testing.assert_array_equal(chain,
                                          np.nonzero(st.comp == k)[0])


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_flat_pack_plain_version_writes_em_runs_padded_gammas(platform):
    """dispatch_em_batch on the CPU (flat pack -> em_run_flat -> write
    back) gives, bit for bit, the gammas of em_run on the groups padded by
    groups._pack_states; the gate-shut and empty groups keep theirs, and
    the deep group takes the native EM."""
    states = _kernel_batch(platform)
    shallow = _shallow(_copy(states))
    d, (G, E, C, NC) = port_groups._pack_states(shallow)
    d["run_em"] = np.ones(G, bool)
    want, _ = em.em_run(em.EMInputs(**{k: torch.from_numpy(v)
                                       for k, v in d.items()}),
                        many=shallow[0].many)
    dev, nat = _copy(states), _copy(states)
    em.dispatch_em_batch(dev, CPU)()
    port_groups.run_em_native(nat[5])
    for g, st in enumerate(_shallow(dev)):
        e, c = st.cmask.shape
        np.testing.assert_array_equal(st.gammas, want[g, :e, :c].numpy())
    for i in (0, 1):
        np.testing.assert_array_equal(dev[i].gammas, states[i].gammas)
    np.testing.assert_array_equal(dev[5].gammas, nat[5].gammas)
    single = dev[4]
    np.testing.assert_array_equal(single.gammas, single.cmask * 1.0)


def emulate_em_cloud(pack, many: bool, iters: int = config.EM_ITERS):
    """A numpy emulation of csrc/em_cloud.cu: each block's arithmetic in
    its order (a thread's entry in candidate order, each cloud's and each
    chain's sum over its CSR list), in float64 scalars; returns the flat
    gammas."""
    out = np.zeros(pack.score.size)
    cand_off = pack.cand_off.tolist()
    score, cloud = pack.score.tolist(), pack.cloud.tolist()
    chrom, pos = pack.chrom.tolist(), pack.pos.tolist()
    rev = (pack.flags & 1).tolist()
    active = (pack.flags & 2 != 0).tolist()
    mate, comp = pack.mate.tolist(), pack.comp.tolist()
    cc_off, cc = pack.cloud_cand_off.tolist(), pack.cloud_cands.tolist()
    kc_off, kc = pack.comp_cloud_off.tolist(), pack.comp_clouds.tolist()
    log_eps = math.log(1e-50)

    def normalize(p):
        n = len(p)
        if n == 1:
            return [1.0]
        mx = max(p)
        thresh = log_eps - math.log(n)
        v = [math.exp(x - mx) if x - mx >= thresh else 0.0 for x in p]
        total = 0.0
        for x in v:
            total += x
        return [x / total if total > 0 else 0.0 for x in v]

    for g in range(pack.e_off.size - 1):
        e0, e1 = int(pack.e_off[g]), int(pack.e_off[g + 1])
        k0, k1 = int(pack.k_off[g]), int(pack.k_off[g + 1])
        c0 = cand_off[e0]
        gam = [0.0] * (cand_off[e1] - c0)

        def weights(all_):
            w = []
            for k in range(k0, k1):
                acc = 0.0
                for i in cc[cc_off[k]:cc_off[k + 1]]:
                    if all_ or active[c0 + i]:
                        acc += gam[i]
                w.append(acc)
            if many:
                return w
            tot = []
            for k in range(k0, k1):
                acc = 0.0
                for j in kc[kc_off[k]:kc_off[k + 1]]:
                    acc += w[j]
                tot.append(acc)
            return [x / tot[comp[k0 + k]] if tot[comp[k0 + k]] > 0 else x
                    for k, x in enumerate(w)]

        def update(e, w):
            b, n = cand_off[e], cand_off[e + 1] - cand_off[e]
            m = mate[e]
            mb, me = (cand_off[e0 + m], cand_off[e0 + m + 1]) if m >= 0 \
                else (0, 0)
            wtot = 0.0
            if many:
                for c in range(n):
                    wtot += w[cloud[b + c]]
            new = []
            for c in range(n):
                i = b + c
                wv = w[cloud[i]]
                if many:
                    wv = wv / wtot if wtot > 0 else 0.0
                log_w = math.log(wv if wv > 0 else 1e-300)
                best = config.UNPAIRED_PENALTY
                if m >= 0:
                    bm = -math.inf
                    for j in range(mb, me):
                        if (cloud[j] != cloud[i] or chrom[j] != chrom[i]
                                or rev[j] == rev[i]):
                            continue
                        gm = gam[j - c0]
                        if gm == 0.0:
                            continue
                        d = pos[i] - pos[j] if rev[i] else pos[j] - pos[i]
                        pen = (0.0 if config.INSERT_MIN <= d
                               <= config.INSERT_MAX
                               else config.UNPAIRED_PENALTY)
                        bm = max(bm, pen + math.log(gm if gm > 0 else 1.0))
                    best = max(bm, config.UNPAIRED_PENALTY)
                new.append((score[i] + log_w) + best)
            gam[b - c0:b - c0 + n] = normalize(new)

        for e in range(e0, e1):
            b, n = cand_off[e], cand_off[e + 1] - cand_off[e]
            gam[b - c0:b - c0 + n] = normalize(score[b:b + n])
        w = weights(True)
        for _ in range(iters):
            for phase_b in (False, True):
                for e in range(e0, e1):
                    m = mate[e]
                    if (m >= 0 and e - e0 < m) == phase_b:
                        update(e, w)
            w = weights(False)
        out[c0:cand_off[e1]] = gam
    return out


@pytest.mark.parametrize("platform", ["10x", "tru"])
def test_kernel_emulation_matches_em_run_and_jax(platform):
    """The kernel's per-block arithmetic in its fixed summation order ==
    em_run (the plain version) and em_jax.em_run, to rtol 1e-9 / atol
    1e-12, on every kind of group the kernel takes (the overflowing group
    included: its storage differs, not its arithmetic)."""
    states = _shallow(_kernel_batch(platform))
    pack = em.pack_states(states)
    many = states[0].many
    got = emulate_em_cloud(pack, many)
    np.testing.assert_allclose(got, em.em_run_flat(pack, many), **TOL)
    d, (G, E, C, NC) = port_groups._pack_states(states)
    d["run_em"] = np.ones(G, bool)
    want_g, _ = em_jax.em_run(
        em_jax.EMInputs(**{k: jnp.asarray(v) for k, v in d.items()}),
        many=many)
    want_g = np.asarray(want_g)
    want = np.concatenate([want_g[g, :st.n_entries, :st.cmask.shape[1]][
        st.cmask] for g, st in enumerate(states)])
    np.testing.assert_allclose(got, want, **TOL)
    # the EM moved the gammas of the multimapping groups
    assert not np.allclose(got, np.concatenate(
        [st.gammas[st.cmask] for st in states]))
