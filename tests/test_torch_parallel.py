"""The port's mesh layer (ema_tpu_torch.parallel: mesh, step,
bench_scaling) and the Aligner's data split against the JAX package's
(ema_tpu.parallel, the meshed ema_tpu Aligner), on the CPU.

JAX runs on its virtual 8-device CPU mesh (tests/conftest.py); the port's
meshes are lists of ``"cpu"`` devices.  The same seeded numpy inputs go
through both.  Every comparison is exact: the step's outputs are int32,
the Aligner's SAM is compared byte for byte; the tolerance is zero.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ema_tpu import config
from ema_tpu.core import pipeline as jax_pipeline
from ema_tpu.index import build_index, fmindex
from ema_tpu.parallel import make_mesh as jax_make_mesh
from ema_tpu.parallel import make_sharded_candidate_step as jax_sharded
from ema_tpu.parallel import mesh as jax_mesh
from ema_tpu.parallel import step as jax_step
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.index import fm as port_fm
from ema_tpu_torch.parallel import (bench_scaling, candidate_core,
                                    make_mesh, make_sharded_candidate_step,
                                    mesh_axes)
from ema_tpu_torch.parallel import mesh as port_mesh
from ema_tpu_torch.parallel import step as port_step
from simulate import rand_genome, simulate_pairs, to_str
from torch_handover import Aligner, port_index
from torch_handover import jax_native_built  # noqa: F401 (autouse)

STATIC = dict(max_seeds=4, window_pad=12, min_seed_len=19)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while this module runs: its calls alternate
    with JAX's, whose XLA thread pools would otherwise compete with
    torch's idle OpenMP workers on the cores the xdist workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(idx):
    """(JAX fm, JAX text, port fm, port text) of one JAX index."""
    return (fmindex.FMIndexArrays.from_index(idx), jnp.asarray(idx.text),
            port_fm.FMIndexArrays.from_index(port_index(idx),
                                             torch.device("cpu")),
            torch.from_numpy(idx.text))


def _reads(rng, text, n_reads, L, mut=0.01):
    starts = rng.integers(0, text.shape[0] - L, n_reads)
    reads = np.stack([text[s:s + L] for s in starts]).astype(np.int32)
    hit = rng.random((n_reads, L)) < mut
    reads = np.where(hit, rng.integers(0, 4, reads.shape), reads)
    return reads.astype(np.int32), np.full(n_reads, L, np.int32), starts


@pytest.fixture(scope="module")
def toy():
    """tests/test_parallel.py's world: 6 kbp, sa_rate 8, 16 reads of 80 bp
    with 1% substitutions."""
    rng = np.random.default_rng(5)
    idx = build_index({"c1": rng.integers(0, 4, 6000).astype(np.uint8)},
                      sa_rate=8)
    reads, lens, starts = _reads(rng, idx.text, 16, 80)
    return idx, _both(idx), reads, lens, starts


def _jax_core(w, reads, lens, ci=0, **kw):
    fm, text = w[0], w[1]
    b, g = jax_step.candidate_core(fm, text, jnp.asarray(reads),
                                   jnp.asarray(lens), ci, **kw)
    return np.asarray(b), np.asarray(g)


def _port_core(w, reads, lens, ci=0, **kw):
    b, g = candidate_core(w[2], w[3], torch.from_numpy(reads),
                          torch.from_numpy(lens), ci, **kw)
    assert b.dtype == torch.int32 and g.dtype == torch.int32
    return b.numpy(), g.numpy()


# ----------------------------------------------------------------------
# mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_factor_devices_and_axes_equal_jax(n):
    assert port_mesh.factor_devices(n) == jax_mesh.factor_devices(n)
    assert mesh_axes() == jax_mesh.mesh_axes() == ("data", "cand")


def test_make_mesh_defaults_to_the_cards():
    """No devices named: every visible card; with none, it raises rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(devices=["cuda:0", "cuda:0"])


def test_make_mesh_shape_and_mismatch():
    m = make_mesh(devices=["cpu"] * 4)
    assert m.shape == {"data": 4, "cand": 1} and m.size == 4
    m = make_mesh(2, 2, ["cpu"] * 4)
    assert m.shape == {"data": 2, "cand": 2}
    assert m.distinct_devices == [torch.device("cpu")]
    assert all(s is None for row in m.streams for s in row)
    for nd, nc, n in ((3, 2, 4), (2, 1, 3)):
        with pytest.raises(ValueError, match=f"mesh {nd}x{nc} != {n} "
                                             "devices"):
            make_mesh(nd, nc, ["cpu"] * n)
        with pytest.raises(ValueError, match=f"mesh {nd}x{nc} != {n} "
                                             "devices"):
            jax_make_mesh(nd, nc, jax.devices()[:n])


# ----------------------------------------------------------------------
# step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k_local,n_shards", [(4, 1), (4, 2), (2, 4),
                                              (3, 5)])
def test_expand_hits_shard_equals_jax(k_local, n_shards):
    """Slot numbering and the split, overflow-safe stride, including
    SA-interval widths where ``i * width`` passes 2**31."""
    rng = np.random.default_rng(k_local * 10 + n_shards)
    lo = rng.integers(0, 1 << 20, (6, 5)).astype(np.int32)
    width = np.concatenate([
        rng.integers(0, 2 * k_local * n_shards, (6, 3)),
        rng.integers(1 << 28, (1 << 31) - (1 << 21), (6, 2))],
        axis=1).astype(np.int64)
    width[0, 0] = 0
    width[1, 1] = k_local * n_shards           # exactly the cap
    hi = (lo + width).astype(np.int32)
    big = (np.arange(k_local * n_shards)[:, None] * width[width > 1 << 28]
           [None, :])
    assert big.max() > 1 << 31
    for shard in range(n_shards):
        jr, jv = jax_step._expand_hits_shard(
            jnp.asarray(lo), jnp.asarray(hi), k_local,
            jnp.asarray(shard, jnp.int32), n_shards)
        pr, pv = port_step._expand_hits_shard(
            torch.from_numpy(lo), torch.from_numpy(hi), k_local, shard,
            n_shards)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_candidate_core_equals_jax(toy, n_shards):
    """Every cand index of an n_shards split: best score and window start
    equal to JAX's, exactly."""
    idx, w, reads, lens, _ = toy
    kw = dict(STATIC, hits_per_seed=8 // n_shards, n_cand_shards=n_shards)
    for ci in range(n_shards):
        jb, jg = _jax_core(w, reads, lens, ci, **kw)
        pb, pg = _port_core(w, reads, lens, ci, **kw)
        np.testing.assert_array_equal(pb, jb)
        np.testing.assert_array_equal(pg, jg)
        # a unique genome: one hit a seed, which is slot 0 of shard 0
        assert ((pb > 0).sum() >= len(pb) // 2) if ci == 0 \
            else (pb < 0).all()


@pytest.mark.parametrize("n_data,n_cand", [(8, 1), (4, 2), (2, 4)])
def test_sharded_equals_single_device(toy, n_data, n_cand):
    """tests/test_parallel.py's test on the port: the step over
    ["cpu"] * 8 equals the port's single-device core and JAX's sharded
    step; its sums equal the host's."""
    idx, w, reads, lens, _ = toy
    k_total = 8
    sb, sg = _port_core(w, reads, lens, 0, hits_per_seed=k_total,
                        n_cand_shards=1, **STATIC)
    step = make_sharded_candidate_step(make_mesh(n_data, n_cand, CPU8),
                                       w[2], w[3],
                                       hits_per_seed=k_total // n_cand,
                                       **STATIC)
    out = step(torch.from_numpy(reads), torch.from_numpy(lens))
    assert all(t.dtype == torch.int32 for t in out)
    np.testing.assert_array_equal(out.best_score.numpy(), sb)
    np.testing.assert_array_equal(out.best_gpos.numpy(), sg)
    assert int(out.n_aligned) == int((sb > 0).sum())
    assert int(out.sum_score) == int(sb[sb > 0].sum())
    assert step.cell_rows == {(d, c): 16 // n_data for d in range(n_data)
                              for c in range(n_cand)}

    jout = jax_sharded(jax_make_mesh(n_data, n_cand), w[0], w[1],
                       hits_per_seed=k_total // n_cand, **STATIC)(
        jnp.asarray(reads), jnp.asarray(lens))
    for got, want in zip(out, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_step_refuses_an_uneven_batch(toy):
    idx, w, reads, lens, _ = toy
    step = make_sharded_candidate_step(make_mesh(3, 1, ["cpu"] * 3),
                                       w[2], w[3], **STATIC)
    with pytest.raises(ValueError, match="not divisible"):
        step(torch.from_numpy(reads), torch.from_numpy(lens))


def test_step_finds_true_positions(toy):
    idx, w, reads, lens, starts = toy
    step = make_sharded_candidate_step(make_mesh(4, 2, CPU8), w[2], w[3],
                                       hits_per_seed=4, **STATIC)
    out = step(torch.from_numpy(reads), torch.from_numpy(lens))
    gpos, score = out.best_gpos.numpy(), out.best_score.numpy()
    L = int(lens[0])
    hit = np.abs((gpos + STATIC["window_pad"]) - starts) \
        <= STATIC["window_pad"]
    assert (score > 0.8 * L).mean() >= 0.8
    assert hit[score > 0.8 * L].mean() >= 0.9


def test_ties_across_cand_shards():
    """A genome holding one 400 bp unit four times: a read from the unit
    scores the same in every copy, so its best ties within a shard and
    across the cand shards.  The port's step takes JAX's winner (the
    first maximum, per shard and then over shards) at every mesh, and its
    best scores equal the single-device core's."""
    rng = np.random.default_rng(8)
    unit = rng.integers(0, 4, 400).astype(np.uint8)
    parts = []
    for _ in range(4):
        parts += [rng.integers(0, 4, 700).astype(np.uint8), unit]
    idx = build_index({"c1": np.concatenate(parts)}, sa_rate=4)
    w = _both(idx)
    reads = np.stack([unit[s:s + 80] for s in
                      rng.integers(0, 320, 16)]).astype(np.int32)
    lens = np.full(16, 80, np.int32)
    sb, sg = _port_core(w, reads, lens, 0, hits_per_seed=4,
                        n_cand_shards=1, **STATIC)
    per_shard = [_port_core(w, reads, lens, c, hits_per_seed=1,
                            n_cand_shards=4, **STATIC)[0]
                 for c in range(4)]
    tied = np.sum([b == sb for b in per_shard], axis=0)
    assert (tied >= 2).sum() >= 8, tied
    for n_data, n_cand in ((8, 1), (4, 2), (2, 4)):
        kw = dict(STATIC, hits_per_seed=4 // n_cand)
        out = make_sharded_candidate_step(
            make_mesh(n_data, n_cand, CPU8), w[2], w[3], **kw)(
            torch.from_numpy(reads), torch.from_numpy(lens))
        jout = jax_sharded(jax_make_mesh(n_data, n_cand), w[0], w[1],
                           **kw)(jnp.asarray(reads), jnp.asarray(lens))
        for got, want in zip(out, jout):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(out.best_score.numpy(), sb)


def test_text_shorter_than_the_window():
    """n < W: the JAX step clamps window columns to the last base, where
    the port's gather reads a sentinel past the text; the port extends the
    text and matches JAX exactly."""
    rng = np.random.default_rng(4)
    idx = build_index({"c1": rng.integers(0, 4, 100).astype(np.uint8)},
                      sa_rate=2)
    w = _both(idx)
    reads, lens, _ = _reads(rng, idx.text, 8, 80, mut=0.0)
    reads[:, 70:] = rng.integers(0, 4, (8, 10))
    lens[3] = 60
    kw = dict(STATIC, hits_per_seed=4)
    assert idx.n < 80 + 2 * kw["window_pad"]
    jb, jg = _jax_core(w, reads, lens, **kw)
    pb, pg = _port_core(w, reads, lens, **kw)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pg, jg)
    assert (pb > 0).all()


# ----------------------------------------------------------------------
# the Aligner's data split
# ----------------------------------------------------------------------

def _env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    return saved


def _restore(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def meshed_world():
    """tests/test_parallel.py:74-119's world (80 kbp, 4 barcodes) and the
    JAX Aligner's SAM on its 8-device mesh, with the banded scorer and
    device locate."""
    saved = _env(EMA_TPU_SW_IMPL="banded", EMA_TPU_SEED_IMPL="device")
    try:
        rng = np.random.default_rng(29)
        genome = rand_genome(rng, 80_000)
        idx = build_index({"chr1": genome})
        ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
            rng, to_str(genome), n_barcodes=4, frags_per_bc=(2, 3),
            pairs_per_frag=(12, 20), frag_len=12_000, read_len=100,
            err=0.003)
        pairs = (ids, bcs, s1, q1, s2, q2)
        meshed = jax_pipeline.Aligner(idx, config.RunConfig())
        assert meshed._data_sharding.mesh.size == 8
        want = meshed.align_batch_to_sam(
            jax_pipeline.ReadBatch.from_pairs(*pairs))
    finally:
        _restore(saved)
    return idx, pairs, want


@pytest.mark.parametrize("n_dev", [2, 3])
def test_full_pipeline_meshed_sam_equality(meshed_world, n_dev):
    """The port's Aligner on ["cpu"] * 2 and ["cpu"] * 3 (an uneven split
    of every call) emits the one-device SAM and the meshed JAX Aligner's,
    byte for byte, with the banded scorer and device locate."""
    idx, pairs, want = meshed_world
    single = Aligner(idx, config.RunConfig(), device="cpu",
                     seed_impl="device")
    assert single.mesh is None
    meshed = Aligner(idx, config.RunConfig(), device="cpu",
                     seed_impl="device", devices=["cpu"] * n_dev)
    assert meshed.mesh.shape == {"data": n_dev, "cand": 1}
    batch = ReadBatch.from_pairs(*pairs)
    sam_m = meshed.align_batch_to_sam(batch)
    assert sam_m == single.align_batch_to_sam(batch)
    assert sam_m == want
    assert len(sam_m) >= 2 * len(pairs[0])


def _repeat_world():
    """An 80 kbp genome with a 2 kbp unit copied 8 times, and pairs of
    which the first 48 have their first read in the unit (8 hits a
    seed)."""
    rng = np.random.default_rng(31)
    genome = rand_genome(rng, 80_000)
    unit = genome[1000:3000].copy()
    for at in range(10_000, 80_000, 9_000):
        genome[at:at + 2000] = unit
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, to_str(genome), n_barcodes=4, frags_per_bc=(2, 3),
        pairs_per_frag=(12, 20), frag_len=12_000, read_len=100, err=0.003)
    unit_s = to_str(unit)
    for i in range(48):
        a = int(rng.integers(0, 1800))
        s1[i] = unit_s[a:a + 100]
    return build_index({"chr1": genome}), (ids, bcs, s1, q1, s2, q2)


@pytest.fixture(scope="module")
def repeat_world():
    return _repeat_world()


@pytest.mark.parametrize("n_pairs", [132, 96], ids=["block", "batch"])
def test_meshed_seed_budget_overflow(repeat_world, monkeypatch, n_pairs):
    """Greedy seeding on the device: the fused seed+locate's hit budget
    (4 a read).  48 pairs in the repeat unit come first.  ``block``: with
    84 unique pairs behind them the batch's hits fill its budget exactly,
    while the first of 3 data blocks overflows its own and is run again
    with its total; ``batch``: with 48 the batch overflows and the
    unbounded two-step path runs on every block.  Both give the one-device
    SAM and the JAX Aligner's."""
    idx, pairs = repeat_world
    pairs = tuple(col[:n_pairs] for col in pairs)
    calls = []
    real = port_fm.seed_locate_reads

    def spy(fma, reads, lens, **kw):
        out = real(fma, reads, lens, **kw)
        calls.append((reads.shape[0], kw["budget"], int(out[1])))
        return out

    monkeypatch.setattr(port_fm, "seed_locate_reads", spy)
    cfg = config.RunConfig(aligner=config.AlignerParams(seeding="greedy"))
    batch = ReadBatch.from_pairs(*pairs)
    single = Aligner(idx, cfg, device="cpu", seed_impl="device")
    sam_s = single.align_batch_to_sam(batch)
    rows, budget, total = calls[0]
    assert len(calls) == 1 and rows == 2 * n_pairs
    assert (total > budget) == (n_pairs == 96)
    assert n_pairs == 96 or total == budget
    calls.clear()
    meshed = Aligner(idx, cfg, device="cpu", seed_impl="device",
                     devices=["cpu"] * 3)
    assert meshed.align_batch_to_sam(batch) == sam_s
    assert sum(c[2] for c in calls[:3]) == total
    if n_pairs == 132:
        # block 0 overflowed its budget and ran again with its total
        assert len(calls) == 4 and calls[0][2] > calls[0][1]
        assert calls[3] == (calls[0][0], calls[0][2], calls[0][2])
    else:
        assert len(calls) == 3
    saved = _env(EMA_TPU_SEED_IMPL="device")
    try:
        want = jax_pipeline.Aligner(idx, cfg).align_batch_to_sam(
            jax_pipeline.ReadBatch.from_pairs(*pairs))
    finally:
        _restore(saved)
    assert sam_s == want


def test_sharded_aligner_takes_the_devices():
    from ema_tpu.index import build_index_sharded
    from torch_handover import ShardedAligner

    rng = np.random.default_rng(3)
    contigs = {f"c{i}": rand_genome(rng, 30_000) for i in range(2)}
    sharded = build_index_sharded(contigs, max_shard_bases=40_000)
    sa = ShardedAligner(sharded, config.RunConfig(), device="cpu",
                        devices=["cpu"] * 2)
    assert sa.mesh.shape["data"] == 2
    assert all(sub.mesh.shape["data"] == 2 for sub in sa.subs)


@pytest.mark.slow
def test_full_pipeline_meshed_sam_equality_bench_scale():
    """The bench-scale twin of tests/test_parallel.py:118 on the port
    (__graft_entry__._dryrun_full_pipeline's world: 1.2 Mbp with diverged
    repeat families, 5,600 pairs, the density optimizer on): the port's
    Aligner on ["cpu"] * 3 equals the one-device run and the JAX
    Aligner's 8-device run."""
    saved = _env(EMA_TPU_SW_IMPL="banded", EMA_TPU_SEED_IMPL="device")
    try:
        rng = np.random.default_rng(17)
        genome_bp, n_pairs = 1_200_000, 5_600
        genome = rand_genome(rng, genome_bp)
        unit = max(genome_bp // 400, 2_000)
        for fam in range(3):
            src = int(rng.integers(0, genome_bp - unit))
            u = genome[src:src + unit].copy()
            for c in range(6):
                at = int(rng.integers(0, genome_bp - unit))
                cp = u.copy()
                nmut = int(0.005 * unit) * (c % 3)
                if nmut:
                    pp = rng.integers(0, unit, nmut)
                    cp[pp] = (cp[pp] + rng.integers(1, 4, nmut)) % 4
                genome[at:at + unit] = cp
        idx = build_index({"chr1": genome})
        ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
            rng, to_str(genome), n_barcodes=max(n_pairs // 40, 6),
            frags_per_bc=(2, 3), pairs_per_frag=(15, 25), frag_len=15_000,
            read_len=100, err=0.003)
        pairs = (ids, bcs, s1, q1, s2, q2)
        cfg = config.RunConfig(apply_density_opt=True)
        want = jax_pipeline.Aligner(idx, cfg).align_batch_to_sam(
            jax_pipeline.ReadBatch.from_pairs(*pairs))
        batch = ReadBatch.from_pairs(*pairs)
        got = Aligner(idx, cfg, device="cpu", seed_impl="device",
                      devices=["cpu"] * 3).align_batch_to_sam(batch)
        single = Aligner(idx, cfg, device="cpu",
                         seed_impl="device").align_batch_to_sam(batch)
    finally:
        _restore(saved)
    assert got == single == want
    assert len(got) >= 10_000


def test_aligner_devices_default():
    """devices=None: on the CPU the Aligner's own device alone (no mesh);
    a card run meshes over every visible card."""
    rng = np.random.default_rng(1)
    idx = build_index({"c": rng.integers(0, 4, 5000).astype(np.uint8)})
    assert Aligner(idx, device="cpu").mesh is None
    assert Aligner(idx, config.RunConfig(data_parallel_chips=False),
                   device="cpu").mesh is None


# ----------------------------------------------------------------------
# bench_scaling
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_partition_check_on_cpu(n):
    got = bench_scaling.partition_check(n, devices=["cpu"] * n)
    nd, nc = port_mesh.factor_devices(n)
    assert got["ok"] and got["partition_ok"]
    assert got["mesh"] == {"data": nd, "cand": nc}
    assert got["rows_per_device"] == 4 and got["batch"] == 4 * nd
    assert got["collectives_in_hlo"] == (
        ["cand-argmax", "data-sum"] if nc > 1 else ["data-sum"])


def test_measure_keys_and_no_card_exit(capsys):
    got = bench_scaling.measure(per_device_pairs=4, genome_bases=20_000,
                                repeats=1, devices=["cpu"] * 2)
    assert set(got) == {"metric", "n_devices", "reads_per_s_1dev",
                        "reads_per_s_ndev", "value", "unit"}
    assert got["n_devices"] == 2 and got["reads_per_s_ndev"] > 0
    if not torch.cuda.is_available():
        assert bench_scaling.main([]) == 1
        assert "is_available() is false" in capsys.readouterr().err
