"""The port's ShardedAligner and the Aligner's -x hooks against the JAX
package, on the CPU.

The world is tests/test_sharded_index.py's (4 contigs of 30-45 kbp,
forced into 3 shards).  The port's ShardedAligner must give the JAX
ShardedAligner's SAM byte for byte, and its own single-index Aligner's
with MI masked (MI numbering follows the visit order, as in
tests/test_sharded_index.py:27-28), under the default host paths, device
EM and device locate.  ``cloud_id_base`` (an int or a callable),
``group_sink`` and ``replay_sink`` are held to the JAX Aligner's.
"""

import re

import numpy as np
import pytest
import torch

from ema_tpu import config
from ema_tpu.core import pipeline as jax_pipeline
from ema_tpu.index import build_index, build_index_sharded
from ema_tpu.utils.replay import ReplayWriter as JaxReplayWriter
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.index.device import to_device_state
from ema_tpu_torch.utils.replay import ReplayWriter
from simulate import revcomp_str, rand_genome, simulate_pairs, to_str
from torch_handover import Aligner, ShardedAligner, port_index
from torch_handover import jax_native_built  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def world():
    """(contigs, pairs, single index, 3-shard index), as
    tests/test_sharded_index.py:14-24 builds them."""
    rng = np.random.default_rng(21)
    contigs = {f"c{i}": rand_genome(rng, 30_000 + 5_000 * i)
               for i in range(4)}
    genome_str = to_str(np.concatenate(list(contigs.values())))
    ids, _, bcs, s1, q1, s2, q2, _ = simulate_pairs(
        rng, genome_str, n_barcodes=5, frags_per_bc=(1, 3),
        pairs_per_frag=(6, 12), frag_len=12_000, read_len=80, err=0.003)
    single = build_index(dict(contigs))
    sharded = build_index_sharded(dict(contigs), max_shard_bases=70_000)
    assert sharded.n_shards == 3
    return contigs, (ids, bcs, s1, q1, s2, q2), single, sharded


CFG = config.RunConfig(batch_size=256)


def _norm(lines):
    return sorted(re.sub(r"\tMI:i:\d+", "\tMI:i:*", ln) for ln in lines)


@pytest.fixture(scope="module")
def jax_sharded_sam(world):
    _, pairs, _, sharded = world
    return jax_pipeline.ShardedAligner(sharded, CFG).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs))


# (Aligner keywords, RunConfig keywords)
PATHS = {"host": ({}, {}),
         "device_em": ({}, dict(device_em=True)),
         "seed_device": (dict(seed_impl="device"), {})}


@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_equals_jax_and_single(path, world, jax_sharded_sam):
    al_kw, cfg_kw = PATHS[path]
    _, pairs, single, sharded = world
    cfg = config.RunConfig(batch_size=256, **cfg_kw)
    sa = ShardedAligner(sharded, cfg, device="cpu", **al_kw)
    assert len(sa.subs) == 3 and sa.cfg.device_em == bool(cfg_kw)
    got = sa.align_batch_to_sam(ReadBatch.from_pairs(*pairs))
    assert len(got) >= 2 * len(pairs[0])
    assert got == jax_sharded_sam
    one = Aligner(single, cfg, device="cpu", **al_kw).align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert _norm(got) == _norm(one)


def test_sharded_aligner_takes_the_first_subs_choices(world):
    """The facade runs no Aligner.__init__: what iter_batch_sam reads
    comes from the first shard's aligner, and only the facade keeps an
    EM stream."""
    sharded = world[3]
    sa = ShardedAligner(sharded, config.RunConfig(device_em=True),
                        device="cpu", sw_impl="scan", seed_impl="device")
    first = sa.subs[0]
    assert (sa.device, sa.sw_impl, sa.seed_impl) == (
        first.device, "scan", "device")
    assert sa.cfg is first.cfg and sa.cfg.device_em
    assert all(s._defer_dist_window and s._em_stream is None
               for s in sa.subs)
    assert not sa._defer_dist_window and sa.replay_sink is None
    with pytest.raises(ValueError, match="no shards"):
        ShardedAligner(type(port_index(sharded))([], []), device="cpu")


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_device_state_of_every_shard(shard, world):
    """to_device_state carries each shard's text and FM arrays across."""
    sh = world[3].shards[shard]
    state = to_device_state(port_index(sh), torch.device("cpu"), fm=True)
    np.testing.assert_array_equal(state.text.numpy(), sh.text)
    for name in ("occ_blocks", "counts", "sa_mark_rank", "sa_values"):
        np.testing.assert_array_equal(getattr(state.fm, name).numpy(),
                                      getattr(sh, name))
    np.testing.assert_array_equal(
        state.fm.sa_mark_words.numpy().view(np.uint32), sh.sa_mark_words)
    assert (state.fm.primary, state.fm.n) == (sh.primary, sh.fm_n)


def _callable_base():
    """A per-group allocator as coalesced -x builds one: namespace by
    barcode parity, a counter per namespace."""
    counters = {}

    def alloc(bc, n_clouds):
        ns = bc % 2
        base = (ns << 20) + counters.get(ns, 0)
        counters[ns] = counters.get(ns, 0) + n_clouds
        return base
    return alloc


@pytest.mark.parametrize("base", ["int", "callable", "sink"])
def test_cloud_id_base_and_group_sink_equal_jax(base, world):
    """iter_batch_sam's MI namespaces and the group sink give the JAX
    Aligner's lines, ids and (bc, lines) calls, on the single index and
    on the sharded one."""
    _, pairs, single, sharded = world
    for idx, jax_cls, cls in (
            (single, jax_pipeline.Aligner, Aligner),
            (sharded, jax_pipeline.ShardedAligner, ShardedAligner)):
        out = {}
        for name, al, rb in (
                ("jax", jax_cls(idx, CFG), jax_pipeline.ReadBatch),
                ("port", cls(idx, CFG, device="cpu"), ReadBatch)):
            batch = rb.from_pairs(*pairs)
            sunk = []
            if base == "int":
                lines = al.align_batch_to_sam(batch, 1000)
            elif base == "callable":
                lines = al.align_batch_to_sam(batch, _callable_base())
            else:
                lines = [ln for part in al.iter_batch_sam(
                    batch, _callable_base(),
                    lambda bc, gl: sunk.append((bc, list(gl))))
                    for ln in part]
            out[name] = (lines, sunk)
        assert out["port"] == out["jax"]
        lines, sunk = out["port"]
        if base == "sink":
            assert not lines and len(sunk) >= 5
        else:
            mi = {int(m) for m in re.findall(r"\tMI:i:(\d+)",
                                             "".join(lines))}
            assert min(mi) >= 1000 if base == "int" else max(mi) >= 1 << 20


def test_replay_sink_equals_jax(world, tmp_path):
    """replay_sink sees every chunk's candidates: the replay file the
    reference oracle reads is the JAX Aligner's, byte for byte."""
    _, pairs, single, _ = world
    files = {}
    for name, al, rb, writer in (
            ("jax", jax_pipeline.Aligner(single, CFG),
             jax_pipeline.ReadBatch, JaxReplayWriter),
            ("port", Aligner(single, CFG, device="cpu"), ReadBatch,
             ReplayWriter)):
        w = writer(str(tmp_path / f"{name}.replay"), single.names,
                         list(single.lengths))
        al.replay_sink = w.add
        al.align_batch_to_sam(rb.from_pairs(*pairs))
        w.close()
        files[name] = (tmp_path / f"{name}.replay").read_text()
    assert files["port"] == files["jax"] and files["port"].count("\nE ")


def test_align_stream_flush_pairs_equals_jax(world):
    """align_stream with a small flush_pairs: many flush batches, the
    JAX package's lines."""
    _, (ids, bcs, s1, q1, s2, q2), single, _ = world
    groups = []
    order = np.argsort(bcs, kind="stable")
    for i in order:
        if groups and groups[-1][1][0] == bcs[i]:
            g = groups[-1]
        else:
            g = ([], [], [], [], [], [])
            groups.append(g)
        for lst, v in zip(g, (ids[i], bcs[i], s1[i], q1[i], s2[i], q2[i])):
            lst.append(v)
    want = [ln for part in jax_pipeline.Aligner(single, CFG).align_stream(
        iter(groups), flush_pairs=20) for ln in part]
    got = [ln for part in Aligner(single, CFG, device="cpu").align_stream(
        iter(groups), flush_pairs=20) for ln in part]
    assert len(got) >= 2 * len(ids) and got == want


def test_read_across_a_shard_boundary_as_in_jax():
    """A read across the boundary of two contigs held by different
    shards: the single index drops the crossing alignment (contig
    containment) and leaves the read unmapped, while its shard's text ends
    at the boundary, so the sharded index soft-clips it there and reports
    a mapped pair.  The JAX package does the same (ROADMAP C); the port
    keeps both behaviours byte for byte."""
    rng = np.random.default_rng(36)
    contigs = {"c0": rand_genome(rng, 30_000), "c1": rand_genome(rng, 30_000)}
    g0, g1 = to_str(contigs["c0"]), to_str(contigs["c1"])
    ids, _, bcs, s1, q1, s2, q2, _ = simulate_pairs(
        rng, g1, n_barcodes=1, frags_per_bc=(1, 2), pairs_per_frag=(10, 11),
        frag_len=5_000, read_len=100)
    ids.append("straddle")
    bcs.append(bcs[0])
    s1.append(g0[-53:] + g1[:47])
    s2.append(revcomp_str(g1[200:300]))
    q1.append("I" * 100)
    q2.append("I" * 100)
    pairs = (ids, bcs, s1, q1, s2, q2)
    single = build_index(contigs)
    sharded = build_index_sharded(contigs, max_shard_bases=40_000)
    assert sharded.n_shards == 2
    out = {}
    for name, al, rb in (
            ("jax single", jax_pipeline.Aligner(single), jax_pipeline),
            ("jax sharded", jax_pipeline.ShardedAligner(sharded),
             jax_pipeline),
            ("single", Aligner(single, device="cpu"), None),
            ("sharded", ShardedAligner(sharded, device="cpu"), None)):
        batch = (rb.ReadBatch if rb else ReadBatch).from_pairs(*pairs)
        out[name] = al.align_batch_to_sam(batch)
    assert out["single"] == out["jax single"]
    assert out["sharded"] == out["jax sharded"]

    def read1(lines):
        f = [ln.split("\t") for ln in lines if ln.startswith("straddle\t")
             and int(ln.split("\t")[1]) & 64]
        assert len(f) == 1
        return int(f[0][1]), f[0][2], f[0][5]
    flag, _, _ = read1(out["single"])
    assert flag & 4
    flag, rname, cigar = read1(out["sharded"])
    assert not flag & 4 and (rname, cigar) == ("c0", "53M47S")
    rest = [ln for ln in out["single"] if not ln.startswith("straddle")]
    assert _norm(rest) == _norm([ln for ln in out["sharded"]
                                 if not ln.startswith("straddle")])
