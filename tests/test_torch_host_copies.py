"""The port's own copies of the host modules against the JAX package's.

``ema_tpu_torch`` imports nothing of ``ema_tpu``: it keeps its own copy of
the native C++ library and of every host module (config, barcodes,
logprobs, whitelist, manifest, samdiff, records, pairing, score, split,
groups, samout, chaining, index build / sharded / bwa_import, preproc
count / correct).  Here the same inputs go through both.

Most inputs are recorded, not invented: the JAX package's Aligner runs
small worlds once with its host modules' functions wrapped, and every
recorded call (arguments copied before the call) is replayed through the
port's function of the same name.  Tolerances: exact for integers, bytes
and SAM text; rtol 1e-12 for float64 (the host EM, logprobs, scores).
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import ema_tpu.native
from chip_smoke import deep_em_group, golden_world
from ema_tpu import config as jax_config
from ema_tpu.core import pipeline as jax_pipeline
from ema_tpu.index import build_index, build_index_sharded
from ema_tpu_torch import config as port_config
from ema_tpu_torch import native as port_native
from simulate import rand_genome
from test_split import _bad_cloud_group
from torch_handover import fields_of, port_index
from torch_handover import jax_native_built  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12

# module (under ema_tpu / ema_tpu_torch) -> functions the worlds below
# must reach, each replayed through the port's copy
RECORDED = {
    "native": ["suffix_array", "smem_kmer_table", "smem_seed_batch",
               "greedy_seed_batch", "locate_batch", "sw_banded_native",
               "traceback_batch", "cigar_stats_pool", "format_sam_batch",
               "em_run_flat", "sa_optimize_best"],
    "ops.chaining": ["chain_hits"],
    "core.score": ["score_alignments", "approx_mapq", "final_mapq",
                   "cigar_stats"],
    "core.split": ["mark_optimal_alignments_in_cloud"],
    "core.groups": ["sweep_groups_batch", "run_em_host_batch", "run_em_host",
                    "run_em_native", "_pack_states", "finish_groups_batch",
                    "sweep_group", "finish_group"],
    "core.samout": ["emit_groups_lines", "format_record", "make_contig_blob",
                    "write_sam_header"],
    "utils.barcodes": ["decode_bc"],
}
CASES = [(m, f) for m, fs in RECORDED.items() for f in fs]
KEEP = 3                    # recorded calls kept per function


def _to_port(obj):
    """``obj`` with every ``ema_tpu`` dataclass rebuilt as the port's class
    of the same module and name; arrays and containers are copied."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        cls = type(obj)
        if mod.split(".")[0] == "ema_tpu":
            cls = getattr(importlib.import_module(
                mod.replace("ema_tpu", "ema_tpu_torch", 1)), cls.__name__)
        return cls(**{k: _to_port(v) for k, v in fields_of(obj).items()})
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_port(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_port(v) for k, v in obj.items()}
    return copy.deepcopy(obj)


def _assert_same(got, want, what):
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, what
        for k, v in fields_of(want).items():
            _assert_same(getattr(got, k), v, f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        if want.dtype.names:
            for name in want.dtype.names:
                _assert_same(got[name], want[name], f"{what}[{name}]")
        elif want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=0), what
    elif isinstance(want, np.random.Generator):
        assert got.bit_generator.state == want.bit_generator.state, what
    else:
        assert got == want, what


@pytest.fixture(scope="module")
def recorded():
    """{(module, function): [(args, kwargs, result, args after)]} of the
    JAX package's host functions, over an index build, the golden world
    under SMEM and greedy seeding with host EM, the scalar emission path
    with the read-density optimisation, and a deep group."""
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        for m, f in CASES:
            mod = importlib.import_module("ema_tpu." + m)
            fn = getattr(mod, f)

            def wrapper(*a, _fn=fn, _key=(m, f), **kw):
                before = copy.deepcopy((a, kw))
                out = _fn(*a, **kw)
                got = calls.setdefault(_key, [])
                if len(got) < KEEP:
                    got.append((*before, copy.deepcopy(out),
                                copy.deepcopy(a)))
                return out
            mp.setattr(mod, f, wrapper)
        mp.setenv("EMA_TPU_SEED_IMPL", "native")
        contigs, _, pairs = golden_world()
        idx = build_index(contigs)
        batch = jax_pipeline.ReadBatch.from_pairs(*pairs)
        base = dict(batch_size=512, seed=7, device_em=False)
        for kw in (
                {},
                dict(aligner=jax_config.AlignerParams(seeding="greedy")),
                dict(bx_index="2", apply_density_opt=True)):
            lines = jax_pipeline.Aligner(
                idx, jax_config.RunConfig(**base, **kw)).align_batch_to_sam(
                batch)
            assert lines
        # a group deeper than EM_NATIVE_C goes to the native flat EM
        groups = importlib.import_module("ema_tpu.core.groups")
        profile = jax_config.get_platform_profile("10x")
        st = groups.sweep_group(*deep_em_group(), profile)
        groups.run_em_native(st)
        groups.finish_group(st)
        # a cloud marked bad takes the read-density optimiser (-d), and
        # 40 pairs take the per-group host EM
        groups.process_barcode_group(
            *_bad_cloud_group(), profile, apply_opt=True,
            rng=np.random.default_rng(0), n_pairs_in_group=40)
        importlib.import_module("ema_tpu.core.samout").write_sam_header(
            idx.names, idx.lengths, "@RG\tID:a", "v", "cmd")
        tb = calls[("native", "traceback_batch")][0][2]
        importlib.import_module("ema_tpu.core.score").cigar_stats(
            tb["cigars"], tb["n_cigar"])
    return calls


@pytest.mark.parametrize("module,function", CASES,
                         ids=[f"{m}.{f}" for m, f in CASES])
def test_copy_replays_the_jax_package_calls(module, function, recorded):
    """Every recorded call of ``ema_tpu.<module>.<function>`` gives the
    same result, and leaves its arguments in the same state, through
    ``ema_tpu_torch.<module>.<function>``."""
    got = recorded.get((module, function))
    assert got, f"the worlds never called {module}.{function}"
    fn = getattr(importlib.import_module("ema_tpu_torch." + module),
                 function)
    for n, (a, kw, want, a_after) in enumerate(got):
        pa, pkw = _to_port(a), _to_port(kw)
        out = fn(*pa, **pkw)
        _assert_same(out, want, f"{function} call {n}")
        _assert_same(pa, a_after, f"{function} call {n} arguments")


def test_config_equals_jax():
    """Every platform profile and every model constant, by name."""
    assert set(port_config.PLATFORM_PROFILES) == set(
        jax_config.PLATFORM_PROFILES)
    for name, prof in jax_config.PLATFORM_PROFILES.items():
        _assert_same(port_config.get_platform_profile(name), prof, name)
        assert (port_config.get_platform_profile(name).log_density_probs
                == prof.log_density_probs)
    _assert_same(port_config.AlignerParams(), jax_config.AlignerParams(),
                 "AlignerParams")
    for k, v in vars(jax_config).items():
        if k.isupper() and isinstance(v, (int, float, str, tuple)):
            assert getattr(port_config, k) == v, k


BARCODES = ["ACGTACGTACGTACGT", "TTTTTTTTTTTTTTTT", "AAAAAAAAAAAAAAAA",
            "GATTACAGATTACAGA"]


@pytest.mark.parametrize("bc", BARCODES)
def test_barcodes_equal_jax(bc):
    from ema_tpu.utils import barcodes as jb
    from ema_tpu_torch.utils import barcodes as pb

    code = jb.encode_bc(bc)
    assert pb.encode_bc(bc) == code
    assert pb.decode_bc(code, 16) == jb.decode_bc(code, 16) == bc
    lut = np.zeros(256, np.uint8)
    lut[list(b"ACGT")] = range(4)
    bases = lut[np.frombuffer(bc.encode(), np.uint8)][None, :]
    np.testing.assert_array_equal(pb.encode_bc_batch(bases),
                                  jb.encode_bc_batch(bases))
    _assert_same(pb.decode_bc_batch(np.array([code]), 16),
                 jb.decode_bc_batch(np.array([code]), 16), "decode_bc_batch")
    assert pb.bases_to_str(bases[0]) == jb.bases_to_str(bases[0])
    hap = "A01C02B03D04"
    assert pb.encode_bc(hap, True) == jb.encode_bc(hap, True)
    assert pb.decode_bc(jb.encode_bc(hap, True), 0, True) == hap
    for rid, plat in ((f"@r1 x:{bc}", "10x"), (f"r1:{bc}", "dbs"),
                      (f"r1 y:{hap}", "haplotag"),
                      (f"r1 BX:Z:{bc}", "tellseq"),
                      (f"r1:{bc} 1:N", "tellseq"),
                      ("1234abc", "tru"), ("-12", "tru"),
                      ("r1:ab567x", "cpt")):
        assert pb.extract_bc_from_id(rid, plat) == jb.extract_bc_from_id(
            rid, plat), (rid, plat)
    for mod in (jb, pb):
        with pytest.raises(ValueError, match="unknown platform"):
            mod.extract_bc_from_id("r1", "nanopore")


def test_whitelist_equals_jax(tmp_path):
    from ema_tpu.utils.whitelist import BarcodeDict as JB
    from ema_tpu_torch.utils.whitelist import BarcodeDict as PB

    rng = np.random.default_rng(5)
    wl = np.unique(rng.integers(0, 1 << 32, 3000, dtype=np.uint64))
    seen = np.concatenate([wl[rng.integers(0, wl.shape[0], 5000)],
                           rng.integers(0, 1 << 32, 200, dtype=np.uint64)])
    path = tmp_path / "wl.txt"
    strs = ["".join("ACGT"[k] for k in rng.integers(0, 4, 16))
            for _ in range(50)]
    path.write_text("# header\n" + "".join(s + "\n" for s in strs))
    for make in (lambda c: c.from_barcodes(wl),
                 lambda c: c.from_whitelist_file(str(path))):
        j, p = make(JB), make(PB)
        _assert_same(p.lookup(seen), j.lookup(seen), "lookup")
        _assert_same(p.increment(seen), j.increment(seen), "increment")
        j.compute_priors()
        p.compute_priors()
        _assert_same(p, j, "BarcodeDict")
        idx = np.arange(0, j.size, 7)
        _assert_same(p.get_bucket(idx, 13), j.get_bucket(idx, 13), "bucket")
    # each package reads the other's serialized dict
    j.serialize(str(tmp_path / "j.bin"))
    p.serialize(str(tmp_path / "p.bin"))
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "p.bin"
                                                 ).read_bytes()
    _assert_same(PB.deserialize(str(tmp_path / "j.bin")),
                 JB.deserialize(str(tmp_path / "p.bin")), "deserialize")


@pytest.mark.parametrize("seed", [0, 1])
def test_logprobs_and_pairing_equal_jax(seed):
    """float64 round-off (rtol 1e-12) for logprobs; the pairing rule
    exactly, over a grid of positions and strands."""
    from ema_tpu.core.pairing import is_proper_pair as j_pair
    from ema_tpu.utils import logprobs as jl
    from ema_tpu_torch.core.pairing import is_proper_pair as p_pair
    from ema_tpu_torch.utils import logprobs as pl

    rng = np.random.default_rng(seed)
    p = -rng.random((7, 9)) * 300
    p[2] = -745.0                         # exp() underflows
    p[3, :4] = -1e4
    mask = rng.random((7, 9)) < 0.8
    mask[5] = False
    for row in p:
        _assert_same(pl.normalize_log_probs(row.copy()),
                     jl.normalize_log_probs(row.copy()), "normalize")
    _assert_same(pl.normalize_log_probs_batch(p.copy(), mask),
                 jl.normalize_log_probs_batch(p.copy(), mask), "batch")
    assert pl._LOG_EPSILON == jl._LOG_EPSILON
    for _ in range(300):
        a = (int(rng.integers(0, 2)), int(rng.integers(1, 3000)),
             int(rng.integers(0, 2)), int(rng.integers(0, 2)),
             int(rng.integers(1, 3000)), int(rng.integers(0, 2)))
        assert p_pair(*a) == j_pair(*a), a


def test_manifest_equals_jax(tmp_path):
    from ema_tpu.utils.manifest import RunManifest as JM
    from ema_tpu_torch.utils.manifest import RunManifest as PM

    part = tmp_path / "part.sam"
    part.write_text("x\n")
    jm = JM(str(tmp_path / "j.jsonl"))
    jm.mark_done("b0", str(part), 3, 0.5)
    jm.mark_done("b1", None, 0, 0.1)
    # each package resumes from the other's file
    pm = PM(str(tmp_path / "j.jsonl"))
    assert [pm.is_done(b) for b in ("b0", "b1", "b2")] == [True, True, False]
    pm.mark_done("b2", str(part), 1, 0.2)
    jm2 = JM(str(tmp_path / "j.jsonl"))
    assert all(jm2.is_done(b) for b in ("b0", "b1", "b2"))
    part.unlink()
    assert not PM(str(tmp_path / "j.jsonl")).is_done("b0")
    assert not JM(str(tmp_path / "j.jsonl")).is_done("b0")


@pytest.fixture(scope="module")
def two_sams(tmp_path_factory):
    """The golden world's SAM and a copy with a few records perturbed."""
    from chip_smoke import golden_sam
    import torch

    tmp = tmp_path_factory.mktemp("sams")
    sam = golden_sam(torch.device("cpu"))
    a = tmp / "a.sam"
    a.write_text(sam)
    lines = sam.splitlines(keepends=True)
    body = [i for i, ln in enumerate(lines) if not ln.startswith("@")]
    for i in body[3:40:9]:
        f = lines[i].split("\t")
        f[3] = str(int(f[3]) + 7)
        f[4] = "3"
        lines[i] = "\t".join(f)
    del lines[body[50]]
    b = tmp / "b.sam"
    b.write_text("".join(lines))
    return str(a), str(b)


@pytest.mark.parametrize("pos_tol", [0, 10])
def test_samdiff_equals_jax(pos_tol, two_sams, capsys):
    from ema_tpu.utils import samdiff as js
    from ema_tpu_torch.utils import samdiff as ps

    _assert_same(ps.diff_sams(*two_sams, pos_tol=pos_tol),
                 js.diff_sams(*two_sams, pos_tol=pos_tol), "diff_sams")
    args = [*two_sams, "--pos-tol", str(pos_tol), "--fail-under", "99.9"]
    want_rc = js.main(args)
    want = capsys.readouterr().out
    assert ps.main(args) == want_rc
    assert capsys.readouterr().out == want and want


@pytest.fixture(scope="module")
def small_contigs():
    rng = np.random.default_rng(9)
    c = {f"c{i}": rand_genome(rng, 9_000 + 1_500 * i) for i in range(3)}
    c["c1"] = c["c1"].copy()
    c["c1"][100:140] = 255                # an N run, randomized by a seed
    return c


@pytest.mark.parametrize("sa_rate", [None, 2, 4, 3])
def test_index_build_equals_jax(sa_rate, small_contigs):
    from ema_tpu_torch.index import build_index as port_build

    _assert_same(port_build(small_contigs, sa_rate=sa_rate),
                 build_index(small_contigs, sa_rate=sa_rate), "index")


def test_index_files_load_across_the_packages(small_contigs, tmp_path):
    """An index file written by either package loads in the other, as a
    single index and as shards."""
    from ema_tpu.index import ReferenceIndex as JR
    from ema_tpu.index import ShardedIndex as JS
    from ema_tpu_torch.index import ReferenceIndex as PR
    from ema_tpu_torch.index import ShardedIndex as PS
    from ema_tpu_torch.index import build_index_sharded as port_sharded

    want = build_index(small_contigs)
    want.save(str(tmp_path / "j.npz"))
    port_index(want).save(str(tmp_path / "p.npz"))
    _assert_same(PR.load(str(tmp_path / "j.npz")), want, "port loads jax")
    _assert_same(JR.load(str(tmp_path / "p.npz")), want, "jax loads port")
    js = build_index_sharded(small_contigs, max_shard_bases=20_000)
    ps = port_sharded(small_contigs, max_shard_bases=20_000)
    assert js.n_shards == ps.n_shards == 2
    _assert_same(ps, js, "sharded build")
    js.save(str(tmp_path / "j.d"))
    ps.save(str(tmp_path / "p.d"))
    _assert_same(PS.load(str(tmp_path / "j.d")), js, "port loads jax shards")
    _assert_same(JS.load(str(tmp_path / "p.d")), js, "jax loads port shards")


def test_index_from_arrays(small_contigs):
    """The handover of an index as plain arrays: equal field by field,
    the arrays shared, and a wrong key set refused."""
    from ema_tpu_torch.index.build import index_from_arrays
    from ema_tpu_torch.index.sharded import sharded_index_from_arrays

    want = build_index(small_contigs)
    arrays = fields_of(want)
    got = index_from_arrays(arrays)
    assert type(got).__module__ == "ema_tpu_torch.index.build"
    _assert_same(got, want, "index_from_arrays")
    assert got.text is want.text and got.occ_blocks is want.occ_blocks
    assert (got.n, got.n_contigs) == (want.n, want.n_contigs)
    with pytest.raises(ValueError, match="missing.*fm_n"):
        index_from_arrays({k: v for k, v in arrays.items() if k != "fm_n"})
    with pytest.raises(ValueError, match="unknown.*extra"):
        index_from_arrays(dict(arrays, extra=1))
    js = build_index_sharded(small_contigs, max_shard_bases=20_000)
    ps = sharded_index_from_arrays([fields_of(s) for s in js.shards])
    _assert_same(ps, js, "sharded_index_from_arrays")
    assert ps.names == js.names and ps.contig_base == js.contig_base


@pytest.mark.parametrize("full", [False, True], ids=["pac", "bwt+sa"])
def test_bwa_import_equals_jax(full, tmp_path):
    """The BWA importers on the fixtures tests/test_bwa_import.py writes."""
    from ema_tpu.index import bwa_import as jb
    from ema_tpu_torch.index import bwa_import as pb
    from test_bwa_import import dump_bwa_bwt_sa, dump_bwa_files

    rng = np.random.default_rng(0)
    c1 = rng.integers(0, 4, 1000).astype(np.uint8)
    c2 = rng.integers(0, 4, 501).astype(np.uint8)
    if not full:
        c1[100:130] = 255
        c2[0:7] = 255
    prefix = str(tmp_path / "ref.fa")
    dump_bwa_files(prefix, {"chrA": c1, "chrB": c2})
    _assert_same(pb.load_bwa_contigs(prefix), jb.load_bwa_contigs(prefix),
                 "load_bwa_contigs")
    if full:
        dump_bwa_bwt_sa(prefix, np.concatenate([c1, c2]))
        _assert_same(pb.import_bwa_index(prefix), jb.import_bwa_index(prefix),
                     "import_bwa_index")


def _interleaved(rng, barcodes, n, haplotag):
    out = []
    for i in range(n):
        bc = barcodes[int(rng.integers(0, len(barcodes)))]
        if not haplotag and rng.random() < 0.2:       # a read error
            j = int(rng.integers(0, 16))
            bc = bc[:j] + "ACGT"[("ACGT".index(bc[j]) + 1) % 4] + bc[j + 1:]
        s1 = "".join("ACGT"[k] for k in rng.integers(0, 4, 60))
        s2 = "".join("ACGT"[k] for k in rng.integers(0, 4, 60))
        if haplotag:
            out.append(f"@r{i} BX:Z:{bc}\n{s1}\n+\n{'I' * 60}\n"
                       f"@r{i} BX:Z:{bc}\n{s2}\n+\n{'I' * 60}\n")
        else:
            out.append(f"@r{i}\n{bc}ACGTACG{s1}\n+\n{'I' * 83}\n"
                       f"@r{i}\n{s2}\n+\n{'I' * 60}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("h2", [False, True], ids=["h1", "h2"])
def test_preproc_count_and_correct_equal_jax(h2, tmp_path):
    """count and correct on one interleaved FASTQ with barcode errors:
    the same .ema-ncnt / .ema-fcnt and bucket files, byte for byte, and
    the same statistics.  (The haplotag chain runs in
    tests/test_torch_cli.py.)"""
    rng = np.random.default_rng(12)
    barcodes = ["".join("ACGT"[k] for k in rng.integers(0, 4, 16))
                for _ in range(40)]
    wl = tmp_path / "wl.txt"
    wl.write_text("".join(b + "\n" for b in barcodes))
    blob = _interleaved(rng, barcodes[:25], 400, False)
    files = {}
    for name in ("ema_tpu", "ema_tpu_torch"):
        count = importlib.import_module(name + ".preproc.count").count
        correct = importlib.import_module(name + ".preproc.correct").correct
        d = tmp_path / name
        d.mkdir()
        st_c = count(str(wl), str(d / "c"), io.BytesIO(blob))
        st_p = correct(str(wl), [str(d / "c")], str(d / "bkt"),
                       io.BytesIO(blob), do_h2=h2, n_buckets=4, n_threads=2)
        files[name] = (st_c, st_p, {
            p.name: p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()})
    assert files["ema_tpu_torch"] == files["ema_tpu"]
    assert len(files["ema_tpu"][2]) >= 6 and files["ema_tpu"][1]["h1"] > 0


def test_correct_refuses_multi_host(tmp_path):
    """``correct(..., distributed=True)`` in one process (the name is kept
    from the refusal it replaces): with no process group the priors and
    read totals are summed over one process, so the port gives the JAX
    package's bucket files and statistics, byte for byte, under
    ``distributed=True`` as without it."""
    import torch.distributed as dist

    rng = np.random.default_rng(13)
    barcodes = ["".join("ACGT"[k] for k in rng.integers(0, 4, 16))
                for _ in range(30)]
    wl = tmp_path / "wl.txt"
    wl.write_text("".join(b + "\n" for b in barcodes))
    blob = _interleaved(rng, barcodes[:20], 200, False)
    files = {}
    for name, dist_flag in (("ema_tpu", False), ("ema_tpu", True),
                            ("ema_tpu_torch", True)):
        count = importlib.import_module(name + ".preproc.count").count
        correct = importlib.import_module(name + ".preproc.correct").correct
        d = tmp_path / f"{name}_{dist_flag}"
        d.mkdir()
        count(str(wl), str(d / "c"), io.BytesIO(blob))
        st = correct(str(wl), [str(d / "c")], str(d / "bkt"),
                     io.BytesIO(blob), do_h2=True, n_buckets=4,
                     distributed=dist_flag)
        files[name, dist_flag] = (st, {
            p.name: p.read_bytes() for p in sorted((d / "bkt").iterdir())})
    assert not dist.is_initialized()
    want = files["ema_tpu", False]
    assert files["ema_tpu", True] == want
    assert files["ema_tpu_torch", True] == want
    assert len(want[1]) >= 5 and want[0]["h1"] > 0


@pytest.mark.parametrize("k", [0, -1])
def test_smem_kmer_table_refuses_k_below_1(k, small_contigs):
    """The repair of the inherited fault: the C++ writes 4 rows for any
    k < 1 into a buffer of 4**k; the port's wrapper refuses, and its C++
    returns at once (the buffer handed to it stays untouched)."""
    import ctypes

    idx = port_index(build_index(small_contigs))
    with pytest.raises(ValueError, match="k >= 1"):
        port_native.smem_kmer_table(idx.occ_blocks, idx.counts, idx.primary,
                                    idx.fm_n, k=k)
    out = np.full((8, 3), -7, np.int64)
    port_native.get_lib().smem_kmer_table(
        port_native._ptr(idx.occ_blocks, ctypes.c_int32),
        port_native._ptr(idx.counts, ctypes.c_int64),
        ctypes.c_int64(idx.primary), ctypes.c_int64(idx.fm_n),
        ctypes.c_int32(k), port_native._ptr(out, ctypes.c_int64))
    assert (out == -7).all()
    # k >= 1 is the JAX package's table
    np.testing.assert_array_equal(
        port_native.smem_kmer_table(idx.occ_blocks, idx.counts, idx.primary,
                                    idx.fm_n, k=3),
        ema_tpu.native.smem_kmer_table(idx.occ_blocks, idx.counts,
                                       idx.primary, idx.fm_n, k=3))


def test_smem_kmer_table_wider_than_the_seed_falls_back(small_contigs):
    """A k-mer table with k = 4 and ``min_seed_len = 3`` cannot serve
    round 3 (its k exceeds the shortest seed): the port's native copy
    falls back to the run with no table, plane for plane (the fallback
    that tests/test_smem.py:193-199 runs and never asserts)."""
    rng = np.random.default_rng(31)
    idx = port_index(build_index(small_contigs))
    text = np.concatenate(list(small_contigs.values()))
    text = np.where(text > 3, 0, text).astype(np.uint8)
    n, L = 48, 60
    codes = np.empty((n, L), np.uint8)
    for r in range(n):
        p0 = int(rng.integers(0, len(text) - L))
        codes[r] = text[p0:p0 + L]
        codes[r, rng.integers(0, L, 2)] = rng.integers(0, 4, 2)
        if r % 5 == 0:
            codes[r, int(rng.integers(0, L))] = 4          # an N
    lens = np.full(n, L, np.int32)

    def run(tab, min_seed_len):
        return port_native.smem_seed_batch(
            idx.occ_blocks, idx.counts, idx.primary, idx.fm_n, codes, lens,
            min_seed_len=min_seed_len, split_len=28, split_width=10,
            max_mem_intv=20, max_seeds=64, n_threads=1, kmer_tab=tab)

    tab = port_native.smem_kmer_table(idx.occ_blocks, idx.counts,
                                      idx.primary, idx.fm_n, k=4)
    for min_seed_len in (3, 19):          # refused, then used
        base, got = run(None, min_seed_len), run(tab, min_seed_len)
        assert int(base[4].sum()) > 0
        for a, b in zip(base, got):
            np.testing.assert_array_equal(a, b)


def test_replay_writer_equals_jax(tmp_path):
    """The port's ReplayWriter and the JAX package's, fed the same
    (batch, candidates) of the golden world by one Aligner, write the same
    bytes."""
    import torch
    from ema_tpu.utils.replay import ReplayWriter as JaxWriter
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.index import build_index as port_build_index
    from ema_tpu_torch.utils.replay import ReplayWriter

    contigs, _, pairs = golden_world()
    idx = port_build_index(contigs)
    writers = {
        name: cls(str(tmp_path / f"{name}.replay"), idx.names,
                  list(idx.lengths))
        for name, cls in (("jax", JaxWriter), ("port", ReplayWriter))}
    al = Aligner(idx, port_config.RunConfig(batch_size=512, seed=7),
                 device=torch.device("cpu"))

    def sink(batch, cands):
        for w in writers.values():
            w.add(batch, cands)
    al.replay_sink = sink
    al.align_batch_to_sam(ReadBatch.from_pairs(*pairs))
    for w in writers.values():
        w.close()
    port = (tmp_path / "port.replay").read_bytes()
    assert port == (tmp_path / "jax.replay").read_bytes()
    assert port.count(b"\nE ") > 100


def _broken_sams(sam: str) -> dict:
    """The golden SAM and the breakages of tests/test_samcheck.py (a CIGAR
    that no longer consumes SEQ, a POS past the contig), a mate
    cross-reference cut and a TLEN sign flipped."""
    lines = sam.splitlines(keepends=True)
    at = next(i for i, ln in enumerate(lines) if not ln.startswith("@"))

    def with_field(k, value):
        f = lines[at].split("\t")
        f[k] = value(f[k]) if callable(value) else value
        return lines[:at] + ["\t".join(f)] + lines[at + 1:]

    return {"golden": lines, "cigar": with_field(5, "1M"),
            "pos": with_field(3, "99999999"),
            "pnext": with_field(7, lambda v: str(int(v) + 3)),
            "tlen": with_field(8, lambda v: str(-int(v) or 5)),
            "flag": with_field(1, lambda v: str(int(v) ^ 0x10))}


@pytest.mark.parametrize("case", ["golden", "cigar", "pos", "pnext", "tlen",
                                  "flag"])
def test_check_sam_equals_jax(case, two_sams):
    """The port's check_sam reports what the JAX package's reports: no
    violation on the golden SAM, the same ones on each broken copy."""
    from ema_tpu.utils.samcheck import check_sam as jax_check
    from ema_tpu_torch.utils.samcheck import check_sam

    with open(two_sams[0]) as f:
        lines = _broken_sams(f.read())[case]
    got = check_sam(lines)
    assert got == jax_check(lines)
    assert (got == []) == (case == "golden"), got[:5]
    if case == "cigar":
        assert any("CIGAR consumes" in e for e in got)
    if case == "pos":
        assert any("outside" in e or "past" in e for e in got)


def test_read_fai_equals_jax(tmp_path):
    from ema_tpu.io import read_fai as jax_read_fai
    from ema_tpu_torch.io import read_fai

    fai = tmp_path / "ref.fa.fai"
    fai.write_text("chr1\t1000\t6\t60\t61\n\nchr2 extra\t50\t9\t60\t61\n"
                   "  \nscaffold_3\t7\t1\t7\t8\n")
    assert read_fai(str(fai)) == jax_read_fai(str(fai)) == [
        "chr1", "chr2", "scaffold_3"]


def test_two_native_libraries_share_nothing():
    """Both packages' libraries are loaded in this process: two files,
    and the port's lives under build/, named by a hash, not beside its
    source."""
    a, b = ema_tpu.native.get_lib(), port_native.get_lib()
    assert a._name != b._name
    so = port_native._so_path()
    assert so.parent == port_native.BUILD_DIR and so.exists()
    assert so.parent.parts[-2:] == ("build", "ema_tpu_torch")
    assert not list(port_native.SRC.parent.glob("*.so*"))
    assert port_native.lib_fingerprint() != ""


_BUILD_SCRIPT = r"""
import sys
from pathlib import Path
from ema_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
native.get_lib()
import numpy as np
print("SA", native.suffix_array(np.array([1, 0, 1, 0], np.uint8), 4).tolist())
"""


def test_native_builds_race_free(tmp_path):
    """Three processes build the library at once into one empty
    directory (as xdist workers do on a fresh checkout): each writes its
    own temporary file, every one loads a whole library, and one .so and
    no temporary file is left."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path / "b")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert "SA [3, 1, 2, 0]" in out
    left = sorted(f.name for f in (tmp_path / "b").iterdir())
    assert len(left) == 1 and left[0].endswith(".so"), left


def test_port_sources_never_reach_for_the_jax_package():
    """No file of the port (its tools included), its launcher or
    chip_smoke.py imports ``ema_tpu``, jax or the tests, or opens, joins
    or loads a path or module name under the JAX package: what mentions
    are left name the counterpart in comments, docstrings and the
    kernels' ``replaces`` records."""
    import re

    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "bin", "ema-tpu-torch")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ema_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cpp", ".cu", ".cuh"))]
    assert len(files) > 40
    imp = re.compile(r"^\s*(from|import)\s+(ema_tpu|jax|jaxlib|tests)"
                     r"(\.|\s|$)")
    reach = re.compile(r"open\(|join\(|Path\(|import_module|__import__|"
                       r"exec\(|spec_from_file_location|CDLL\(|#include")
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                assert not imp.match(line), f"{path}:{n} imports {line!r}"
                if re.search(r"ema_tpu(?!_torch)", line):
                    assert not reach.search(line), (
                        f"{path}:{n} reaches into the JAX package: {line!r}")
