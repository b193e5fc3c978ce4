"""Every platform's reads, limits per traffic mix, and the platforms'
tiny cells on the CPU: a cell of each of EMA's six platforms made from
files alone reads correct, and the port's reader takes the generator's
groups back from its FASTQs; the 10x inputs keep the bytes the harness
made before it drew barcodes by platform."""

import hashlib
import json
import os

import numpy as np
import pytest

from ema_bench import generate
from ema_bench import run as bench_run

from conftest import PLATFORM_READS, add_platform_cell

# sha256 over the tiny cells' inputs (the stream's two FASTQs; x's
# interleaved FASTQ, whitelist and bucket files), as the harness made
# them before it drew barcodes by platform
GOLDEN = {
    ("tiny-stream-wgs", 3):
        "5739aabc5d43d3002fd52d4aff7701f037292aff1635e388990dbc42ad03ba42",
    ("tiny-stream-wgs", 2 ** 31 + 77):
        "ba488f0d399e9c113240313e910c6ab9778afb7c31a4eae2c67c7a8b863af90e",
    ("tiny-x-wgs", 3):
        "1cf9e7700deab235e777606f5fa3116ef87c24f4e246e7f54d50184d000cbcce",
    ("tiny-x-wgs", 2 ** 31 + 77):
        "caca089eda3ff80df2f3f88009c9453566373bfadf17e80ad155c1ca2a38483a",
}


def _pool(root, cell, seed):
    """The cell's configuration, traffic and pool, made as ``run_cell``
    makes them."""
    b = bench_run.Bench(root)
    w = b.cell(cell)
    cfg, tr = b.data("configs", w["config"]), b.data("traffic", w["traffic"])
    genome, repeats = generate.make_genome(cfg["genome"])
    rng = np.random.default_rng(seed)
    s = cfg["sample"]
    sample = generate.make_sample(rng, genome, s["snv_rate"],
                                  s["indel_rate"], s["indel_len"])
    pool = generate.make_pool(rng, sample, repeats, cfg["reads"], tr,
                              int(tr["pool_pairs"]),
                              platform=cfg["platform"])
    return cfg, tr, pool


@pytest.mark.parametrize("cell,seed", sorted(GOLDEN))
def test_tenx_inputs_keep_their_bytes(tiny_root, tmp_path, cell, seed):
    cfg, tr, pool = _pool(tiny_root, cell, seed)
    if cfg["driver"] == "stream":
        files = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
        generate.write_pair_fastqs(pool, *files)
    else:
        from ema_tpu_torch.preproc.correct import correct
        from ema_tpu_torch.preproc.count import count
        rng = np.random.default_rng([seed, 3])
        fq, wl = str(tmp_path / "inter.fq"), str(tmp_path / "wl.txt")
        generate.write_interleaved_fastq(rng, pool, fq,
                                         int(cfg["reads"]["spacer"]))
        generate.write_whitelist(rng, pool, wl, int(tr["whitelist_decoys"]))
        with open(fq, "rb") as f:
            count(wl, str(tmp_path / "cnt"), f)
        with open(fq, "rb") as f:
            correct(wl, [str(tmp_path / "cnt.ema-ncnt")],
                    str(tmp_path / "bkt"), f, n_buckets=int(cfg["buckets"]))
        files = [fq, wl] + sorted(str(p) for p in
                                  (tmp_path / "bkt").iterdir())
    h = hashlib.sha256()
    for p in files:
        h.update(open(p, "rb").read())
    assert h.hexdigest() == GOLDEN[(cell, seed)]


@pytest.mark.parametrize("platform", sorted(PLATFORM_READS))
def test_a_platform_cell_from_files_alone(tiny_root, tmp_path, platform):
    """A tiny stream cell of the platform reads correct, and the port's
    reader gives back from the generator's FASTQs exactly its groups:
    the same pairs, QNAMEs and barcode values, in the same order."""
    from ema_tpu_torch import io as pio
    cell = add_platform_cell(tiny_root, platform)
    runs = []
    res = bench_run.run_cell(tiny_root, cell, 2 ** 31 + 40, 1.0, False,
                             device="cpu", runs=runs)
    assert res["correct"] is True, res["checks"]
    pool = runs[-1].pool
    assert pool.platform == platform
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    generate.write_pair_fastqs(pool, f1, f2)
    ends = np.flatnonzero(np.diff(np.append(pool.group, -1))) + 1
    starts = np.concatenate([[0], ends[:-1]])
    got = list(pio.iter_fastq_pair_groups(f1, f2, platform))
    assert len(got) == ends.shape[0]
    for (ids, bcs, *_), a, b in zip(got, starts, ends):
        assert ids == pool.names[a:b]
        assert bcs == pool.bc_val[a:b].tolist()
    assert np.all(np.diff(pool.bc_val.astype(np.float64)) >= 0)
    assert len(set(pool.bc_val[starts].tolist())) == starts.shape[0]


def test_barcode_draws():
    """ACGT draws are the one plain draw where it has no repeats, and a
    repeated value is drawn again; the other platforms' values are the
    port's codecs of their labels."""
    from ema_tpu_torch.utils import barcodes
    for seed in range(20):
        a = np.random.default_rng(seed)
        labels, val = generate.draw_barcodes(a, "10x", {"bc_len": 3}, 40)
        assert np.unique(val).shape[0] == 40
        b = np.random.default_rng(seed)
        plain = b.integers(0, 4, (40, 3), dtype=np.uint8)
        if np.unique(generate.encode_bc(plain)).shape[0] == 40:
            assert labels == ["".join("ACGT"[c] for c in r)
                              for r in plain.tolist()]
    rng = np.random.default_rng(1)
    labels, val = generate.draw_barcodes(rng, "haplotag", {}, 500)
    assert [barcodes.encode_bc_haplotag(x) for x in labels] == val.tolist()
    segs = np.asarray([[int(x[i:i + 2]) for i in (1, 4, 7, 10)]
                       for x in labels])
    assert segs.min() >= 1 and segs.max() <= 96
    labels, val = generate.draw_barcodes(rng, "tru",
                                         {"bc_range": [1, 384]}, 384)
    assert sorted(val.tolist()) == list(range(1, 385))
    with pytest.raises(ValueError, match="bc_range"):
        generate.draw_barcodes(rng, "cpt", {"bc_range": [1, 384]}, 385)
    for platform in ("tru", "cpt", "tellseq", "dbs"):
        reads = PLATFORM_READS[platform]
        labels, val = generate.draw_barcodes(rng, platform, reads, 50)
        for k, (lab, v) in enumerate(zip(labels, val.tolist())):
            name = generate.read_name(platform, k, k + 1, lab)
            head = generate.HEADS[platform].format(name=name, bc=lab)
            ident, got = barcodes.extract_bc_from_id(head.rstrip("\n"),
                                                     platform)
            assert (ident, got) == (name, v)
            assert generate.name_pair(name) == (k, k + 1)


def test_traffic_limits_replace_only_what_they_name():
    cfg = {"name": "c", "limits": {"bad_pairs": 0, "off_truth_pct": 0.8,
                                   "em_low_xg_pct": 10.0}}
    assert bench_run.limits_of(cfg, {"name": "t"}) == cfg["limits"]
    got = bench_run.limits_of(cfg, {"name": "t", "limits": {
        "off_truth_pct": 4.0}})
    assert got == {"bad_pairs": 0, "off_truth_pct": 4.0,
                   "em_low_xg_pct": 10.0}
    assert cfg["limits"]["off_truth_pct"] == 0.8
    with pytest.raises(SystemExit, match="sw_gapz"):
        bench_run.limits_of(cfg, {"name": "t", "limits": {"sw_gapz": 1}})


@pytest.mark.parametrize("value", [None, "4", True, [4]])
def test_traffic_limits_leave_no_number_uncompared(value):
    cfg = {"name": "c", "limits": {"bad_pairs": 0, "off_truth_pct": 0.8}}
    with pytest.raises(SystemExit, match="off_truth_pct"):
        bench_run.limits_of(cfg, {"name": "t", "limits": {
            "off_truth_pct": value}})


def test_a_mixs_limits_apply_to_its_cells_alone(tiny_root):
    """A mix's limit shows in its cells' checks; a cell of another mix on
    the same configuration keeps the configuration's."""
    here = os.path.join(tiny_root, "ema_bench", "traffic")
    t = json.load(open(os.path.join(here, "tiny-linked-wgs.json")))
    t.update(name="tiny-limited", pool_pairs=1500,
             limits={"off_truth_pct": 3.25})
    json.dump(t, open(os.path.join(here, "tiny-limited.json"), "w"))
    path = os.path.join(tiny_root, "BENCHMARK.json")
    b = json.load(open(path))
    if all(w["name"] != "tiny-limited" for w in b["workloads"]):
        b["workloads"].append({"name": "tiny-limited", "config":
                               "tiny-tenx-chr20-stream", "traffic":
                               "tiny-limited", "chips": 1, "why": "a dummy"})
        json.dump(b, open(path, "w"))
    cfg = bench_run.Bench(tiny_root).data("configs", "tiny-tenx-chr20-stream")
    lim = {"tiny-limited": 3.25,
           "tiny-stream-wgs": cfg["limits"]["off_truth_pct"]}
    for cell, want in lim.items():
        res = bench_run.run_cell(tiny_root, cell, 77, 1.0, False,
                                 device="cpu")
        assert res["checks"]["off_truth_pct"]["limit"] == want
        assert res["checks"]["bad_pairs"]["limit"] == 0


def test_the_x_driver_refuses_another_platform(tiny_root):
    here = os.path.join(tiny_root, "ema_bench", "configs")
    c = json.load(open(os.path.join(here, "tiny-tenx-chr20-x.json")))
    c.update(name="tiny-tru-x", platform="tru")
    c["reads"].update(PLATFORM_READS["tru"])
    json.dump(c, open(os.path.join(here, "tiny-tru-x.json"), "w"))
    path = os.path.join(tiny_root, "BENCHMARK.json")
    b = json.load(open(path))
    if all(w["name"] != "tiny-tru-x" for w in b["workloads"]):
        b["workloads"].append({"name": "tiny-tru-x", "config": "tiny-tru-x",
                               "traffic": "tiny-linked-wgs-buckets",
                               "chips": 1, "why": "a dummy"})
        json.dump(b, open(path, "w"))
    with pytest.raises(SystemExit, match="preproc, which is 10x-only"):
        bench_run.run_cell(tiny_root, "tiny-tru-x", 5, 1.0, False,
                           device="cpu")


def test_a_traced_run_names_gaps_by_the_programs_spans(tiny_root):
    """The run's observer adds each program span of the window but
    ``stream.group`` to the spans that name the idle gaps, and leaves the
    port's observer list as it found it."""
    from ema_tpu_torch.utils import metrics
    before = list(metrics.SPAN_OBSERVERS)
    runs = []
    res = bench_run.run_cell(tiny_root, "tiny-stream-wgs", 2 ** 31 + 41,
                             1.0, True, device="cpu", runs=runs)
    assert res["correct"] is True
    r = runs[-1]
    assert metrics.SPAN_OBSERVERS == before
    names = {n for n, _, _ in r.spans.items}
    program = {sp.name for sp in r.program}
    assert {"stream.read", "pool.wait", "sweep[host]"} <= names
    assert "stream.group" in program and "stream.group" not in names
    assert names >= program - {"stream.group"}
    t = next(sp for sp in r.program if sp.name == "stream.read")
    assert r.spans.label((t.start_ns + t.end_ns) // 2) in (
        "stream.read", "iter_fastq_pair_groups")


@pytest.mark.card
@pytest.mark.parametrize("platform", ["tru", "haplotag"])
def test_a_platform_cell_on_the_card(card, tmp_path, capsys, platform):
    """A tiny stream cell of ``tru`` (many clouds, integer barcodes) and
    of ``haplotag`` (its codec) on the card, traced."""
    from conftest import make_tiny_root
    root = make_tiny_root(str(tmp_path))
    cell = add_platform_cell(root, platform)
    assert bench_run.main(["--workload", cell, "--seed", str(2 ** 31 + 42),
                           "--seconds", "3", "--trace", "1"],
                          root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["kind"] == card
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
