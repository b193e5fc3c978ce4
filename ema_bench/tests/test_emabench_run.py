"""Whole runs at a tiny size on the CPU, past the look for a card: the
result line, a cell and a metric added from files alone, the control,
and each fault a cell can have, planted in the program underneath."""

import json
import os

import numpy as np
import pytest

from ema_bench import run as bench_run


@pytest.fixture
def em_gate(monkeypatch):
    """Restores the program's EM gate after a control run."""
    from ema_tpu_torch import config as pconfig
    monkeypatch.setattr(pconfig, "MIN_PAIRS_FOR_EM", pconfig.MIN_PAIRS_FOR_EM)


def _last_line(capsys, argv, root, rc=0, device="cpu"):
    assert bench_run.main(argv, root=root, device=device) == rc
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell,trace", [("tiny-stream-wgs", 0),
                                        ("tiny-x-wgs", 1)])
def test_result_line(capsys, tiny_root, cell, trace):
    res, err = _last_line(capsys, ["--workload", cell, "--seed",
                                   str(2 ** 31 + 6), "--seconds", "1",
                                   "--trace", str(trace)], tiny_root)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bench = bench_run.Bench(tiny_root)
    want = {m["name"] for m in bench.metrics_of(cell, bool(trace))}
    # on the CPU the device's metrics find nothing to read
    cpu_silent = {"sw_roofline_pct", "device_launches_per_kpair",
                  "device_idle_pct", "em_s_per_kpair"}
    assert set(res["metrics"]) == want - cpu_silent
    for m in res["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    for name, c in res["checks"].items():
        assert f"check {name}: {c['value']} (limit {c['limit']})" in err
    assert err.rstrip().splitlines()[-1].startswith("check ")


def test_a_cell_and_a_metric_from_files_alone(capsys, tmp_path):
    from conftest import make_tiny_root
    root = make_tiny_root(str(tmp_path))
    with open(os.path.join(root, "ema_bench", "metrics",
                           "pairs_per_unit.py"), "w") as f:
        f.write("def read(run):\n    return float(run.pairs)\n")
    with open(os.path.join(root, "ema_bench", "traffic",
                           "tiny-short.json"), "w") as f:
        t = json.load(open(os.path.join(root, "ema_bench", "traffic",
                                        "tiny-linked-wgs.json")))
        json.dump(dict(t, name="tiny-short", pool_pairs=1500), f)
    b = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b["workloads"].append({"name": "tiny-short", "config":
                           "tiny-tenx-chr20-stream", "traffic": "tiny-short",
                           "chips": 1, "why": "a dummy"})
    b["per_layer"].append({"name": "pairs_per_unit", "unit": "pairs",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "pairs_per_s",
                           "workloads": ["tiny-short"]})
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    res, _ = _last_line(capsys, ["--workload", "tiny-short", "--seed", "5",
                                 "--seconds", "1", "--trace", "1"], root)
    assert res["correct"] is True
    assert res["metrics"]["pairs_per_unit"]["value"] > 0


def _checks(root, cell, seed, control=None, seconds=1.0):
    res = bench_run.run_cell(root, cell, seed, seconds, False,
                             device="cpu", control=control)
    return res["correct"], {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("seed", [101, 6])
def test_control_em_off_is_not_correct(tiny_root, em_gate, seed):
    """The control (the cloud EM's gate shut) places the reads of exact
    repeat copies off their truth, past the cell's limit, where the
    program's EM places them at it."""
    ok, sound = _checks(tiny_root, "tiny-stream-wgs", seed, seconds=2.0)
    off_ok, off = _checks(tiny_root, "tiny-stream-wgs", seed, "em_off",
                          seconds=2.0)
    assert ok and not off_ok
    assert off["em_off_truth_pct"] > 3 * max(sound["em_off_truth_pct"], 1)


def _cell(root, cell):
    """``cell``, made first where it is a platform's tiny stream cell
    (``tiny-tru``)."""
    from conftest import PLATFORM_READS, add_platform_cell
    if cell[len("tiny-"):] in PLATFORM_READS:
        add_platform_cell(root, cell[len("tiny-"):])
    return cell


STREAM_CELLS = ["tiny-stream-wgs", "tiny-tru"]


@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_fault_half_the_pairs_left_out(tiny_root, monkeypatch, cell):
    from ema_tpu_torch.core.pipeline import Aligner
    real = Aligner.iter_batch_sam

    def halved(self, batch, *a, **kw):
        for lines in real(self, batch, *a, **kw):
            yield [ln for ln in lines
                   if int(ln.split("\t", 1)[0].split("p")[-1]) % 2]
    monkeypatch.setattr(Aligner, "iter_batch_sam", halved)
    ok, got = _checks(tiny_root, _cell(tiny_root, cell), 7)
    assert not ok and got["bad_pairs"] > 0


def test_fault_scorer_returns_its_output_unchanged(tiny_root, monkeypatch):
    """The SW step hands back its output buffer as it found it (zeros).
    (On a stream cell no pass under this fault ends within 15 minutes on
    the CPU, so the stream cells take the emission's fault below.)"""
    import torch
    from ema_tpu_torch.core import pipeline

    def untouched(text, oriented, olens, owners, *a, **kw):
        return torch.zeros((owners.shape[0], 4), dtype=torch.int32,
                           device=owners.device)
    monkeypatch.setattr(pipeline, "gather_score", untouched)
    ok, got = _checks(tiny_root, "tiny-x-wgs", 8)
    assert not ok


@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_fault_emission_returns_its_last_output_unchanged(tiny_root,
                                                          monkeypatch, cell):
    """The SAM text step hands back the lines of its first call on every
    later call, its output never made anew (a window of several flush
    batches: the warm-up's batch is the pool's first, whose lines the
    window's first batch rightly repeats)."""
    from ema_tpu_torch.core import samout
    real = samout.emit_groups_lines
    first = []

    def stale(*a, **kw):
        out = real(*a, **kw)
        if not first:
            first.append(out)
        return first[0]
    monkeypatch.setattr(samout, "emit_groups_lines", stale)
    ok, got = _checks(tiny_root, _cell(tiny_root, cell), 8, seconds=5.0)
    assert not ok and got["bad_pairs"] > 0


@pytest.mark.parametrize("what,cell", [
    ("pos", "tiny-stream-wgs"), ("cigar", "tiny-stream-wgs"),
    ("mi", "tiny-x-wgs"), ("pos", "tiny-tru"), ("cigar", "tiny-tru")])
def test_fault_an_answer_altered_where_it_is_produced(tiny_root,
                                                      monkeypatch, what,
                                                      cell):
    """One record in 50 altered as the SAM text is made: its position
    moved, its CIGAR's first match shortened into a clip, or its MI."""
    from ema_tpu_torch.core import samout
    real = samout.emit_groups_lines

    def alter(ln):
        f = ln.split("\t")
        if int(f[1]) & 4:
            return ln
        if what == "pos":
            f[3] = str(int(f[3]) + 40)
        elif what == "cigar" and f[5].endswith("M") and \
                f[5][:-1].isdigit():
            n = int(f[5][:-1])
            f[5] = f"{n - 10}M10S"
        elif what == "mi":
            f = [("MI:i:" + str(int(t[5:]) + (1 << 30)))
                 if t.startswith("MI:i:") else t for t in f]
        return "\t".join(f)

    def altered(*a, **kw):
        out = real(*a, **kw)
        return [[alter(ln) if i % 50 == 0 else ln
                 for i, ln in enumerate(lines)] for lines in out]
    monkeypatch.setattr(samout, "emit_groups_lines", altered)
    ok, got = _checks(tiny_root, _cell(tiny_root, cell), 9)
    assert not ok
    key = {"pos": "off_truth_pct", "cigar": "sw_gap_max",
           "mi": "mi_outside"}[what]
    assert got[key] > 0


@pytest.mark.parametrize("how", ["moved", "twice"])
def test_fault_a_pair_in_the_wrong_bucket(tiny_root, monkeypatch, how):
    """preproc writes one pair into the next bucket, or into two."""
    from ema_tpu_torch.preproc import correct as pcorrect
    real = pcorrect.correct

    def fault(wl, prefixes, out_dir, f, **kw):
        stats = real(wl, prefixes, out_dir, f, **kw)
        a, b = (os.path.join(out_dir, f"ema-bin-{i:03d}") for i in (0, 1))
        lines = open(a).readlines()
        open(b, "a").write(lines[0])
        if how == "moved":
            open(a, "w").writelines(lines[1:])
        return stats
    monkeypatch.setattr(pcorrect, "correct", fault)
    ok, got = _checks(tiny_root, "tiny-x-wgs", 10)
    assert not ok and got["bucket_wrong"] > 0


@pytest.mark.card
def test_stream_cell_on_the_card(card, capsys):
    """A short run of the real cell (its first run in a checkout builds
    the 64 Mbp index)."""
    res, _ = _last_line(capsys, ["--workload", "stream-wgs", "--seed",
                                 str(np.random.SeedSequence().entropy
                                     % 2 ** 33), "--seconds", "5",
                                 "--trace", "1"], None, device="cuda")
    assert res["correct"] is True
    assert res["device"]["kind"] == card
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
