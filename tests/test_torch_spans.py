"""The port's spans (ema_tpu_torch.utils.metrics) on the CPU.

Each entry of a stage is a span with its thread, parent and batch id;
the stage table is the sum of its spans; with no Metrics on the Aligner
nothing is recorded; an align_stream pass and an align -x call record
the spans the benchmark's readers and the CLI's table read; the spans
share the realtime clock of torch.profiler's events; --profile shows
them in its trace.
"""

import collections
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ema_tpu_torch import cli, config
from ema_tpu_torch.core import pipeline
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.utils import metrics
from ema_tpu_torch.utils.metrics import Metrics
from test_torch_cli import _buckets, _by_rank, _world

# small chunks and flush batches: several of each in a pass
CFG = config.RunConfig(batch_size=8)
FLUSH = 16


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_torch_cli.py's x world (80 kbp, 8 barcodes) and its
    index."""
    tmp = tmp_path_factory.mktemp("spans")
    w = _world(tmp, 15, 80_000, 8, (4, 8), 10_000, 80)
    return tmp, w, cli._load_or_build_index(w[0])


def _groups(w):
    """The world's pairs as align_stream takes them: whole barcode
    groups, in barcode order."""
    _, ids, _, bcs, s1, q1, s2, q2, _ = w
    out = []
    for i in np.argsort(np.asarray(bcs), kind="stable"):
        if not out or out[-1][1][0] != bcs[i]:
            out.append(([], [], [], [], [], []))
        for lst, v in zip(out[-1], (ids[i], bcs[i], s1[i], q1[i], s2[i],
                                    q2[i])):
            lst.append(v)
    return out


def _aligner(idx, met):
    al = pipeline.Aligner(idx, CFG, device="cpu")
    al.metrics = met
    return al


def _stream(idx, groups, met):
    al = _aligner(idx, met)
    return [ln for part in al.align_stream(iter(groups), flush_pairs=FLUSH)
            for ln in part]


@pytest.fixture(scope="module")
def streamed(world):
    """One traced align_stream pass: (groups, Metrics, lines, the
    calling thread)."""
    _, w, idx = world
    groups = _groups(w)
    met = Metrics()
    lines = _stream(idx, groups, met)
    return groups, met, lines, threading.get_ident()


def test_spans_nest_by_thread_and_a_chunk_hangs_off_its_batch(streamed):
    _, met, _, caller = streamed
    parent_names = collections.defaultdict(set)
    for sp in met.spans:
        if sp.parent is None:
            assert sp.thread == caller
            continue
        parent_names[sp.name].add(sp.parent.name)
        assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns \
            <= sp.parent.end_ns
        if sp.name == "chunk":
            # handed across threads: a pool worker's span under the
            # caller's batch
            assert sp.thread != caller and sp.parent.thread == caller
        else:
            assert sp.thread == sp.parent.thread
    assert parent_names["chunk"] == {"batch"}
    for name in ("seed[smem,host]", "locate[native,host]", "chain[host]",
                 "sw[device]", "traceback+finalize[host]"):
        assert parent_names[name] == {"chunk"}
    for name in ("pool.wait", "sweep[host]", "em[host]",
                 "select+emit[host]"):
        assert parent_names[name] == {"batch"}
    assert parent_names["kmer_table"] == {"seed[smem,host]"}
    assert len([sp for sp in met.spans if sp.name == "batch"]) > 1
    assert len([sp for sp in met.spans if sp.name == "chunk"]) > \
        len([sp for sp in met.spans if sp.name == "batch"])


def test_every_span_of_one_call_carries_its_batch_id(world):
    _, w, idx = world
    cols = list(zip(*_groups(w)))
    batch = ReadBatch.from_pairs(*[sum(map(list, c), []) for c in cols])
    met = Metrics()
    al = _aligner(idx, met)
    ids = []
    for _ in range(2):
        n0 = len(met.spans)
        assert al.align_batch_to_sam(batch)
        spans = met.spans[n0:]
        (root,) = [sp for sp in spans if sp.name == "batch"]
        assert {sp.batch for sp in spans} == {root.batch}
        assert len(spans) > 10
        ids.append(root.batch)
    assert ids[0] != ids[1]


def test_a_flush_batch_prep_and_groups_carry_its_batch_id(streamed):
    _, met, _, _ = streamed
    roots = {sp.batch for sp in met.spans if sp.name == "batch"}
    # the drain's from_pairs, before the batch's span opens
    drained = {sp.batch for sp in met.spans
               if sp.name == "batch.prep" and sp.parent is None}
    assert drained == roots
    assert {sp.batch for sp in met.spans if sp.name == "stream.group"} \
        <= roots
    assert all(sp.batch is None for sp in met.spans
               if sp.name == "stream.read")


def test_each_stage_sum_is_the_sum_of_its_spans(streamed):
    _, met, _, _ = streamed
    by = collections.defaultdict(list)
    for sp in met.spans:
        by[sp.name].append(sp)
    assert set(by) == set(met.wall)
    for name, sps in by.items():
        # sum() compensates its rounding, the table adds in turn
        assert met.wall[name] == pytest.approx(
            sum(sp.seconds for sp in sps), rel=1e-12)
        assert met.items.get(name, 0) == sum(sp.n_items for sp in sps)


def test_one_stream_group_span_per_group(streamed):
    groups, met, lines, _ = streamed
    gs = [sp for sp in met.spans if sp.name == "stream.group"]
    assert len(gs) == len(groups)
    assert sorted(sp.n_items for sp in gs) == sorted(len(g[0])
                                                     for g in groups)
    assert all(0 < sp.start_ns <= sp.end_ns for sp in gs)
    reads = [sp for sp in met.spans if sp.name == "stream.read"]
    assert sum(sp.n_items for sp in reads) == sum(len(g[0])
                                                  for g in groups)
    assert len(lines) == 2 * sum(len(g[0]) for g in groups)


def test_without_metrics_no_span_and_no_observer_call(world, streamed,
                                                      monkeypatch):
    """The default (Aligner.metrics None): nothing is opened, recorded or
    handed on, and the SAM lines are the traced pass's."""
    _, w, idx = world
    calls = []
    monkeypatch.setattr(metrics, "SPAN_OBSERVERS", [calls.append])

    def refuse(*a, **kw):
        raise AssertionError("a span was recorded")
    for name in ("stage", "record", "_close"):
        monkeypatch.setattr(Metrics, name, refuse)
    monkeypatch.setattr(pipeline, "new_batch_id", refuse)
    lines = _stream(idx, _groups(w), None)
    assert lines == streamed[2]
    assert calls == []


def test_a_stream_closed_early_leaves_no_span_open(world):
    _, w, idx = world
    met = Metrics()
    st = _aligner(idx, met).align_stream(iter(_groups(w)),
                                         flush_pairs=FLUSH)
    assert next(st)
    st.close()
    assert all(0 < sp.start_ns <= sp.end_ns for sp in met.spans)
    assert "batch" in met.wall
    with met.stage("after") as sp:
        assert sp.parent is None


@pytest.mark.parametrize("mode", [[], ["--no-coalesce", "-j", "2"]],
                         ids=["coalesced", "j2"])
def test_x_call_spans(world, tmp_path, monkeypatch, mode):
    """A tiny align -x over 3 buckets: the set-up once a call, a read and
    a part write a bucket."""
    _, w, _ = world
    buckets = _buckets(tmp_path, w, _by_rank(w, 3), 3)
    got = []
    monkeypatch.setattr(metrics, "SPAN_OBSERVERS", [got.append])
    monkeypatch.setenv("EMA_TPU_STAGE_TIMERS", "1")
    assert cli.main(["align", "-r", w[0], "--device", "cpu", "-x", "-o",
                     str(tmp_path / "x.sam"), *mode, *buckets]) == 0
    n = collections.Counter(sp.name for sp in got)
    assert [n[k] for k in ("index_load", "aligner.init", "x.concat",
                           "kmer_table")] == [1, 1, 1, 1]
    assert n["bucket.read"] == n["part.write"] == 3
    assert not {"read_input", "write_output"} & set(n)
    pairs = sum(1 for b in buckets for _ in open(b))
    assert sum(sp.n_items for sp in got if sp.name == "bucket.read") == pairs
    assert sum(sp.n_items for sp in got
               if sp.name == "part.write") == 2 * pairs
    if not mode:
        # the three buckets make one coalesced batch
        assert len({sp.batch for sp in got if sp.name in (
            "bucket.read", "batch.prep", "align", "batch", "chunk",
            "part.write")}) == 1


def test_concurrent_spans_keep_their_sums_and_parents():
    """More threads than cores, switching every microsecond: no update of
    the table is lost and every span's parent is its own thread's."""
    met = Metrics()
    n_threads = min(4 * (os.cpu_count() or 1), 64)
    per = 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with met.stage("outer", 1):
                    with met.stage("inner", 2):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert met.items == {"outer": n_threads * per,
                         "inner": 2 * n_threads * per}
    assert len(met.spans) == 2 * n_threads * per
    inner = [sp for sp in met.spans if sp.name == "inner"]
    assert len(inner) == n_threads * per
    assert all(sp.parent.name == "outer" and sp.parent.thread == sp.thread
               for sp in inner)
    assert all(sp.parent is None for sp in met.spans if sp.name == "outer")


def test_a_span_brackets_the_profiler_event_it_holds():
    """The spans' clock is the profiler's: a span around a
    record_function region starts and ends within 1 ms of the region's
    event."""
    from torch.profiler import ProfilerActivity, profile, record_function
    met = Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            torch.ones(4).sum()
        with met.stage("outer") as sp:
            with record_function("ema_region"):
                torch.ones(256).sum()
                time.sleep(0.02)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "ema_region"]
    start = ev.start_ns()
    end = start + ev.duration_ns()
    assert sp.start_ns <= start < sp.start_ns + 1_000_000
    assert sp.end_ns - 1_000_000 < end <= sp.end_ns


def test_profile_trace_shows_the_spans(world, tmp_path):
    """--profile attaches the CLI's Metrics and makes each span a region
    of the trace."""
    _, w, _ = world
    (bucket,) = _buckets(tmp_path, w, lambda b: 0, 1)
    prof = tmp_path / "prof"
    assert cli.main(["align", "-r", w[0], "--device", "cpu", "-s", bucket,
                     "-o", str(tmp_path / "p.sam"), "--profile",
                     str(prof)]) == 0
    names = {e.get("name") for e in
             json.loads((prof / "trace.json").read_text())["traceEvents"]}
    assert {"align", "batch", "batch.prep", "chunk", "seed[smem,host]",
            "sw[device]", "pool.wait", "sweep[host]",
            "select+emit[host]"} <= names
