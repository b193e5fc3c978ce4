"""The readers of the program's own spans (``program_spans.py``): on a
program that has them they read numbers, on one that lacks them (the
API before the port recorded spans) nothing and no error; the
arithmetic that names idle time by the program's spans; and, on the
card, the spans' clock against a CUDA kernel's interval in the
profiler's trace."""

import contextlib
import json
import threading
import time
import types

import pytest

from ema_bench import program_spans as ps
from ema_bench import run as bench_run

NEW = {"read_s_per_kpair", "chunk_wait_s_per_kpair", "x_call_setup_s",
       "group_ready_p95_s"}

# the stages the port timed before it recorded spans
PARENT_STAGES = {"seed[smem,host]", "seed[native,host]",
                 "seed+locate[device]", "seed[device]",
                 "locate[native,host]", "locate[device]", "chain[host]",
                 "sw[device]", "traceback+finalize[host]", "em[device]",
                 "em[host]", "select+emit[host]", "index_load", "align",
                 "read_input", "write_output"}


class ParentMetrics:
    """The port's Metrics as it was before spans: thread-second sums of
    its own stages, no spans, no observers."""

    def __init__(self):
        self.wall = {}
        self.items = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name, n_items=0, **span):
        t = time.time()
        try:
            yield types.SimpleNamespace(n_items=n_items, batch=None)
        finally:
            if name in PARENT_STAGES:
                with self._lock:
                    self.wall[name] = self.wall.get(name, 0.0) + (
                        time.time() - t)

    def record(self, *a, **kw):
        pass

    def summary(self):
        return ""

    def report(self, stream=None):
        pass


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


@pytest.mark.parametrize("cell", ["tiny-stream-wgs", "tiny-x-wgs"])
def test_new_metrics_read_nothing_on_the_parents_api(capsys, tiny_root,
                                                     monkeypatch, cell):
    from ema_tpu_torch.utils import metrics
    monkeypatch.setattr(metrics, "Metrics", ParentMetrics)
    monkeypatch.delattr(metrics, "SPAN_OBSERVERS")
    argv = ["--workload", cell, "--seed", str(2 ** 31 + 12), "--seconds",
            "1"]
    assert bench_run.main(argv + ["--trace", "1"], root=tiny_root,
                          device="cpu") == 0
    (res,) = _lines(capsys)
    assert res["correct"] is True
    assert not NEW & set(res["metrics"])
    assert {"seed_s_per_kpair", "emit_s_per_kpair"} <= set(res["metrics"])
    # the tool that names the gaps runs there too, and finds no span
    assert ps.main(argv, root=tiny_root, device="cpu") == 0
    res, extra = _lines(capsys)
    assert not NEW & set(res["metrics"])
    assert extra["program_spans"]["spans"] == 0


def test_the_stream_cell_reads_its_new_metrics(capsys, tiny_root):
    """A traced run of the stream cell through the tool: the stream's new
    metrics read numbers, and the main thread is inside a span of work
    most of the window."""
    assert ps.main(["--workload", "tiny-stream-wgs", "--seed",
                    str(2 ** 31 + 13), "--seconds", "1"], root=tiny_root,
                   device="cpu") == 0
    res, extra = _lines(capsys)
    assert res["correct"] is True
    for name in ("read_s_per_kpair", "chunk_wait_s_per_kpair",
                 "group_ready_p95_s"):
        v = res["metrics"][name]["value"]
        assert isinstance(v, float) and v > 0
    got = extra["program_spans"]
    assert got["spans"] > 0 and "idle_s" not in got
    assert 50 < got["main_in_work_span_pct"] <= 100


def test_idle_time_by_the_innermost_main_thread_span():
    from ema_tpu_torch.utils.metrics import Span
    main, worker = 1, 2

    def sp(name, s, e, thread=main):
        return Span(name, s, e, thread, None, None, 0)
    spans = [sp("batch", 0, 100), sp("pool.wait", 10, 30),
             sp("sweep[host]", 40, 50), sp("stream.read", 100, 150),
             sp("stream.group", 5, 180), sp("chunk", 0, 60, worker)]
    pieces = ps.innermost([(s.start_ns, s.end_ns, s.name) for s in spans
                           if s.thread == main and s.name != "stream.group"],
                          0, 200)
    assert pieces == [(0, 10, "batch"), (10, 30, "pool.wait"),
                      (30, 40, "batch"), (40, 50, "sweep[host]"),
                      (50, 100, "batch"), (100, 150, "stream.read"),
                      (150, 200, None)]
    idle = ps.idle_intervals([("k", "kernel", 0, 20), ("k", "kernel", 45,
                                                        120)], 0, 200)
    assert idle == [[20, 45], [120, 200]]
    got = ps.shares(spans, main, 0, 200, idle)
    assert got["idle_s"] == 105 / 1e9
    assert got["idle_in_work_span_pct"] == pytest.approx(100 * 55 / 105)
    assert got["main_in_work_span_pct"] == pytest.approx(40.0)
    assert dict(got["idle_s_by_main_span"]) == pytest.approx({
        "pool.wait": 10e-9, "batch": 10e-9, "sweep[host]": 5e-9,
        "stream.read": 30e-9, "(no span)": 50e-9})


@pytest.mark.card
def test_a_span_brackets_a_cuda_kernel(card):
    """The spans' clock is the device trace's: a span around a kernel's
    launch and synchronize holds the kernel's interval, within 1 ms of
    its start and end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ema_bench.trace import device_events
    from ema_tpu_torch.utils.metrics import Metrics
    met = Metrics()
    x = torch.ones(1 << 24, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (x * 2).sum()
        torch.cuda.synchronize()
        with met.stage("outer") as sp:
            x.mul_(3)
            torch.cuda.synchronize()
    kernels = [e for e in device_events(prof) if e[1] == "kernel"]
    _, _, start, end = max(kernels, key=lambda e: e[2])
    assert sp.start_ns <= start < sp.start_ns + 1_000_000
    assert sp.end_ns - 1_000_000 < end <= sp.end_ns
