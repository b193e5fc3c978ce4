"""The program's own spans (``ema_tpu_torch.utils.metrics``), as the
readers of the per-layer metrics that rest on them find them, and a
traced run whose device idle gaps they name.

In a traced run the port times itself: the stream cell's Aligner holds
``run.metrics_obj`` (its stage table, ``run.stages``, and its spans), and
each ``align -x`` call's CLI keeps a table of its own, kept per call in
``run.driver.calls`` (``drivers.XDriver``).  On a program without these
stages or spans every reader returns None.

    python3 -m ema_bench.program_spans --workload <cell> --seed <n>
        --seconds <s>

runs the cell as ``python3 -m ema_bench.run ... --trace 1`` does (a
traced run hands each program span of its window to the run's spans
through the port's ``SPAN_OBSERVERS``, ``run.Run.observe``, so that
``breakdown.idle_gaps`` name each gap by the shortest span that holds
it, the program's included), then prints a second JSON line: the
device's idle seconds by the innermost span open on the main thread,
and the shares of the idle time and of the main thread's wall that lie
inside a span of work (any span but ``ROOTS``).
"""

from __future__ import annotations

import json
import sys
import threading
from typing import List, Optional

from ema_bench import run as bench_run
from ema_bench import yardstick

# spans that hold the work of others: their self time is unnamed work
# (``batch``, the CLI's ``align``) or no work at all (``stream.group``, a
# group's latency)
ROOTS = ("batch", "align", "stream.group")


def per_kpair(run, seconds: Optional[float]) -> Optional[float]:
    """``seconds`` per 1,000 pairs emitted in the window."""
    if seconds is None or not run.pairs:
        return None
    return seconds / (run.pairs / 1000.0)


def stage_s(run, name: str) -> Optional[float]:
    """Seconds of stage ``name`` in the window's stage table."""
    return (run.stages or {}).get(name)


def call_tables(run) -> List[dict]:
    """The stage table of each ``align -x`` call of the window."""
    return [c[3] for c in getattr(run.driver, "calls", None) or []]


def span_seconds(run, name: str) -> List[float]:
    """Durations of the stream Aligner's spans ``name`` that lie in the
    window."""
    spans = getattr(run.metrics_obj, "spans", None) or []
    a, b = run.window_start, run.window_end
    return [sp.seconds for sp in spans
            if sp.name == name and a <= sp.start_ns and sp.end_ns <= b]


def innermost(spans, t0: int, t1: int) -> list:
    """[(start, end, name)]: [t0, t1] cut by the innermost of ``spans``
    ((start, end, name), one thread's, nested) that holds each piece;
    name None where none does."""
    out = []
    stack = []          # (end, name), the innermost last
    cur = t0

    def upto(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end
        if t > cur:
            out.append((cur, t, stack[-1][1] if stack else None))
            cur = t

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        upto(s)
        stack.append((e, name))
    upto(t1)
    return out


def overlap(pieces, merged) -> list:
    """[(name, ns)] of each (start, end, name) piece's overlap with the
    sorted, disjoint intervals ``merged``."""
    out = []
    j = 0
    for s, e, name in pieces:
        while j < len(merged) and merged[j][1] <= s:
            j += 1
        k, ns = j, 0
        while k < len(merged) and merged[k][0] < e:
            ns += min(e, merged[k][1]) - max(s, merged[k][0])
            k += 1
        out.append((name, ns))
    return out


def idle_intervals(events, t0: int, t1: int) -> list:
    """The device's idle intervals in [t0, t1]: the complement of its
    events' union."""
    busy = yardstick.merge([(max(s, t0), min(e, t1))
                            for _, _, s, e in events if e > t0 and s < t1])
    out, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            out.append([prev, s])
        prev = max(prev, e)
    return out


def shares(spans, main: int, t0: int, t1: int,
           idle: Optional[list]) -> dict:
    """What the program's spans (Span objects) say of the window
    [t0, t1]: the share of the main thread's wall inside a span of
    work, and with the device's ``idle`` intervals, the share of idle
    time inside one (any thread) and the idle seconds by the innermost
    span on the main thread."""
    work = [sp for sp in spans if sp.name not in ROOTS]

    def union(sps):
        return yardstick.merge([(max(sp.start_ns, t0), min(sp.end_ns, t1))
                                for sp in sps
                                if min(sp.end_ns, t1) > max(sp.start_ns, t0)])
    main_work = union(sp for sp in work if sp.thread == main)
    out = {"spans": len(spans), "window_s": (t1 - t0) / 1e9,
           "main_in_work_span_pct":
               100.0 * yardstick.span(main_work) / (t1 - t0)}
    if idle is None:
        return out
    idle_ns = yardstick.span(idle)
    in_work = sum(ns for _, ns in overlap(
        [(s, e, None) for s, e in union(work)], idle))
    pieces = innermost([(sp.start_ns, sp.end_ns, sp.name) for sp in spans
                        if sp.thread == main and sp.name != "stream.group"],
                       t0, t1)
    by_name = {}
    for name, ns in overlap(pieces, idle):
        key = name or "(no span)"
        by_name[key] = by_name.get(key, 0) + ns
    out.update({
        "idle_s": idle_ns / 1e9,
        "idle_in_work_span_pct": (100.0 * in_work / idle_ns
                                  if idle_ns else None),
        "idle_s_by_main_span": sorted(
            ([k, v / 1e9] for k, v in by_name.items()),
            key=lambda kv: -kv[1]),
    })
    return out


def main(argv=None, root=None, device: str = "cuda") -> int:
    """``ema_bench.run``'s command line, traced (where every run's
    program spans name the idle gaps), and a second line of shares
    (``shares``).  ``root`` and ``device`` are for the tests."""
    runs = []
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = bench_run.main(argv + ["--trace", "1"], root=root, device=device,
                        runs=runs)
    if rc != 0 or not runs:
        return rc
    r = runs[-1]
    idle = None
    if r.prof is not None:
        from ema_bench.trace import device_events
        idle = idle_intervals(device_events(r.prof), r.window_start,
                              r.window_end)
    print(json.dumps({"program_spans": shares(
        r.program, threading.main_thread().ident, r.window_start,
        r.window_end, idle)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
