"""Stage timing, spans and the CLI's ``--profile``.

The counterpart of ema_tpu/utils/metrics.py: every pipeline stage reports
into a ``Metrics`` registry (counts, wall seconds, derived rates) that the
CLI prints as a summary table; ``device_trace`` is a ``torch.profiler``
trace where the JAX package wraps jax.profiler.

Each entry of a stage is also kept as a ``Span``: its name, start and
end on ``time.time_ns()`` (the realtime clock of torch.profiler's kineto
events), its thread, its parent (the span open on the same thread, or
one passed in from another thread), its batch id (shared by the spans of
one flush batch or coalesced ``-x`` batch) and its item count.  Each
closed span is handed to every callable in ``SPAN_OBSERVERS``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

# callables handed every span as it closes, by any Metrics in the process
# (a benchmark's traced window registers one to name the device's idle
# gaps by the program's spans)
SPAN_OBSERVERS: List[Callable[["Span"], None]] = []

_batch_ids = itertools.count(1)


def new_batch_id() -> int:
    """A batch id no other batch in this process carries."""
    return next(_batch_ids)


class Span:
    """One timed entry of a stage."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "batch",
                 "n_items")

    def __init__(self, name: str, start_ns: int, end_ns: int, thread: int,
                 parent: Optional["Span"], batch: Optional[int],
                 n_items: int):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.thread = thread
        self.parent = parent
        self.batch = batch
        self.n_items = n_items

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Metrics:
    """Accumulates per-stage wall time and item counts, and keeps every
    span.  While ``annotate`` is set (the CLI's ``--profile``), each span
    is also a ``torch.profiler.record_function`` region."""

    def __init__(self) -> None:
        self.wall: Dict[str, float] = {}
        self.items: Dict[str, int] = {}
        self.spans: List[Span] = []
        self.annotate = False
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._open = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0, *,
              parent: Optional[Span] = None, batch: Optional[int] = None):
        """Time the block as one span of stage ``name``; yields the span,
        whose ``n_items`` the block may set.  ``parent`` defaults to the
        span open on this thread, ``batch`` to the parent's."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        if parent is None and stack:
            parent = stack[-1]
        if batch is None and parent is not None:
            batch = parent.batch
        sp = Span(name, 0, 0, threading.get_ident(), parent, batch, n_items)
        stack.append(sp)
        region = (torch.profiler.record_function(name) if self.annotate
                  else contextlib.nullcontext())
        try:
            with region:
                sp.start_ns = time.time_ns()
                try:
                    yield sp
                finally:
                    sp.end_ns = time.time_ns()
        finally:
            # a generator holding the span may be closed out of order
            stack.remove(sp)
            self._close(sp)

    def record(self, name: str, start_ns: int, end_ns: int,
               n_items: int = 0, *, batch: Optional[int] = None) -> None:
        """A span the caller timed: one that starts on one code path and
        ends on another, or a count (``start_ns == end_ns``)."""
        self._close(Span(name, start_ns, end_ns, threading.get_ident(), None,
                         batch, n_items))

    def _close(self, sp: Span) -> None:
        with self._lock:
            self.wall[sp.name] = self.wall.get(sp.name, 0.0) + sp.seconds
            if sp.n_items:
                self.items[sp.name] = (self.items.get(sp.name, 0)
                                       + sp.n_items)
            self.spans.append(sp)
        for observe in SPAN_OBSERVERS:
            observe(sp)

    def summary(self) -> str:
        total = time.time() - self._t0
        lines = [f":: total wall time: {total:.2f}s"]
        for name in sorted(self.wall):
            w = self.wall[name]
            n = self.items.get(name, 0)
            rate = f" ({n / w:.0f}/s)" if n and w > 0 else ""
            cnt = f" n={n}" if n else ""
            lines.append(f"::   {name}: {w:.2f}s{cnt}{rate}")
        return "\n".join(lines)

    def report(self, stream=sys.stderr) -> None:
        stream.write(self.summary() + "\n")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device: torch.device,
                 metrics: Optional[Metrics] = None):
    """A torch.profiler trace around a region when ``log_dir`` is set:
    host activity, and CUDA activity when ``device`` is a card, written
    to ``log_dir/trace.json`` (Chrome trace format).  ``metrics``' spans
    are regions of the trace while it records."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        # the chunk workers' spans and launches too, where torch can
        every_thread = {"experimental_config":
                        torch.profiler._ExperimentalConfig(
                            profile_all_threads=True)}
    except (AttributeError, TypeError):
        every_thread = {}
    with profile(activities=activities, **every_thread) as prof:
        if metrics is not None:
            metrics.annotate = True
        try:
            yield
        finally:
            if metrics is not None:
                metrics.annotate = False
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
