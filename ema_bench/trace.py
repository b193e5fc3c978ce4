"""What a traced run records besides the program's own stage table: the
device's activity from torch.profiler, the harness's spans around its
calls into the port, and the cells of every SW launch, handed over by
``ema_tpu_torch.ops.sw.LAUNCH_OBSERVERS``."""

from __future__ import annotations

import threading

from ema_bench import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """The harness's own spans, (name, start_ns, end_ns), on the host's
    realtime clock, which is the profiler's time base."""

    def __init__(self, on: bool):
        self.on = on
        self.items = []

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.items.append((name, t0, t1))

    def label(self, t: float) -> str:
        """The shortest span that holds time ``t`` (ns)."""
        best = None
        for name, a, b in self.items:
            if a <= t <= b and (best is None or b - a < best[0]):
                best = (b - a, name)
        return best[1] if best else "harness"


class SwLaunches:
    """Each SW call of the window once: its kernel and the tensors that
    give its cells, kept until the window has closed."""

    def __init__(self):
        self.calls = {}
        self._lock = threading.Lock()

    def observe(self, name, stream, read, written) -> None:
        olens, owners, win_len, wl = read[2], read[3], read[5], read[6]
        with self._lock:
            self.calls.setdefault(id(written[0]),
                                  (name, olens, owners, win_len, wl,
                                   written[0]))

    def bounds(self, peak: dict) -> dict:
        """kernel -> the least seconds of its calls (yardstick.bound_s)."""
        out = {}
        for name, olens, owners, win_len, wl, _ in self.calls.values():
            rl = olens.long()[owners.long()]
            width = win_len if name == "sw_batch" else wl
            cells = float((rl * width.long()).sum())
            n_bytes = float(rl.sum() + win_len.long().sum()
                            + yardstick.SW_CANDIDATE_BYTES * owners.numel())
            out[name] = out.get(name, 0.0) + yardstick.bound_s(
                name, cells, n_bytes, peak)
        return out


class RssSampler:
    """Peak resident memory of this process, read from /proc/self/status
    every ``period`` seconds on a thread of its own."""

    def __init__(self, period: float = 0.05):
        self.period = period
        self.peak = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) * 1024
        return 0

    def _run(self) -> None:
        while True:
            self.peak = max(self.peak, self.rss())
            if self._stop.wait(self.period):
                break

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=10)
        self.peak = max(self.peak, self.rss())


def _category(e) -> str:
    """An event's kineto activity type; torch builds whose events lack
    ``activity_type`` name copies and memsets by their event names."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def device_events(prof):
    """[(name, category, start_ns, end_ns)] of the device's kernels,
    copies and memsets in a finished torch.profiler session, on the
    host's realtime clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            cat = _category(e)
            if cat in DEVICE_CATS:
                s = int(e.start_ns())
                out.append((e.name(), cat, s, s + int(e.duration_ns())))
    return out


def summarize(events, t0: int, t1: int, spans: Spans) -> dict:
    """Busy seconds, device operations by time, and the idle gaps of the
    window [t0, t1] (ns), each gap named by the harness's span."""
    inside = [(n, c, max(s, t0), min(e, t1)) for n, c, s, e in events
              if e > t0 and s < t1]
    merged = yardstick.merge([(s, e) for _, _, s, e in inside])
    by_name = {}
    for n, _, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    gaps = []
    prev = t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": yardstick.span(merged) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "n_events": len(inside),
        "device_ops": [[n[:160], v] for n, v in top_ops],
        "idle_gaps": [[f"{spans.label((a + b) / 2)} @{(a - t0) / 1e9}s",
                       g / 1e9] for g, a, b in gaps[:10]],
        "kernel_s": {k: sum((e - s) / 1e9 for n, _, s, e in inside
                            if sym in n)
                     for k, sym in yardstick.KERNEL_SYMBOL.items()},
    }
