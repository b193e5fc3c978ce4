"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m ema_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control em_off]

The cell names a configuration (``configs/<name>.json``: the reference
genome, read shapes, platform, driver and the limits of the check) and a
traffic mix (``traffic/<name>.json``, whose own ``limits``, where it has
them, replace the configuration's of the same names for its cells);
per-layer metrics are read by ``metrics/<name>.py``.  A run makes its
reads from ``--seed``, sets up
(the index from the cache, inputs, one warm-up unit), measures for
``--seconds`` and checks the window's SAM against the plain reference in
``samcheck.py``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.

``--control em_off`` shuts the cloud EM's gate (no barcode group is
large enough), breaking the configuration's EM guarantee: the check must
then read not correct.  Nothing in BENCHMARK.json passes it.

Exits 3 without a CUDA card (or with fewer than the cell asks for),
4 if jax, jaxlib, flax or ema_tpu were loaded, printing no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ema_bench import cache, generate, samcheck
from ema_bench.drivers import DRIVERS
from ema_bench.trace import RssSampler, Spans, SwLaunches

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ema_tpu")


def log(msg: str) -> None:
    print(f"ema_bench: {msg}", file=sys.stderr, flush=True)


def process_start_ns() -> int:
    """This process's start on the realtime clock, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    age = up - ticks / os.sysconf("SC_CLK_TCK")
    return time.time_ns() - int(age * 1e9)


def written_bytes() -> int:
    """Bytes this process has written so far (``wchar`` of
    /proc/self/io: files deleted before they reach the disk included)."""
    with open("/proc/self/io") as f:
        for ln in f:
            if ln.startswith("wchar:"):
                return int(ln.split()[1])
    return 0


def limits_of(config: dict, traffic: dict) -> dict:
    """The limits of a cell's check: the configuration's, each that the
    traffic mix's ``limits`` names replaced by the mix's.  A name the
    configuration lacks is refused, as is a limit that is not a number:
    a mix sets no number of its own and leaves none uncompared."""
    lim = dict(config["limits"])
    mix = traffic.get("limits", {})
    extra = sorted(set(mix) - set(lim))
    if extra:
        raise SystemExit(f"ema_bench: traffic {traffic['name']!r} sets "
                         f"limits that configuration {config['name']!r} "
                         f"does not have: {', '.join(extra)}")
    bad = sorted(k for k, v in mix.items()
                 if isinstance(v, bool) or not isinstance(v, (int, float)))
    if bad:
        raise SystemExit(f"ema_bench: traffic {traffic['name']!r} gives "
                         f"no number for: {', '.join(bad)}")
    lim.update(mix)
    return lim


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a reference package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.here = os.path.join(root, "ema_bench")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"ema_bench: no workload {name!r} in "
                         "BENCHMARK.json")

    def data(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.here, kind, name + ".json")) as f:
            return json.load(f)

    def metrics_of(self, cell: str, trace: bool) -> list:
        if not trace:
            return [m for m in self.spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        path = os.path.join(self.here, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"ema_bench_metric_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """One run's state: what the drivers, the check and the metric
    readers share."""

    def __init__(self, bench: Bench, cell: dict, seed: int, trace: bool,
                 device, tmp: str):
        import torch
        self.bench = bench
        self.cell = cell
        self.config = bench.data("configs", cell["config"])
        self.traffic = bench.data("traffic", cell["traffic"])
        self.seed = seed
        self.trace = trace
        self.device = device
        self.tmp = tmp
        self.spans = Spans(trace)
        self.sw = SwLaunches()
        self.window_start = self.window_end = None
        self.prof = None
        self.rss = None
        self.program = []
        self.metrics_obj = None
        self.stages = None
        self.device_kind = (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")
        self.log = log

    def _span_observers(self):
        """The port's list of span observers; None on a program that
        records no spans."""
        from ema_tpu_torch.utils import metrics
        return getattr(metrics, "SPAN_OBSERVERS", None)

    def observe(self, sp) -> None:
        """A program span of the window: kept, and but for a group's
        latency (``stream.group``, no work) added to the spans that name
        the device's idle gaps."""
        self.program.append(sp)
        if sp.name != "stream.group":
            self.spans.add(sp.name, sp.start_ns, sp.end_ns)

    def open_window(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.trace:
            from ema_tpu_torch.ops import sw as psw
            psw.LAUNCH_OBSERVERS.append(self.sw.observe)
            observers = self._span_observers()
            if observers is not None:
                observers.append(self.observe)
            if self.device.type == "cuda":
                from torch.profiler import ProfilerActivity, profile
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
        self.rss = RssSampler().__enter__()
        self.window_start = time.time_ns()

    def close_window(self) -> None:
        if self.window_end is not None:
            return
        self.window_end = time.time_ns()
        if self.metrics_obj is not None:
            self.stages = dict(self.metrics_obj.wall)
        self.rss.__exit__(None, None, None)
        if self.trace:
            from ema_tpu_torch.ops import sw as psw
            psw.LAUNCH_OBSERVERS.remove(self.sw.observe)
            observers = self._span_observers()
            if observers is not None and self.observe in observers:
                observers.remove(self.observe)
            if self.prof is not None:
                self.prof.__exit__(None, None, None)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control=None,
             runs=None) -> dict:
    """One run of a cell; returns the result line's dict (``checks``
    last).  ``device`` 'cpu' runs the port's plain PyTorch paths (tests
    only: the benchmark itself refuses to run without a card).  The
    run's ``Run`` is appended to ``runs`` where it is given."""
    t_start = process_start_ns()
    bench = Bench(root)
    cell = bench.cell(workload)
    import torch
    from ema_tpu_torch import config as pconfig
    from ema_tpu_torch.utils.backend import resolve_device

    if control == "em_off":
        pconfig.MIN_PAIRS_FOR_EM = 1 << 40
    elif control is not None:
        raise SystemExit(f"ema_bench: unknown control {control!r}")
    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="ema_bench_")
    try:
        run = Run(bench, cell, seed, trace, dev, tmp)
        if runs is not None:
            runs.append(run)
        cfg = run.config
        lim = limits_of(cfg, run.traffic)
        port_root = os.path.dirname(os.path.abspath(
            sys.modules["ema_tpu_torch"].__file__))
        ref = cache.ensure(cfg, port_root,
                           os.path.join(bench.here, "cache"), log)
        run.ref = ref
        genome = np.load(ref.genome, mmap_mode="r")
        repeats = np.load(ref.repeats)
        rng = np.random.default_rng(seed)
        s = cfg["sample"]
        sample = generate.make_sample(rng, genome, s["snv_rate"],
                                      s["indel_rate"], s["indel_len"])
        run.pool = generate.make_pool(rng, sample, repeats, cfg["reads"],
                                      run.traffic,
                                      int(run.traffic["pool_pairs"]),
                                      platform=cfg["platform"])
        del sample
        driver = DRIVERS[cfg["driver"]](run)
        driver.setup()
        if trace and cfg["driver"] == "stream":
            from ema_tpu_torch.utils.metrics import Metrics
            driver.aligner.metrics = run.metrics_obj = Metrics()
        if trace:
            # the CLI hands its Metrics to the Aligner under this (x cells)
            os.environ["EMA_TPU_STAGE_TIMERS"] = "1"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.spans.items.clear()
        if hasattr(driver, "latencies"):
            driver.latencies.clear()
        setup_s = (time.time_ns() - t_start) / 1e9
        run.open_window()
        driver.window(seconds)
        run.close_window()
        wall = (run.window_end - run.window_start) / 1e9
        peak_bytes = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)

        # the check, once the window has closed and the program's state
        # is let go
        driver.aligner = None
        t_check = time.time()
        recs = samcheck.Records(run.pool)
        pairs = driver.collect(recs)
        got = samcheck.check(recs, genome, cfg["scoring"],
                             np.random.default_rng([seed, 11]),
                             int(cfg["check_sample_records"]),
                             int(cfg["tol_bp"]))
        t_check = time.time() - t_check
        checks = {k: {"value": got[k], "limit": lim[k]} for k in lim}
        correct = all(c["value"] <= c["limit"] for c in checks.values())

        run.pairs = pairs
        run.wall = wall
        run.setup_s = setup_s
        run.driver = driver
        if trace and dev.type == "cuda":
            from ema_bench.trace import device_events, summarize
            evs = device_events(run.prof)
            run.device_summary = summarize(evs, run.window_start,
                                           run.window_end, run.spans)
        else:
            run.device_summary = None
        if run.stages is None:
            run.stages = (driver.stages() if hasattr(driver, "stages")
                          else {})
        metrics = {}
        for m in bench.metrics_of(workload, trace):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {
            "correct": bool(correct),
            # pairs due in the window: the stream's completed groups (of
            # which a sample is checked), the x calls' buckets
            "attempted": int(max(pairs, recs.due_records // 2)),
            "failed": int(recs.bad_pairs),
            "metrics": metrics,
            "device": {
                "platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": run.device_kind,
                "count": 1,
                "memory_peak_bytes": int(peak_bytes),
            },
        }
        if run.device_summary is not None:
            ds = run.device_summary
            result["device"]["busy_s"] = ds["busy_s"]
            result["device"]["window_s"] = ds["window_s"]
            result["breakdown"] = {"device_ops": ds["device_ops"],
                                   "idle_gaps": ds["idle_gaps"]}
        result["checks"] = checks
        log(f"{workload} seed {seed}: {pairs} pairs in {wall} s, set-up "
            f"{setup_s} s, check on {got['sampled_records']} sampled of "
            f"{got['records']} records ({got['em_repeat_records']} in "
            f"exact repeat copies) in {t_check} s; written "
            f"{written_bytes()} bytes")
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, root=None, device: str = "cuda", runs=None) -> int:
    """The command line.  ``root`` and ``device`` are for the tests, which
    drive a run past the look for a card with ``device='cpu'``; ``runs``
    is ``run_cell``'s."""
    ap = argparse.ArgumentParser(prog="ema_bench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("em_off",), default=None)
    a = ap.parse_args(argv)
    root = root or os.path.dirname(HERE)
    if device == "cuda":
        import torch
        want = int(Bench(root).cell(a.workload)["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < want:
            log(f"{a.workload} needs {want} CUDA card(s); "
                f"{torch.cuda.device_count()} visible")
            return 3
    result = run_cell(root, a.workload, a.seed, a.seconds, bool(a.trace),
                      device=device, control=a.control, runs=runs)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
