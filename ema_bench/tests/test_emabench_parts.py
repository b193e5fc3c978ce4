"""The benchmark's parts on the CPU: the generator, the cache key, the
reductions of traces and launches, the plain reference, the module
check and the shape of the result line."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ema_bench import buckets, cache, generate, samcheck, trace, yardstick
from ema_bench.run import Bench, forbidden_modules

from conftest import REPO

SCORING = {"match": 1, "mismatch": 4, "gap_open": 6, "gap_extend": 1,
           "clip": 5}


def _world(seed):
    cfg = json.load(open(os.path.join(REPO, "ema_bench", "configs",
                                      "tenx-chr20-stream.json")))
    traffic = json.load(open(os.path.join(REPO, "ema_bench", "traffic",
                                          "linked-wgs.json")))
    g = dict(cfg["genome"], length=300_000, repeat_families=2,
             repeat_copies=3, repeat_unit_bp=[2000, 3000])
    traffic = dict(traffic, molecule_bp=20_000)
    genome, repeats = generate.make_genome(g)
    rng = np.random.default_rng(seed)
    s = cfg["sample"]
    sample = generate.make_sample(rng, genome, s["snv_rate"],
                                  s["indel_rate"], s["indel_len"])
    pool = generate.make_pool(rng, sample, repeats, cfg["reads"], traffic,
                              500)
    return genome, repeats, sample, pool


def test_generator_same_seed_same_world():
    a = _world(2 ** 31 + 12345)
    b = _world(2 ** 31 + 12345)
    c = _world(7)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[3].names == b[3].names and a[3].bcs == b[3].bcs
    for f in ("r1", "r2", "left", "rev", "em_repeat"):
        assert np.array_equal(getattr(a[3], f), getattr(b[3], f))
    assert not np.array_equal(a[3].r1, c[3].r1)
    assert a[3].n == c[3].n == 500
    assert a[3].r1.shape[1] == 128 and a[3].r2.shape[1] == 151


def test_generator_truth_and_order():
    genome, _, sample, pool = _world(11)
    # groups come in the aligner's barcode order, numbered 0, 1, ...
    vals = generate.encode_bc(np.asarray(
        [["ACGT".index(c) for c in b] for b in pool.bcs], np.uint8))
    assert (np.diff(vals.astype(np.float64)) >= 0).all()
    assert pool.group[0] == 0 and (np.diff(pool.group) >= 0).all()
    assert (np.diff(pool.group) <= 1).all()
    # without sequencing errors a forward mate is the reference at its
    # truth wherever no variant lies under it
    k = int(np.flatnonzero(~pool.rev[:, 0])[0])
    r = pool.r1[k]
    ref = genome[pool.left[k, 0]:pool.left[k, 0] + r.shape[0]]
    assert (r == ref).mean() > 0.95
    # the sample maps back to the reference
    s = np.arange(0, sample.codes.shape[0], 997)
    back = sample.to_ref(s)
    assert (np.diff(back) >= 0).all() and back[-1] < genome.shape[0]


def test_cache_key_follows_port_sources(tmp_path):
    port = tmp_path / "port"
    (port / "index").mkdir(parents=True)
    (port / "native").mkdir()
    (port / "preproc").mkdir()
    (port / "index" / "build.py").write_text("a = 1\n")
    (port / "native" / "ema_native.cpp").write_text("int x;\n")
    (port / "preproc" / "count.py").write_text("b = 2\n")
    cfg = {"name": "c", "genome": {"length": 10, "seed": 1}}
    k0 = cache.key(cfg, str(port))
    assert cache.key(cfg, str(port)) == k0
    (port / "native" / "ema_native.cpp").write_text("int y;\n")
    k1 = cache.key(cfg, str(port))
    (port / "preproc" / "count.py").write_text("b = 3\n")
    k2 = cache.key(cfg, str(port))
    (port / "index" / "new.py").write_text("\n")
    k3 = cache.key(cfg, str(port))
    assert len({k0, k1, k2, k3}) == 4
    assert cache.key({"name": "c", "genome": {"length": 10, "seed": 2}},
                     str(port)) != k3


def test_idle_share_on_a_canned_trace():
    ms = 1_000_000
    events = [("sw_banded_kernel<8>", "kernel", 10 * ms, 20 * ms),
              ("em", "kernel", 15 * ms, 30 * ms),       # overlaps
              ("Memcpy HtoD", "gpu_memcpy", 50 * ms, 60 * ms),
              ("late", "kernel", 95 * ms, 120 * ms)]    # cut at the end
    spans = trace.Spans(True)
    spans.add("align_stream", 0, 100 * ms)
    spans.add("iter_fastq_pair_groups", 31 * ms, 49 * ms)
    out = trace.summarize(events, 0, 100 * ms, spans)
    assert out["busy_s"] == pytest.approx(0.035)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["n_events"] == 4
    gaps = {round(v, 6): n for n, v in out["idle_gaps"]}
    assert set(gaps) == {0.035, 0.02, 0.01}
    assert gaps[0.02].startswith("iter_fastq_pair_groups")
    assert gaps[0.01].startswith("align_stream")
    assert out["kernel_s"]["sw_banded"] == pytest.approx(0.01)
    assert out["kernel_s"]["sw_batch"] == 0


def test_sw_roofline_on_canned_launches():
    peak = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]
    sw = trace.SwLaunches()
    olens = torch.tensor([100, 150, 128], dtype=torch.int32)
    owners = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    win_len = torch.tensor([200, 300, 300, 900], dtype=torch.int32)
    wl = torch.tensor([50, 60, 60, 683], dtype=torch.int32)
    out = torch.zeros((4, 4), dtype=torch.int32)
    read = (None, None, olens, owners, None, win_len, wl)
    for _ in range(3):          # three class launches of one call
        sw.observe("sw_banded", None, read, (out,))
    b = sw.bounds(peak)
    cells = 100 * 50 + 150 * 60 * 2 + 128 * 683
    slots = peak["sms"] * peak["max_sm_clock_mhz"] * 1e6 * 128
    int32 = peak["sms"] * peak["max_sm_clock_mhz"] * 1e6 * 64
    want = max(cells * 21 / slots, cells * 16 / int32)
    assert b["sw_banded"] == pytest.approx(want)

    class R:
        device_kind = "NVIDIA H100 80GB HBM3"
        device_summary = {"kernel_s": {"sw_banded": 4 * want}}
    R.sw = sw
    read_metric = Bench(REPO).reader("sw_roofline_pct")
    assert read_metric(R) == pytest.approx(25.0)
    R.device_kind = "some other card"
    assert read_metric(R) is None


def _pool_of(reads_and_truth):
    """A pool of hand-made pairs: [(r1, r2, left1, left2)]."""
    n = len(reads_and_truth)
    lut = {c: i for i, c in enumerate("ACGT")}
    r1 = np.asarray([[lut[c] for c in a] for a, _, _, _ in reads_and_truth],
                    np.uint8)
    r2 = np.asarray([[lut[c] for c in b] for _, b, _, _ in reads_and_truth],
                    np.uint8)
    return generate.Pool(
        names=[f"g0p{k}" for k in range(n)], bcs=["A" * 16] * n,
        group=np.zeros(n, np.int64), r1=r1, r2=r2,
        left=np.asarray([[a, b] for _, _, a, b in reads_and_truth]),
        rev=np.zeros((n, 2), bool), em_repeat=np.zeros((n, 2), bool),
        qual="F")


def _sam(k, flag, pos, cigar, seq, nm):
    return (f"g0p{k}\t{flag}\tchr\t{pos}\t60\t{cigar}\t=\t1\t0\t{seq}\t"
            f"{'F' * len(seq)}\tNM:i:{nm}\tMI:i:5\n")


def test_plain_reference_scores_and_structure():
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 5000, dtype=np.uint8)
    s = lambda a, b: "".join("ACGT"[c] for c in genome[a:b])  # noqa: E731
    r1 = s(1000, 1040)
    # mate 2 carries a 2-base deletion against the genome
    r2 = s(1200, 1220) + s(1222, 1252)
    pool = _pool_of([(r1, r2, 1000, 1200)])
    good = [_sam(0, 0x41, 1001, "40M", r1, 0),
            _sam(0, 0x81, 1201, "20M2D30M", r2, 2)]
    recs = samcheck.Records(pool)
    recs.add_unit(good, np.ones(1, bool), mi_ns=np.zeros(1, np.int64),
                  mi_shift=30)
    got = samcheck.check(recs, genome, SCORING, rng, 10, 5)
    assert got["bad_pairs"] == 0 and got["nm_wrong"] == 0
    assert got["sw_gap_max"] == 0 and got["off_truth_pct"] == 0
    # a worse CIGAR at the right place: clipped where the deletion lies
    worse = [good[0], _sam(0, 0x81, 1201, "20M30S", r2, 0)]
    recs = samcheck.Records(pool)
    recs.add_unit(worse, np.ones(1, bool))
    got = samcheck.check(recs, genome, SCORING, rng, 10, 5)
    assert got["sw_gap_max"] == (50 - 7 - 1) - (20 - 5)
    # a wrong NM, a record moved away, a missing mate
    recs = samcheck.Records(pool)
    recs.add_unit([_sam(0, 0x41, 1001, "40M", r1, 1)], np.ones(1, bool))
    got = samcheck.check(recs, genome, SCORING, rng, 10, 5)
    assert got["nm_wrong"] == 1 and got["bad_pairs"] == 1
    assert got["off_truth_pct"] == 50.0
    recs = samcheck.Records(pool)
    recs.add_unit([_sam(0, 0x41, 1101, "40M", r1, 0), good[1]],
                  np.ones(1, bool), mi_ns=np.ones(1, np.int64), mi_shift=0)
    got = samcheck.check(recs, genome, SCORING, rng, 10, 5)
    assert got["off_truth_pct"] == 50.0 and got["mi_outside"] == 2


def test_best_scores_against_a_loop():
    """The vectorised DP against a cell-by-cell one on random pairs."""
    rng = np.random.default_rng(5)

    def loop(q, w):
        o, e, clip = 6, 1, 5
        m, n = len(q), len(w)
        NEG = -10 ** 9
        H = [[NEG] * (n + 1) for _ in range(m + 1)]
        V = [[NEG] * (n + 1) for _ in range(m + 1)]
        E = [[NEG] * (n + 1) for _ in range(m + 1)]
        best = NEG
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                sub = 1 if q[i - 1] == w[j - 1] else -4
                fresh = 0 if i == 1 else -clip
                d = max(H[i - 1][j - 1], fresh) + sub
                V[i][j] = max(H[i - 1][j] - o - e, V[i - 1][j] - e)
                E[i][j] = max(H[i][j - 1] - o - e, E[i][j - 1] - e)
                H[i][j] = max(d, V[i][j], E[i][j])
                best = max(best, H[i][j] + (0 if i == m else -clip))
        return best

    reads, wins, want = [], [], []
    for _ in range(12):
        w = rng.integers(0, 4, int(rng.integers(20, 40)), dtype=np.uint8)
        a = int(rng.integers(0, 8))
        q = w[a:a + int(rng.integers(8, 16))].copy()
        q[rng.integers(0, q.shape[0], 2)] = rng.integers(0, 4, 2)
        if rng.random() < 0.5:
            q = np.concatenate([q[:4], q[6:]])
        reads.append(q)
        wins.append(w)
        want.append(loop(q.tolist(), w.tolist()))
    got = samcheck.best_scores(reads, wins, SCORING)
    assert got.tolist() == want


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import types
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ema_tpu_torch_like",
                        types.ModuleType("ema_tpu_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxlibx", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ema_tpu.core",
                        types.ModuleType("ema_tpu.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["ema_tpu", "jax"]


def test_harness_sources_import_no_reference():
    """No file of the benchmark imports jax, flax or ema_tpu, and the
    plain reference imports nothing of the program."""
    import ast
    root = os.path.join(REPO, "ema_bench")
    for d, _, fs in os.walk(root):
        for f in fs:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib", "flax", "ema_tpu"), \
                        (f, n)
                    if f in ("samcheck.py", "generate.py", "yardstick.py",
                             "buckets.py"):
                        assert top != "ema_tpu_torch", (f, n)


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "ema_bench.run",
                        "--workload", "stream-wgs", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_json_names_its_files():
    b = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert b["paths"] == ["ema_bench"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert json.load(open(os.path.join(REPO, c["file"])))["name"] == \
            c["name"]
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(
            REPO, "ema_bench", "traffic", w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(REPO, "ema_bench", "metrics",
                                           m["name"] + ".py"))


def test_group_completion_in_any_order():
    """A group is complete when its last due line comes back, whether the
    port emits whole groups in order (the fast path) or not; the sampled
    groups' lines are kept."""
    from ema_bench.drivers import take_lines
    need = np.asarray([2, 4, 2, 2])
    sampled = np.asarray([False, True, True, False])
    got = np.zeros(4, np.int64)
    kept = []
    line = lambda g, k: f"g{g}p{k}\t0\n"  # noqa: E731
    whole = [line(0, 0), line(0, 0), line(1, 1), line(1, 1), line(1, 2),
             line(1, 2)]
    assert list(take_lines(whole, got, need, sampled, kept)) == [0, 1]
    assert kept == whole[2:]
    # group 3 before group 2, and group 2 split over two lists
    assert take_lines([line(3, 9), line(3, 9), line(2, 7)], got, need,
                      sampled, kept) == [3]
    assert take_lines([line(2, 7)], got, need, sampled, kept) == [2]
    assert (got == need).all()
    assert kept == whole[2:] + [line(2, 7)] * 2


def test_device_events_with_and_without_activity_types():
    """Kineto events of torch builds with ``activity_type`` and without
    it (names tell copies and memsets) give the same list."""
    class Ev:
        def __init__(self, name, dev, cat, s, d, typed):
            self._v = (name, dev, cat, s, d)
            if typed:
                self.activity_type = lambda: cat

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return self._v[3]

        def duration_ns(self):
            return self._v[4]

    rows = [("sw_banded_kernel", "DeviceType.CUDA", "kernel", 10, 5),
            ("Memcpy HtoD (Pinned -> Device)", "DeviceType.CUDA",
             "gpu_memcpy", 20, 3),
            ("Memset (Device)", "DeviceType.CUDA", "gpu_memset", 30, 1),
            ("cudaLaunchKernel", "DeviceType.CPU", "cuda_runtime", 9, 2)]
    for typed in (True, False):
        class Prof:
            class profiler:
                class kineto_results:
                    @staticmethod
                    def events():
                        return [Ev(*r, typed) for r in rows]
        assert trace.device_events(Prof) == [
            ("sw_banded_kernel", "kernel", 10, 15),
            ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 20, 23),
            ("Memset (Device)", "gpu_memset", 30, 31)]


@pytest.mark.parametrize("n", [1, 14, 30, 542, 5088, 20754])
def test_bucket_rule_iterates_as_a_real_unordered_map(n):
    """The check's map order against the program's replay of a real
    std::unordered_map, over each step of the rehash schedule."""
    from ema_tpu_torch import native
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(1, 2 ** 32, 2 * n, dtype=np.uint64)
                     .astype(np.uint32))[:n]
    keys = keys[rng.permutation(n)]
    assert buckets.map_order(keys.tolist()) == \
        native.umap_order_u32(keys, sim=False).tolist()

