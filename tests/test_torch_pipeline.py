"""The port's align path (ema_tpu_torch) against the JAX package, on CPU.

Indexes and configs are built with the JAX package and handed to the port
as plain arrays and fields (tests/torch_handover.py).

On the CPU the port scores with the plain PyTorch SW and runs EM on the
host by default; with ``device_em=True`` it runs the torch EM, and with
``seed_impl="device"`` the torch FM ops, on the CPU.  Its SAM must be
byte-identical to the JAX package's under each.  The same paths run on
the card in chip_smoke.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN, golden_sam
from ema_tpu import config
from ema_tpu.core import pipeline as jax_pipeline
from ema_tpu.index import build_index
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.core.pipeline import (orient_device, resolve_device_em,
                                         resolve_seed_impl)
from ema_tpu_torch.index.device import to_device_state
from simulate import rand_genome, simulate_pairs, to_str
from torch_handover import Aligner, port_index
from torch_handover import jax_native_built  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_orientation_matches_jax_and_host():
    rng = np.random.default_rng(2)
    R, L = 40, 60
    lens = rng.integers(0, L + 1, R).astype(np.int32)
    codes = np.full((R, L), 4, np.uint8)
    for r in range(R):                    # mixed read lengths, N bases
        codes[r, :lens[r]] = rng.integers(0, 5, lens[r])
    got, got_lens = orient_device(torch.from_numpy(codes),
                                  torch.from_numpy(lens))
    want, want_lens = jax_pipeline._orient_device(jnp.asarray(codes),
                                                  jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    # the host orientation of ema_tpu/core/pipeline.py:403-413
    pos = lens[:, None] - 1 - np.arange(L)[None, :]
    src = np.take_along_axis(codes, np.maximum(pos, 0), axis=1)
    rc = np.where(pos >= 0, np.where(src < 4, 3 - np.minimum(src, 3), 4),
                  4).astype(np.uint8)
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([codes, rc], axis=0))


def test_device_state_preserves_text():
    rng = np.random.default_rng(3)
    idx = port_index(build_index({"a": rand_genome(rng, 5000),
                                  "b": rand_genome(rng, 700)}))
    state = to_device_state(idx, torch.device("cpu"))
    assert state.text.dtype == torch.uint8 and state.fm is None
    np.testing.assert_array_equal(state.text.numpy(), idx.text)
    fma = to_device_state(idx, torch.device("cpu"), fm=True).fm
    for name in ("occ_blocks", "counts", "sa_mark_rank", "sa_values"):
        np.testing.assert_array_equal(getattr(fma, name).numpy(),
                                      getattr(idx, name))
    np.testing.assert_array_equal(
        fma.sa_mark_words.numpy().view(np.uint32), idx.sa_mark_words)
    assert (fma.primary, fma.sa_rate, fma.n) == (idx.primary, idx.sa_rate,
                                                 idx.fm_n)


def test_golden_sam_cpu():
    with open(GOLDEN) as f:
        want = f.read()
    assert golden_sam(torch.device("cpu")) == want


@pytest.mark.parametrize("sw_impl", ["banded16", "tier64", "scan",
                                     "native"])
def test_golden_sam_cpu_every_scorer(sw_impl):
    """Whichever SW scorer the Aligner is given, the golden world gives
    tests/golden/expected.sam byte for byte."""
    from ema_tpu_torch.ops.sw import CALLS, reset_counts

    with open(GOLDEN) as f:
        want = f.read()
    reset_counts()
    assert golden_sam(torch.device("cpu"), sw_impl) == want
    used = {s for s, c in CALLS.items() if c.value}
    # tier64: chained corridors go packed, rescue windows (~680) banded
    assert used == {"banded16": {"banded16"}, "tier64": {"packed", "banded"},
                    "scan": {"scan"}, "native": set()}[sw_impl]


def test_scan_scorer_takes_wide_scores_as_jax(monkeypatch):
    """The scan scorer under a scoring past a signed byte (match 200,
    mismatch 150: sw_batch's mask form on a card, its plain version here)
    gives the JAX scan scorer's SAM on the golden world."""
    from chip_smoke import golden_world

    contigs, _, pairs = golden_world()
    idx = build_index(contigs)
    cfg = config.RunConfig(batch_size=512, seed=7,
                           aligner=config.AlignerParams(match=200,
                                                        mismatch=150))
    monkeypatch.setenv("EMA_TPU_SW_IMPL", "scan")
    want = jax_pipeline.Aligner(idx, cfg).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs))
    got = Aligner(idx, cfg, device="cpu", sw_impl="scan").align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert len(got) == len(want) > 100
    assert got == want


@pytest.fixture(scope="module")
def repeat_world():
    """The repeat world of tests/test_pipeline.py:129 (2 Mbp, three
    repeat families, 80 barcodes): (index, pairs)."""
    rng = np.random.default_rng(41)
    G = 2_000_000
    genome = rand_genome(rng, G)
    unit_len = G // 2500
    for fam in range(3):
        src = int(rng.integers(0, G - unit_len))
        unit = genome[src:src + unit_len].copy()
        for c in range(8):
            at = int(rng.integers(0, G - unit_len))
            genome[at:at + unit_len] = unit
    idx = build_index({"chr1": genome})
    pairs = simulate_pairs(
        rng, to_str(genome), n_barcodes=80, frags_per_bc=(2, 3),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100,
        err=0.003)
    ids, _, bcs, s1, q1, s2, q2, _ = pairs
    return idx, (ids, bcs, s1, q1, s2, q2)


def _jax_sam(idx, pairs, cfg=None, seed_impl="native", monkeypatch=None):
    """The JAX package's SAM lines; greedy seeding runs its device
    program (on the CPU) with seed_impl="device"."""
    if monkeypatch is not None:
        monkeypatch.setenv("EMA_TPU_SEED_IMPL", seed_impl)
    al = jax_pipeline.Aligner(idx, cfg)
    assert al._host_fm == (seed_impl == "native")
    return al.align_batch_to_sam(jax_pipeline.ReadBatch.from_pairs(*pairs))


@pytest.fixture(scope="module")
def jax_repeat_sam(repeat_world):
    return jax_pipeline.Aligner(repeat_world[0]).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*repeat_world[1]))


@pytest.fixture(scope="module")
def jax_repeat_sam_device_locate(repeat_world):
    """The JAX package's SAM with its device locate (on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        return _jax_sam(*repeat_world, None, "device", mp)


def test_sam_equals_jax_on_repeat_world(repeat_world, jax_repeat_sam):
    """Both packages must emit the same SAM lines on the repeat world
    (the JAX package with its native SW and jitted EM, the port with the
    plain PyTorch SW and host EM)."""
    idx, pairs = repeat_world
    got = Aligner(idx, device="cpu").align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert len(got) >= 2 * len(pairs[0])
    assert got == jax_repeat_sam


@pytest.fixture
def counted(monkeypatch):
    """Counts of the port's device EM and device FM calls."""
    from ema_tpu_torch.core import pipeline as tp
    from ema_tpu_torch.index import fm

    n = {"em": 0, "locate": 0, "seed+locate": 0}

    def wrap(mod, name, key):
        f = getattr(mod, name)

        def counting(*a, **kw):
            n[key] += 1
            return f(*a, **kw)
        monkeypatch.setattr(mod, name, counting)
    wrap(tp, "dispatch_em_batch", "em")
    wrap(tp, "locate_rows", "locate")
    wrap(fm, "seed_locate_reads", "seed+locate")
    return n


# (Aligner keywords, RunConfig keywords, the device calls they make)
DEVICE_PATHS = {
    "device_em": ({}, dict(device_em=True), ("em",)),
    "seed_device": (dict(seed_impl="device"), {}, ("locate",)),
    "all_device": (dict(seed_impl="device"), dict(device_em=True),
                   ("em", "locate")),
}


@pytest.mark.parametrize("path", list(DEVICE_PATHS))
def test_golden_sam_cpu_device_paths(path, counted):
    """Device EM and device locate (smem seeding) on the CPU give
    tests/golden/expected.sam byte for byte."""
    al_kw, cfg_kw, calls = DEVICE_PATHS[path]
    with open(GOLDEN) as f:
        want = f.read()
    assert golden_sam(torch.device("cpu"), **al_kw, **cfg_kw) == want
    assert all(counted[c] > 0 for c in calls), counted


@pytest.mark.parametrize("path", list(DEVICE_PATHS))
def test_repeat_world_device_paths_equal_jax(path, repeat_world,
                                             jax_repeat_sam,
                                             jax_repeat_sam_device_locate,
                                             counted):
    """The port's device EM and device locate give the JAX package's SAM
    (its jitted EM, and its device locate where the port locates on the
    device)."""
    al_kw, cfg_kw, calls = DEVICE_PATHS[path]
    idx, pairs = repeat_world
    got = Aligner(idx, config.RunConfig(**cfg_kw), device="cpu",
                  **al_kw).align_batch_to_sam(ReadBatch.from_pairs(*pairs))
    assert got == (jax_repeat_sam_device_locate if "locate" in calls
                   else jax_repeat_sam)
    assert all(counted[c] > 0 for c in calls), counted


@pytest.mark.parametrize("seed_impl", ["native", "device"])
def test_greedy_seeding_equals_jax(seed_impl, repeat_world, monkeypatch,
                                   counted):
    """Greedy seeding on the host (native) and on the device (the fused
    seed+locate call) gives the JAX package's greedy SAM, whose seeding
    runs its device program, on the golden and the repeat worlds."""
    from chip_smoke import golden_world
    from ema_tpu.core.samout import write_sam_header

    greedy = config.AlignerParams(seeding="greedy")
    contigs, _, gpairs = golden_world()
    gidx = build_index(contigs)
    cfg = config.RunConfig(batch_size=512, seed=7, aligner=greedy)
    header = write_sam_header(gidx.names, gidx.lengths, cfg.read_group,
                              "golden", "golden")
    want = _jax_sam(gidx, gpairs, cfg, "device", monkeypatch)
    got = golden_sam(torch.device("cpu"), seeding="greedy",
                     seed_impl=seed_impl)
    assert got == header + "".join(want)
    idx, pairs = repeat_world
    cfg = config.RunConfig(aligner=greedy)
    want = _jax_sam(idx, pairs, cfg, "device", monkeypatch)
    got = Aligner(idx, cfg, device="cpu", seed_impl=seed_impl,
                  ).align_batch_to_sam(ReadBatch.from_pairs(*pairs))
    assert len(got) >= 2 * len(pairs[0]) and got == want
    assert (counted["seed+locate"] > 0) == (seed_impl == "device")


def test_long_reads_equal_jax():
    """Two pairs of 600 bp reads, one mate found only by mate rescue
    through a 1183-lane corridor (chip_smoke.long_read_world): the
    port's SAM equals the JAX package's."""
    from chip_smoke import long_read_world

    genome, pairs = long_read_world()
    idx = build_index({"c": genome})
    want = jax_pipeline.Aligner(idx).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs))
    got = Aligner(idx, device="cpu").align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert len(got) == 4 and all(ln.split("\t")[5] != "*" for ln in got)
    assert got == want


def test_scalar_emission_path_equals_jax():
    """bx_index != "1" takes the per-group scalar emitter (_emit_group);
    on the golden world it must match the JAX package's."""
    from chip_smoke import golden_world

    contigs, _, pairs = golden_world()
    idx = build_index(contigs)
    cfg = config.RunConfig(batch_size=512, seed=7, bx_index="2")
    want = jax_pipeline.Aligner(idx, cfg).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs))
    got = Aligner(idx, cfg, device="cpu").align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert any("BX:Z:" in ln and "-2" in ln for ln in got)
    assert got == want


def test_aligner_refuses_what_is_not_ported():
    """What the port still refuses: an unknown seed_impl or seeding, and
    a CUDA device without a card."""
    idx = build_index({"a": rand_genome(np.random.default_rng(4), 2000)})
    with pytest.raises(ValueError, match="seed_impl"):
        Aligner(idx, device="cpu", seed_impl="tpu")
    bad = config.RunConfig(aligner=config.AlignerParams(seeding="mem"))
    with pytest.raises(ValueError, match="seeding"):
        Aligner(idx, bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Aligner(idx, device="cuda")


@pytest.mark.parametrize("env,arg,want", [
    (None, None, "native"), ("device", None, "device"),
    ("native", None, "native"), ("tpu", None, "native"),
    ("device", "native", "native"), (None, "device", "device")])
def test_resolve_seed_impl(env, arg, want, monkeypatch):
    """Native unless EMA_TPU_SEED_IMPL or the argument asks for the
    device; the argument overrides the environment."""
    if env is None:
        monkeypatch.delenv("EMA_TPU_SEED_IMPL", raising=False)
    else:
        monkeypatch.setenv("EMA_TPU_SEED_IMPL", env)
    assert resolve_seed_impl(arg) == want


@pytest.mark.parametrize("device_em,dev,want", [
    (None, "cuda", True), (None, "cpu", False),
    (True, "cpu", True), (False, "cuda", False)])
def test_resolve_device_em(device_em, dev, want):
    """None is device EM on a card and host EM on the CPU."""
    assert resolve_device_em(device_em, torch.device(dev)) is want


_NO_JAX_SCRIPT = r"""
import os, sys
import numpy as np
import chip_smoke
chip_smoke.refuse_reference_imports()     # jax, jaxlib and ema_tpu
try:
    import ema_tpu.config
except ImportError:
    pass
else:
    raise AssertionError("the finder let ema_tpu through")
from ema_tpu_torch import config
from ema_tpu_torch.index.build import build_index
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.core.pipeline import Aligner
from chip_smoke import simulate

sim = simulate()
tmp = sys.argv[1]
rng = np.random.default_rng(8)
genome = sim.rand_genome(rng, 40_000)
gs = sim.to_str(genome)
ids, bc_strs, bcs, s1, q1, s2, q2, _ = sim.simulate_pairs(
    rng, gs, n_barcodes=2, pairs_per_frag=(3, 6), frag_len=10_000)
idx = build_index({"c": genome})
lines = Aligner(idx, device="cpu").align_batch_to_sam(
    ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2))
assert lines, "no SAM lines"
os.environ["EMA_TPU_SW_IMPL"] = "scan"
scan = Aligner(idx, device="cpu")
assert scan.sw_impl == "scan"
assert scan.align_batch_to_sam(
    ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)) == lines
del os.environ["EMA_TPU_SW_IMPL"]
dev = Aligner(idx, config.RunConfig(device_em=True), device="cpu",
              seed_impl="device")
assert dev.cfg.device_em and dev.fma is not None
assert dev.align_batch_to_sam(
    ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)) == lines
greedy = Aligner(idx, config.RunConfig(
    aligner=config.AlignerParams(seeding="greedy")), device="cpu",
    seed_impl="device").align_batch_to_sam(
    ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2))
assert greedy, "no greedy SAM lines"
ref = os.path.join(tmp, "ref.fa")
with open(ref, "w") as f:
    f.write(">c\n" + gs + "\n")
bucket = os.path.join(tmp, "bucket.txt")
with open(bucket, "w") as f:
    for row in zip(bc_strs, ids, s1, q1, s2, q2):
        f.write(" ".join(row) + "\n")
from ema_tpu_torch.cli import main
out = os.path.join(tmp, "out.sam")
assert main(["align", "-r", ref, "-s", bucket, "-o", out,
             "--device", "cpu"]) == 0
with open(out) as f:
    recs = [ln for ln in f if not ln.startswith("@")]
assert sorted(recs) == sorted(lines), "CLI and library SAM differ"
os.environ["EMA_TPU_SEED_IMPL"] = "device"
assert main(["align", "-r", ref, "-s", bucket, "-o", out, "--device", "cpu",
             "--device-em", "--seeding", "greedy"]) == 0
with open(out) as f:
    recs = [ln for ln in f if not ln.startswith("@")]
assert sorted(recs) == sorted(greedy), "CLI and library greedy SAM differ"
del os.environ["EMA_TPU_SEED_IMPL"]
# count -> preproc -> align -x --sort --manifest, as a user runs them
wl = os.path.join(tmp, "wl.txt")
with open(wl, "w") as f:
    f.write("".join(b + "\n" for b in sorted(set(bc_strs))))
fq = os.path.join(tmp, "inter.fq")
with open(fq, "w") as f:
    for row in zip(ids, bc_strs, s1, q1, s2, q2):
        r1 = row[1] + "ACGTACG" + row[2]
        f.write(f"@{row[0]}\n{r1}\n+\n{'I' * 23}{row[3]}\n"
                f"@{row[0]}\n{row[4]}\n+\n{row[5]}\n")
class Stdin:
    buffer = None
sys.stdin = Stdin
for mode, extra in (("count", []), ("preproc", ["-n", "3", "-t", "2"])):
    with open(fq, "rb") as fh:
        Stdin.buffer = fh
        dest = "cnt" if mode == "count" else "bkt"
        inputs = [] if mode == "count" else [os.path.join(tmp, "cnt.ema-ncnt")]
        assert main([mode, "-w", wl, "-o", os.path.join(tmp, dest), *extra,
                     *inputs]) == 0
buckets = sorted(os.path.join(tmp, "bkt", b)
                 for b in os.listdir(os.path.join(tmp, "bkt"))
                 if b.startswith("ema-bin-"))
xout = os.path.join(tmp, "x.sam")
for _ in range(2):     # the second run resumes from the manifest
    assert main(["align", "--device", "cpu", "-r", ref, "-x", "--sort",
                 "--manifest", os.path.join(tmp, "run.jsonl"), "-o", xout,
                 *buckets]) == 0
with open(xout) as f:
    assert len([ln for ln in f if not ln.startswith("@")]) == len(lines)
# preproc and align -x as two processes of one gloo group, each behind
# the finder: the hosts' buckets concatenate to the one-process buckets,
# and the two -x shards hold the one-process records
import socket, subprocess
def two_processes(args_of, stdin_of=lambda i: None):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-c", chip_smoke.GUARDED_CLI, args_of(i)[0],
         "--coordinator", coord, "--nprocs", "2", "--procid", str(i),
         *args_of(i)[1:]], stdin=stdin_of(i), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for i in range(2)]
    for p in procs:
        err = p.communicate(timeout=300)[1]
        assert p.returncode == 0, err.decode()[-3000:]
with open(fq) as f:
    fq_lines = f.readlines()
half = (len(fq_lines) // 16) * 8
for i, part in enumerate((fq_lines[:half], fq_lines[half:])):
    with open(os.path.join(tmp, "half%d.fq" % i), "w") as f:
        f.writelines(part)
    with open(os.path.join(tmp, "half%d.fq" % i), "rb") as fh:
        Stdin.buffer = fh
        assert main(["count", "-w", wl, "-o",
                     os.path.join(tmp, "hcnt%d" % i)]) == 0
halves = [open(os.path.join(tmp, "half%d.fq" % i), "rb") for i in range(2)]
two_processes(lambda i: ["preproc", "-w", wl, "-o",
                         os.path.join(tmp, "mbkt"), "-n", "3",
                         os.path.join(tmp, "hcnt%d.ema-ncnt" % i)],
              lambda i: halves[i])
for b in buckets:
    name = os.path.basename(b)
    merged = b"".join(open(os.path.join(tmp, "mbkt", "host%02d" % i, name),
                           "rb").read() for i in range(2))
    assert merged == open(b, "rb").read(), name
two_processes(lambda i: ["align", "--device", "cpu", "-r", ref, "-x", "-o",
                         os.path.join(tmp, "m.sam"), *buckets])
mrecs = []
for i in range(2):
    with open(os.path.join(tmp, "m.shard%02dof02.sam" % i)) as f:
        mrecs += [ln for ln in f if not ln.startswith("@")]
assert len(mrecs) == len(lines)
# a contig-sharded index aligns through the ShardedAligner
ref2 = os.path.join(tmp, "two.fa")
with open(ref2, "w") as f:
    f.write(">a\n" + gs[:20_000] + "\n>b\n" + gs[20_000:] + "\n")
assert main(["index", "-r", ref2, "--shard-bases", "25000", "-j", "1"]) == 0
assert os.path.isdir(ref2 + ".emaidx.d")
assert main(["align", "-r", ref2, "-s", bucket, "-o", out, "--device",
             "cpu"]) == 0
with open(out) as f:
    assert sum(1 for ln in f if not ln.startswith("@")) == len(lines)
from ema_tpu_torch.tools import bench_sw
os.environ["EMA_TPU_BENCH_SW_B"] = "16"
assert bench_sw.main(["cpu", "--json", os.path.join(tmp, "bsw.json")]) == 0
assert main(["samdiff", out, out, "--fail-under", "100"]) == 0
# a tool twin of each part: the bench, a host profiler, a config
# tool (its CLI subprocesses are the port's) and an accuracy tool
from ema_tpu_torch.tools import (bench, bench_configs, hostbound,
                                 measure_accuracy)
small = ["--device", "cpu", "--genome", "200000", "--pairs", "600"]
assert bench.main(small) == 0
assert hostbound.main([*small, "--reps", "1"]) == 0
assert bench_configs.main(["config4", *small, "--buckets", "8"]) == 0
assert measure_accuracy.main(small) == 0
loaded = chip_smoke.reference_modules_loaded()
assert not loaded, f"modules of jax or ema_tpu were imported: {loaded}"
print("NO_JAX_OK", len(recs))
"""


def test_align_and_cli_never_import_jax(tmp_path):
    """Every mode of the port (count, preproc, index, align -s / -x
    --sort --manifest, samdiff, a sharded index, both EM and both seed
    placements, bench_sw cpu, preproc and align -x with --coordinator
    as two processes of one gloo group, and the tool twins bench,
    hostbound, bench_configs config4 and measure_accuracy) in
    subprocesses whose import finder refuses jax, jaxlib and ema_tpu:
    none of their modules is loaded at the end."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT,
                        str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
