"""The port's CLI (ema_tpu_torch.cli) against ema_tpu.cli, on the CPU.

On the worlds of tests/test_distrib.py:73-291 and tests/test_platforms.py
the port's -x runs (coalesced, --no-coalesce -j 1/2/3 over skewed
buckets, manifest resume, a lost part, --sort shards merged), --nobc,
-i, -1/-2 --sort and the count -> preproc -> align -x chains must give
the JAX package's SAM bodies byte for byte (the @PG line names the
port, so headers differ).  Also: the multi-host flags are refused,
--profile writes a trace, the MI namespace width fits int32, and the
port's jax-free distrib functions equal JAX's.
"""

import io
import json
import os
import re

import numpy as np
import pytest
import torch

from ema_tpu import cli as jax_cli
from ema_tpu.parallel import distrib as jax_distrib
from ema_tpu_torch import cli
from ema_tpu_torch.parallel import distrib
from simulate import rand_genome, simulate_pairs, to_str
from torch_handover import jax_native_built  # noqa: F401 (autouse)


def body(path):
    return [ln for ln in open(path) if not ln.startswith("@")]


def _mask_mi(lines):
    return sorted(re.sub(r"\tMI:i:\d+", "\tMI:i:*", ln) for ln in lines)


def _port(args):
    return cli.main([args[0], "--device", "cpu", *args[1:]])


def _world(tmp, seed, glen, n_barcodes, pairs_per_frag, frag_len,
           read_len, frags_per_bc=(1, 2)):
    """A one-contig FASTA and simulated pairs: (fasta, ids, bc_strs,
    s1, q1, s2, q2, truth)."""
    rng = np.random.default_rng(seed)
    gs = to_str(rand_genome(rng, glen))
    fa = tmp / "ref.fa"
    fa.write_text(">c1\n" + "\n".join(
        gs[i:i + 70] for i in range(0, len(gs), 70)) + "\n")
    sim = simulate_pairs(rng, gs, n_barcodes=n_barcodes,
                         frags_per_bc=frags_per_bc,
                         pairs_per_frag=pairs_per_frag, frag_len=frag_len,
                         read_len=read_len, err=0.003)
    return (str(fa), *sim)


def _buckets(tmp, w, route, n_buckets):
    """Bucket files in the special EMA-FASTQ format; pair i goes to
    bucket route(bc_str) (a file may stay empty)."""
    _, ids, bc_strs, _, s1, q1, s2, q2, _ = w
    paths = []
    for b in range(n_buckets):
        p = tmp / f"ema-bin-{b:03d}"
        with open(p, "w") as f:
            for i in range(len(ids)):
                if route(bc_strs[i]) == b:
                    f.write(f"{bc_strs[i]} {ids[i]} {s1[i]} {q1[i]} "
                            f"{s2[i]} {q2[i]}\n")
        paths.append(str(p))
    return paths


def _by_rank(w, n):
    """Deterministic routing: the barcode's rank modulo n."""
    rank = {b: i for i, b in enumerate(sorted(set(w[2])))}
    return lambda b: rank[b] % n


@pytest.fixture(scope="module")
def x_world(tmp_path_factory):
    """tests/test_distrib.py:181-216: 80 kbp, 8 barcodes, 4 buckets."""
    tmp = tmp_path_factory.mktemp("xw")
    w = _world(tmp, 15, 80_000, 8, (4, 8), 10_000, 80)
    return tmp, w[0], _buckets(tmp, w, _by_rank(w, 4), 4)


X_MODES = {"coalesced": [], "j1": ["--no-coalesce", "-j", "1"],
           "j2": ["--no-coalesce", "-j", "2"],
           "j3": ["--no-coalesce", "-j", "3"]}


@pytest.mark.parametrize("mode", list(X_MODES))
def test_x_modes_equal_jax(mode, x_world):
    tmp, fa, buckets = x_world
    outs = {}
    for name, run in (("jax", jax_cli.main), ("port", _port)):
        out = str(tmp / f"{name}_{mode}.sam")
        assert run(["align", "-r", fa, "-x", "-o", out, *X_MODES[mode],
                    *buckets]) == 0
        outs[name] = body(out)
    assert len(outs["port"]) > 0 and outs["port"] == outs["jax"]
    # per-bucket MI namespaces: every cloud id belongs to one barcode
    seen = {}
    for ln in outs["port"]:
        tags = dict(t.split(":", 2)[::2] for t in
                    ln.rstrip("\n").split("\t")[11:])
        if "MI" in tags:
            assert seen.setdefault(tags["MI"], tags["BX"]) == tags["BX"]


@pytest.mark.parametrize("seed,n_jobs", [(21, 3), (22, 4), (23, 2)])
def test_x_skewed_buckets_equal_jax(tmp_path, seed, n_jobs):
    """tests/test_distrib.py:241-291: skewed bucket sizes (most barcodes
    in bucket 0, singletons, an empty file); the port's -j N and
    coalesced runs give the JAX serial run's body."""
    w = _world(tmp_path, seed, 60_000, 10, (3, 6), 9_000, 80)
    rng = np.random.default_rng(seed)
    n_buckets = int(rng.integers(3, 7))
    route = {b: 0 if rng.random() < 0.6 else int(rng.integers(1, n_buckets))
             for b in sorted(set(w[2]))}
    buckets = _buckets(tmp_path, w, route.get, n_buckets + 1)
    serial = str(tmp_path / "serial.sam")
    assert jax_cli.main(["align", "-r", w[0], "-x", "--no-coalesce", "-j",
                         "1", "-o", serial, *buckets]) == 0
    for flags in (["--no-coalesce", "-j", str(n_jobs)], []):
        out = str(tmp_path / "port.sam")
        assert _port(["align", "-r", w[0], "-x", "-o", out, *flags,
                      *buckets]) == 0
        assert body(out) == body(serial) and body(out)


def test_manifest_resume_and_lost_part_equal_jax(tmp_path):
    """tests/test_distrib.py:73-120: a rerun with the manifest leaves the
    parts untouched, a lost part realigns that bucket alone, and the
    output is the JAX package's throughout."""
    import time

    w = _world(tmp_path, 9, 50_000, 4, (3, 6), 8_000, 70)
    buckets = _buckets(tmp_path, w, _by_rank(w, 2), 2)
    jax_out = str(tmp_path / "jax.sam")
    assert jax_cli.main(["align", "-r", w[0], "-x", "-o", jax_out,
                         "--manifest", str(tmp_path / "jax.jsonl"),
                         *buckets]) == 0
    out, man = str(tmp_path / "out.sam"), str(tmp_path / "run.jsonl")
    args = ["align", "-r", w[0], "-x", "-o", out, "--manifest", man,
            *buckets]
    assert _port(args) == 0
    first = open(out).read()
    assert body(out) == body(jax_out)
    parts_dir = out + ".parts"
    mtimes = {p: os.path.getmtime(os.path.join(parts_dir, p))
              for p in os.listdir(parts_dir)}
    assert len(mtimes) == 2
    time.sleep(0.05)
    assert _port(args) == 0
    for p, t in mtimes.items():
        assert os.path.getmtime(os.path.join(parts_dir, p)) == t
    assert open(out).read() == first
    part0 = os.path.join(parts_dir, "ema-bin-000.sam")
    os.unlink(part0)
    assert _port(args) == 0
    assert os.path.exists(part0) and open(out).read() == first
    assert os.path.getmtime(os.path.join(parts_dir, "ema-bin-001.sam")) \
        == mtimes["ema-bin-001.sam"]


def test_sharded_sort_merge_equals_jax(tmp_path):
    """tests/test_distrib.py:123-178: two --shard/--nshards --sort runs
    merged give the JAX package's merged shards byte for byte, and the
    single sorted run with MI masked."""
    w = _world(tmp_path, 5, 60_000, 6, (4, 8), 10_000, 80)
    buckets = _buckets(tmp_path, w, _by_rank(w, 4), 4)
    merged = {}
    for name, run, merge in (("jax", jax_cli.main,
                              jax_distrib.merge_sorted_shards),
                             ("port", _port, distrib.merge_sorted_shards)):
        shards = []
        for s in range(2):
            out = str(tmp_path / f"{name}{s}.sam")
            assert run(["align", "-r", w[0], "-x", "-o", out, "--shard",
                        str(s), "--nshards", "2", "--sort", *buckets]) == 0
            shards.append(out)
        merged[name] = str(tmp_path / f"{name}_merged.sam")
        merge(shards, merged[name], ["c1"])
    assert body(merged["port"]) == body(merged["jax"])
    single = str(tmp_path / "single.sam")
    assert _port(["align", "-r", w[0], "-x", "--sort", "-o", single,
                  *buckets]) == 0
    assert _mask_mi(body(merged["port"])) == _mask_mi(body(single))


@pytest.fixture(scope="module")
def plat_world(tmp_path_factory):
    """tests/test_platforms.py:13-25: 80 kbp, 4 barcodes."""
    tmp = tmp_path_factory.mktemp("plat")
    return tmp, _world(tmp, 11, 80_000, 4, (5, 9), 15_000, 80)


def _pair_fastqs(tmp, name, rids, w):
    _, _, _, _, s1, q1, s2, q2, _ = w
    f1, f2 = tmp / f"{name}_1.fq", tmp / f"{name}_2.fq"
    with open(f1, "w") as a, open(f2, "w") as b:
        for i in range(len(rids)):
            a.write(f"@{rids[i]}\n{s1[i]}\n+\n{q1[i]}\n")
            b.write(f"@{rids[i]}\n{s2[i]}\n+\n{q2[i]}\n")
    return str(f1), str(f2)


# name -> (read ids from (id, bc), align flags past the inputs)
PAIR_RUNS = {
    "nobc": (lambda i, b: i, ["--nobc"]),
    "sort_10x": (lambda i, b: f"{i}:{b}", ["--sort"]),
    "stream_10x_i2": (lambda i, b: f"{i}:{b}", ["-i", "2"]),
}


@pytest.mark.parametrize("run", list(PAIR_RUNS))
def test_pair_inputs_equal_jax(run, plat_world):
    """-1/-2 under --nobc (tests/test_platforms.py:101-123), --sort (the
    whole-file reader) and -i 2 (the scalar emitter): the JAX bodies."""
    tmp, w = plat_world
    rid, flags = PAIR_RUNS[run]
    f1, f2 = _pair_fastqs(tmp, run, [rid(i, b) for i, b in zip(w[1], w[2])],
                          w)
    outs = {}
    for name, fn in (("jax", jax_cli.main), ("port", _port)):
        out = str(tmp / f"{name}_{run}.sam")
        assert fn(["align", "-r", w[0], "-1", f1, "-2", f2, "-o", out,
                   *flags]) == 0
        outs[name] = body(out)
    assert len(outs["port"]) >= 2 * len(w[1])
    assert outs["port"] == outs["jax"]
    if run == "nobc":
        assert not any("\tBX:" in ln or "\tMI:" in ln for ln in outs["port"])
    if run == "stream_10x_i2":
        assert any("-2\t" in ln or ln.endswith("-2\n")
                   for ln in outs["port"])


def test_special_bx_index_equals_jax(plat_world):
    """-s with -i 2 takes the scalar emitter's BX suffix."""
    tmp, w = plat_world
    fa, ids, bc_strs, _, s1, q1, s2, q2, _ = w
    bucket = tmp / "bx2-bin"
    with open(bucket, "w") as f:
        for row in zip(bc_strs, ids, s1, q1, s2, q2):
            f.write(" ".join(row) + "\n")
    outs = {}
    for name, fn in (("jax", jax_cli.main), ("port", _port)):
        out = str(tmp / f"{name}_bx2.sam")
        assert fn(["align", "-r", fa, "-s", str(bucket), "-i", "2", "-o",
                   out]) == 0
        outs[name] = body(out)
    assert any("BX:Z:" in ln and "-2" in ln for ln in outs["port"])
    assert outs["port"] == outs["jax"]


def _interleaved(w, haplotag):
    """count/preproc input: 10x read 1 = barcode + 7 bp + read; haplotag
    reads carry BX:Z: codes in their headers."""
    _, ids, bc_strs, _, s1, q1, s2, q2, _ = w
    rng = np.random.default_rng(8)
    hts = {}
    for b in sorted(set(bc_strs)):
        a, c, bb, d = rng.integers(1, 97, 4)
        hts[b] = f"A{a:02d}C{c:02d}B{bb:02d}D{d:02d}"
    fq = []
    for i in range(len(ids)):
        if haplotag:
            hdr = f"@{ids[i]} BX:Z:{hts[bc_strs[i]]}"
            fq.append(f"{hdr}\n{s1[i]}\n+\n{q1[i]}\n"
                      f"{hdr}\n{s2[i]}\n+\n{q2[i]}\n")
        else:
            r1 = bc_strs[i] + "ACGTACG" + s1[i]
            fq.append(f"@{ids[i]}\n{r1}\n+\n{'I' * 23}{q1[i]}\n"
                      f"@{ids[i]}\n{s2[i]}\n+\n{q2[i]}\n")
    return "".join(fq).encode()


@pytest.mark.parametrize("platform", ["10x", "haplotag"])
def test_count_preproc_align_chain_equals_jax(platform, plat_world,
                                              tmp_path, monkeypatch):
    """count -> preproc -> align -x through each CLI (the haplotag chain
    of tests/test_platforms.py:126-181; the 10x one of README.md:37-56):
    the same count and bucket files, and the same SAM bodies."""
    tmp, w = plat_world
    hap = platform == "haplotag"
    blob = _interleaved(w, hap)
    wl = tmp_path / "wl.txt"
    wl.write_text("".join(b + "\n" for b in sorted(set(w[2]))))
    sel = ["-p"] if hap else ["-w", str(wl)]

    class FakeStdin:
        buffer = io.BytesIO(blob)

    monkeypatch.setattr("sys.stdin", FakeStdin)
    outs = {}
    for name, fn in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / name
        d.mkdir()
        FakeStdin.buffer = io.BytesIO(blob)
        assert fn(["count", *sel, "-o", str(d / "c")]) == 0
        FakeStdin.buffer = io.BytesIO(blob)
        assert fn(["preproc", *sel, "-o", str(d / "bkt"), "-n", "3",
                   *([] if hap else ["-h"]), str(d / "c.ema-ncnt")]) == 0
        buckets = sorted(str(p) for p in (d / "bkt").glob("ema-bin-*"))
        assert len(buckets) == 3
        out = str(d / "out.sam")
        args = ["align", "-r", w[0], "-x", "-p", platform, "-o", out,
                *buckets]
        assert (fn(args) if name == "jax" else _port(args)) == 0
        outs[name] = (
            (d / "c.ema-ncnt").read_bytes(),
            [open(b, "rb").read() for b in buckets], body(out))
    assert outs["port"][:2] == outs["jax"][:2]
    assert outs["port"][2] == outs["jax"][2] and outs["port"][2]
    bx = re.findall(r"\tBX:Z:(\S+)", "".join(outs["port"][2]))
    assert bx and all((b[0] == "A" and "-" not in b) if hap
                      else b.endswith("-1") for b in bx)


@pytest.mark.parametrize("argv", [
    ["align", "-r", "ref.fa", "-x", "--coordinator", "h:1234", "b0"],
    ["align", "-r", "ref.fa", "-s", "b0", "--nprocs", "2"],
    ["align", "-r", "ref.fa", "-s", "b0", "--procid=1"],
    ["preproc", "-w", "wl.txt", "-o", "out", "--coordinator", "h:1234",
     "c.ema-ncnt"]])
def test_multi_host_flags_exit_1(argv, capsys):
    assert cli.main([argv[0], "--device", "cpu", *argv[1:]]
                    if argv[0] == "align" else argv) == 1
    assert "multi-host is not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("device", [["--device", "cuda"], []],
                         ids=["cuda", "default"])
def test_cuda_without_a_card_exits_1(device, x_world, capsys):
    """--device cuda, which is also the default, fails with no card
    before any work; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tmp, fa, buckets = x_world
    out = tmp / "nocard.sam"
    assert cli.main(["align", *device, "-r", fa, "-x", "-o",
                     str(out), *buckets]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not out.exists()


def test_profile_writes_a_trace(x_world, tmp_path):
    tmp, fa, buckets = x_world
    prof = tmp_path / "prof"
    assert _port(["align", "-r", fa, "-s", buckets[0], "-o",
                  str(tmp_path / "p.sam"), "--profile", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_samdiff_delegates(x_world, capsys):
    tmp, fa, buckets = x_world
    out = str(tmp / "sd.sam")
    assert _port(["align", "-r", fa, "-x", "-o", out, *buckets]) == 0
    capsys.readouterr()
    assert cli.main(["samdiff", out, out, "--fail-under", "100"]) == 0
    assert "concordance (pos+flag+cigar): 100.000%" in capsys.readouterr().out


@pytest.mark.parametrize("n", [1, 2, 500, 512, 513, 1000, 4096])
def test_mi_shift_fits_int32(n):
    """The -x MI namespace width (tests/test_distrib.py:294-301)."""
    shift = cli._mi_shift(n)
    assert shift == max(31 - max(n - 1, 1).bit_length(), 10)
    assert (n - 1) << shift <= 2**31 - 1
    if n > 1:
        assert (1 << shift) >= 2**10


def _sam_lines(seed, n=120):
    rng = np.random.default_rng(seed)
    chroms = ["chr1", "chr2", "chrX"]
    return [f"r{i}\t0\t{chroms[int(rng.integers(0, 3))]}\t"
            f"{int(rng.integers(1, 5000))}\t60\t5M\t=\t1\t0\tACGTA\tIIIII\n"
            for i in range(n)], chroms


@pytest.mark.parametrize("fn", ["buckets_for_host", "shard_path",
                                "sort_sam_lines", "merge_sorted_shards",
                                "merge_sorted_streams"])
def test_distrib_equals_jax(fn, tmp_path):
    port, jax_fn = getattr(distrib, fn), getattr(jax_distrib, fn)
    if fn == "buckets_for_host":
        paths = [f"bin-{i:03d}" for i in (5, 1, 16, 0, 9, 3, 12)]
        for h in range(3):
            assert port(paths, h, 3) == jax_fn(paths, h, 3)
        return
    if fn == "shard_path":
        for args in (("/x/out.sam", 3, 8), ("out", 0, 1), ("a.b.sam", 11,
                                                           12)):
            assert port(*args) == jax_fn(*args)
        return
    lines, chroms = _sam_lines(3)
    if fn == "sort_sam_lines":
        assert port(lines, chroms) == jax_fn(lines, chroms)
        return
    shards = []
    for k in range(3):
        p = tmp_path / f"s{k}.sam"
        p.write_text("@HD\tVN:1.3\n" + "".join(
            jax_distrib.sort_sam_lines(lines[k::3], chroms)))
        shards.append(str(p))
    got = {}
    for name, mod in (("port", distrib), ("jax", jax_distrib)):
        if fn == "merge_sorted_shards":
            out = tmp_path / f"{name}.sam"
            assert getattr(mod, fn)(shards, str(out), chroms) == len(lines)
            got[name] = out.read_text()
        else:
            buf = io.StringIO()
            assert getattr(mod, fn)(buf, shards, chroms, "@X\n") == len(
                lines)
            got[name] = buf.getvalue()
    assert got["port"] == got["jax"]


def test_concurrent_buckets_keep_records_and_counts(tmp_path):
    """-x --no-coalesce -j 12 (more threads than this host's cores) with
    a short switch interval: the serial run's body, and the scorer call
    counts (ops/sw.CALLS, shared by every thread) lose no update."""
    import sys

    from ema_tpu_torch.ops.sw import CALLS, reset_counts

    w = _world(tmp_path, 31, 40_000, 12, (2, 3), 6_000, 50,
               frags_per_bc=(1, 2))
    buckets = _buckets(tmp_path, w, _by_rank(w, 12), 12)

    def run(jobs):
        reset_counts()
        out = str(tmp_path / f"j{jobs}.sam")
        assert _port(["align", "-r", w[0], "-x", "--no-coalesce", "-j",
                      str(jobs), "-o", out, *buckets]) == 0
        return body(out), {s: c.value for s, c in CALLS.items()}

    serial, calls = run(1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        conc, conc_calls = run(12)
    finally:
        sys.setswitchinterval(old)
    assert conc == serial and len(serial) >= 2 * len(w[1])
    assert conc_calls == calls and calls["banded"] >= 12
