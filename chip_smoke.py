#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ema_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and builds the CUDA
kernel from the sources in the checkout (nvcc, sm_90a).  Phases, in
order; any failure raises and the run exits non-zero:

  1. setup: torch/CUDA versions, the card, the kernel build time;
  2. kernel vs plain: the sw_banded kernel against its plain PyTorch
     version on the card, bit-exact on all four outputs, at the SW_CHUNK
     chained shape, the mate-rescue shape and edge cases, with both times;
  3. golden: the world of tests/test_golden.py aligned on the card must
     reproduce tests/golden/expected.sam byte for byte;
  4. main path: the bench world of bench.py (BASELINE config 1: 3 Mbp
     genome, ~40.7k pairs of 100 bp reads) aligned on the card, with
     pairs/s, the stage split and accuracy against the simulation truth;
     one real chunk is re-scored with the native host scorer;
  5. CLI: ``python -m ema_tpu_torch.cli align`` on a small input must
     give the library path's SAM records;
  6. checks: synchronise, and no jax was imported.

The line before the last is the card's name and power limit as nvidia-smi
prints them, the one before it the per-kernel JSON record; the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "expected.sam")
KERNEL_SOURCE = "ema_tpu_torch/ops/csrc/sw_banded.cu"
REPLACES = "ema_tpu/ops/sw_pallas.py:260"
SW_KW = dict(match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5)


@functools.cache
def simulate():
    """The repo's read simulator, tests/simulate.py, loaded by path (a
    ``tests`` package installed elsewhere may shadow ``tests.simulate``)."""
    spec = importlib.util.spec_from_file_location(
        "ema_simulate", os.path.join(ROOT, "tests", "simulate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ----------------------------------------------------------------------
# worlds (shared with tests/test_torch_pipeline.py)
# ----------------------------------------------------------------------

def golden_world():
    """The scenario of tests/test_golden.py:_world, built with the same
    rng sequence: returns (contigs, bc_strs, pairs) where pairs is
    (ids, bcs, s1, q1, s2, q2)."""
    sim = simulate()
    rng = np.random.default_rng(1234)
    g1 = sim.rand_genome(rng, 120_000)
    g2 = sim.rand_genome(rng, 60_000)
    g2[10_000:14_000] = g1[20_000:24_000]      # duplicated segment
    contigs = {"cA": g1, "cB": g2}
    gs = sim.to_str(np.concatenate([g1, g2]))
    ids, bc_strs, bcs, s1, q1, s2, q2, _ = sim.simulate_pairs(
        rng, gs, n_barcodes=6, frags_per_bc=(2, 3), pairs_per_frag=(14, 22),
        frag_len=20_000, read_len=90, err=0.004)
    # a pair with an unalignable mate (all-N read 2)
    ids.append("nn0")
    bc_strs.append(bc_strs[0])
    bcs.append(bcs[0])
    s1.append(gs[500:590])
    q1.append("I" * 90)
    s2.append("N" * 90)
    q2.append("I" * 90)
    # an N-containing read
    ids.append("nn1")
    bc_strs.append(bc_strs[0])
    bcs.append(bcs[0])
    r = list(gs[1500:1590])
    r[10:14] = "NNNN"
    s1.append("".join(r))
    q1.append("I" * 90)
    s2.append(gs[1700:1790])
    q2.append("I" * 90)
    return contigs, bc_strs, (ids, bcs, s1, q1, s2, q2)


def golden_sam(device) -> str:
    """Header + SAM of the golden world aligned by the port on
    ``device``, with the configuration of tests/test_golden.py."""
    from ema_tpu import config
    from ema_tpu.core.samout import write_sam_header
    from ema_tpu.index import build_index
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner

    contigs, _, pairs = golden_world()
    idx = build_index(contigs)
    cfg = config.RunConfig(batch_size=512, seed=7)
    header = write_sam_header(idx.names, idx.lengths, cfg.read_group,
                              "golden", "golden")
    lines = Aligner(idx, cfg, device=device).align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    return header + "".join(lines)


def bench_world():
    """The world of bench.py:132-145 (seed 2026, 3 Mbp, N_PAIRS 50,000
    requested, 100 bp reads, err 0.003, ~60 pairs per barcode)."""
    sim = simulate()
    rng = np.random.default_rng(2026)
    genome = sim.rand_genome(rng, 3_000_000)
    genome_str = sim.to_str(genome)
    n_bc = max(50_000 // 60, 1)
    ids, _, bcs, s1, q1, s2, q2, truth = sim.simulate_pairs(
        rng, genome_str, n_barcodes=n_bc, frags_per_bc=(2, 4),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100, err=0.003)
    return genome, (ids, bcs, s1, q1, s2, q2), truth


def truth_share(lines, ids, truth) -> tuple:
    """(within, total): mapped primary records within +-5 bp of truth."""
    parse_sam_line = simulate().parse_sam_line
    truth_by_id = {ids[i]: truth[i] for i in range(len(ids))}
    n = ok = 0
    for line in lines:
        s = parse_sam_line(line)
        if s["flag"] & (4 | 0x100 | 0x800):
            continue
        t = truth_by_id[s["qname"]]
        want = t["pos1"] if (s["flag"] & 64) else t["pos2"]
        n += 1
        ok += abs(s["pos"] - want) <= 5
    return ok, n


# ----------------------------------------------------------------------
# phase 2: kernel vs plain
# ----------------------------------------------------------------------

def _reads_from_text(rng, text, R, L, lens):
    """R reads of the given lengths drawn from ``text`` with ~2%
    substitutions, a one-base indel in a third of them and a few N
    bases; returns (oriented uint8 [R, L], true starts)."""
    n = text.shape[0]
    pos = rng.integers(0, n - 2 * L, R)
    out = np.full((R, L), 4, np.uint8)
    for r in range(R):
        rl = int(lens[r])
        seg = text[pos[r]:pos[r] + rl + 1].copy()
        if r % 3 == 1 and rl > 2:                     # deletion
            cut = int(rng.integers(1, rl - 1))
            seg = np.concatenate([seg[:cut], seg[cut + 1:]])
        elif r % 3 == 2 and rl > 2:                   # insertion
            cut = int(rng.integers(1, rl - 1))
            seg = np.concatenate([seg[:cut], [rng.integers(0, 4)],
                                  seg[cut:]])
        seg = seg[:rl].astype(np.uint8)
        mut = rng.random(rl) < 0.02
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        seg[rng.random(rl) < 0.003] = 4
        out[r, :rl] = seg
    return out, pos


def _to_dev(dev, **arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def sw_cases(dev, seed=7):
    """Named input sets for gather_score: the SW_CHUNK chained shape, the
    rescue shape and edge cases (one set per lanes-per-thread variant)."""
    rng = np.random.default_rng(seed)
    n = 3_000_000
    text = rng.integers(0, 4, n).astype(np.uint8)
    text[1_000_000:1_000_040] = 4                     # a run of N bases
    cases = {}

    # chained: N = SW_CHUNK candidates, m = 100, wl 1..128,
    # windows m + wl + 48 around a read's origin (or anywhere, 1 in 4)
    R, L, N = 8192, 100, 65536
    oriented, pos = _reads_from_text(rng, text, R, L, np.full(R, L))
    olens = np.full(R, L, np.int32)
    owners = rng.integers(0, R, N).astype(np.int32)
    wl = rng.integers(1, 129, N).astype(np.int32)
    win_lo = (pos[owners] - 24 + rng.integers(-20, 21, N)).astype(np.int64)
    far = rng.random(N) < 0.25
    win_lo[far] = rng.integers(0, n - 400, int(far.sum()))
    win_len = (olens[owners] + wl + 48).astype(np.int32)
    base = _to_dev(dev, text=text, oriented=oriented, olens=olens)
    cases["chained"] = dict(base, **_to_dev(
        dev, owners=owners, win_lo=win_lo, win_len=win_len, wl=wl))

    # rescue: the corridor is the whole insert window, wl = win_len = 683
    Nr = 8192
    owners = rng.integers(0, R, Nr).astype(np.int32)
    win_len = np.full(Nr, 583 + L, np.int32)
    win_lo = (pos[owners] - 59 - rng.integers(0, 500, Nr)).astype(np.int64)
    cases["rescue"] = dict(base, **_to_dev(
        dev, owners=owners, win_lo=win_lo, win_len=win_len,
        wl=win_len.copy()))

    # edge cases: mixed read lengths (0 .. 300), N bases, negative win_lo,
    # windows past the text end, wl = 1 and wl > win_len; one set per
    # kernel variant (lanes per thread 1, 2, 4, 8, 16, 24, 32)
    R2, L2 = 512, 300
    lens2 = rng.choice([0, 1, 5, 37, 90, 100, 151, 250, 300], R2)
    lens2 = lens2.astype(np.int32)
    oriented2, pos2 = _reads_from_text(rng, text, R2, L2, lens2)
    base2 = _to_dev(dev, text=text, oriented=oriented2, olens=lens2)
    for cap in (32, 64, 128, 256, 512, 768, 1024):
        Ne = 1024
        owners = rng.integers(0, R2, Ne).astype(np.int32)
        wl = rng.integers(1, cap + 1, Ne).astype(np.int32)
        wl[:4] = [1, cap, cap, 1]
        win_len = (lens2[owners] + rng.integers(-20, cap + 60, Ne))
        win_len = np.maximum(win_len, 1).astype(np.int32)
        win_lo = (pos2[owners] - rng.integers(0, 40, Ne)).astype(np.int64)
        k = Ne // 8
        win_lo[:k] = -rng.integers(1, 400, k)               # before start
        win_lo[k:2 * k] = n - rng.integers(1, 300, k)        # past the end
        win_lo[2 * k:2 * k + 8] = 1_000_000 - 50             # N run
        cases[f"edge_w{cap}"] = dict(base2, **_to_dev(
            dev, owners=owners, win_lo=win_lo, win_len=win_len, wl=wl))
    return cases


def _call(fn, c):
    return fn(c["text"], c["oriented"], c["olens"], c["owners"],
              c["win_lo"], c["win_len"], c["wl"], **SW_KW)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernel(dev, card: str) -> dict:
    from ema_tpu_torch.ops.sw import gather_score, gather_score_ref

    cases = sw_cases(dev)
    max_err = 0
    for name, c in cases.items():
        got = _call(gather_score, c)
        want = _call(gather_score_ref, c)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if len(got) else 0
        max_err = max(max_err, err)
        bad = int((got != want).any(dim=1).sum())
        log(f"kernel vs plain [{name}]: N={c['owners'].shape[0]} "
            f"max wl={int(c['wl'].max())} mismatching candidates={bad} "
            f"max_abs_err={err}")
        check(bad == 0, f"sw_banded kernel disagrees with the plain "
                        f"version on {name} ({bad} candidates)")

    stats = {}
    for name, reps in (("chained", 20), ("rescue", 10)):
        c = cases[name]
        rl = c["olens"][c["owners"].long()].long()
        cells = int((rl * c["wl"].long()).sum())
        ms = _time_ms(lambda: _call(gather_score, c), reps)
        plain_ms = _time_ms(lambda: _call(gather_score_ref, c), 2)
        stats[name] = dict(ms=ms, plain_ms=plain_ms, cells=cells)
        log(f"sw_banded [{name}] N={c['owners'].shape[0]}: kernel {ms} ms "
            f"({cells / ms / 1e6} Gcell/s), plain {plain_ms} ms "
            f"({cells / plain_ms / 1e6} Gcell/s), cells={cells}, "
            f"card: {card}")
    stats["max_abs_err"] = max_err
    return stats


# ----------------------------------------------------------------------
# phases 3-5
# ----------------------------------------------------------------------

def phase_golden(dev) -> None:
    from ema_tpu_torch.ops.sw import SW_LAUNCHES

    SW_LAUNCHES.reset()
    got = golden_sam(dev)
    launches = SW_LAUNCHES.value
    with open(GOLDEN) as f:
        want = f.read()
    n_rec = sum(1 for ln in got.splitlines() if not ln.startswith("@"))
    log(f"golden: {n_rec} records, identical={got == want}, "
        f"sw_banded launches={launches}")
    check(got == want, "golden SAM differs from tests/golden/expected.sam")
    check(launches > 0, "golden run never launched the sw_banded kernel")


def phase_main_path(dev, card: str) -> dict:
    from ema_tpu import config, native
    from ema_tpu.index import build_index
    from ema_tpu.utils.metrics import Metrics
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.ops.sw import SW_LAUNCHES

    t0 = time.time()
    genome, pairs, truth = bench_world()
    idx = build_index({"chr1": genome})
    n_pairs = len(pairs[0])
    log(f"bench world: {idx.n} bp, {n_pairs} pairs, built in "
        f"{time.time() - t0:.1f} s")
    aligner = Aligner(idx, config.RunConfig(), device=dev)

    # record one real chunk's first SW call (inputs and kernel output)
    captured = {}
    score_windows = aligner._score_windows

    def recording(oriented_dev, olens_dev, owners, win_lo, win_len,
                  wl=None):
        out = score_windows(oriented_dev, olens_dev, owners, win_lo,
                            win_len, wl=wl)
        if not captured:
            captured.update(oriented=oriented_dev.cpu().numpy(),
                            olens=olens_dev.cpu().numpy(), owners=owners,
                            win_lo=win_lo, win_len=win_len, wl=wl, out=out)
        return out

    def run() -> list:
        batch = ReadBatch.from_pairs(*pairs)
        return aligner.align_batch_to_sam(batch)

    SW_LAUNCHES.reset()
    aligner._score_windows = recording
    t0 = time.time()
    lines = run()
    warm = time.time() - t0
    del aligner._score_windows
    met = Metrics()
    aligner.metrics = met
    passes = []
    for _ in range(3):
        t0 = time.time()
        lines = run()
        torch.cuda.synchronize()
        passes.append(time.time() - t0)
    launches = SW_LAUNCHES.value
    aligner.metrics = None

    best = min(passes)
    log(f"main path: warm-up pass {warm} s, timed passes {passes} s, "
        f"{n_pairs / best} pairs/s (best pass), {len(lines)} SAM records, "
        f"sw_banded launches={launches}, card: {card}")
    log("stage split, thread-seconds summed over the 3 timed passes:")
    for name in sorted(met.wall):
        log(f"  {name}: {met.wall[name]} s n={met.items.get(name, 0)}")
    ok, n = truth_share(lines, pairs[0], truth)
    log(f"accuracy: {ok}/{n} = {ok / max(n, 1)} mapped primary records "
        f"within +-5 bp of truth")
    check(launches > 0, "main path never launched the sw_banded kernel")
    check(n >= n_pairs and ok / n >= 0.98,
          f"accuracy gate failed ({ok}/{n})")

    c = captured
    check(bool(c), "no SW call was recorded")
    wl = np.maximum(c["wl"] if c["wl"] is not None else c["win_len"], 1)
    nat = native.sw_banded_native(
        c["oriented"], c["olens"], idx.text, c["owners"], c["win_lo"],
        c["win_len"], int(wl.max()), wl=wl.astype(np.int32), **SW_KW)
    same = all(np.array_equal(nat[k], c["out"][k])
               for k in ("score", "qb", "qe", "ref_end"))
    log(f"native re-score of one chunk: {len(c['owners'])} candidates, "
        f"identical={same}")
    check(same, "kernel output differs from native.sw_banded_native")
    return dict(launches=launches, pairs_per_s=n_pairs / best)


def phase_cli(dev) -> None:
    from ema_tpu import config
    from ema_tpu.index import build_index
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.io import read_special_fastq

    contigs, bc_strs, (ids, _, s1, q1, s2, q2) = golden_world()
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        with open(ref, "w") as f:
            for name, codes in contigs.items():
                f.write(f">{name}\n{simulate().to_str(codes)}\n")
        bucket = os.path.join(tmp, "bucket.txt")
        with open(bucket, "w") as f:
            for row in zip(bc_strs, ids, s1, q1, s2, q2):
                f.write(" ".join(row) + "\n")
        out = os.path.join(tmp, "out.sam")
        r = subprocess.run(
            [sys.executable, "-m", "ema_tpu_torch.cli", "align", "-r", ref,
             "-s", bucket, "-o", out, "--device", str(dev)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"CLI align failed:\n{r.stderr}")
        with open(out) as f:
            cli_lines = [ln for ln in f if not ln.startswith("@")]
        lib_lines = Aligner(build_index(contigs), config.RunConfig(),
                            device=dev).align_batch_to_sam(
            read_special_fastq(bucket))
    log(f"CLI: {len(cli_lines)} records, identical to the library "
        f"path={cli_lines == lib_lines}")
    check(len(cli_lines) > 0 and cli_lines == lib_lines,
          "CLI SAM records differ from the library path")


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card\n")
        return 1
    from ema_tpu_torch.ops import _build
    from ema_tpu_torch.utils.backend import gpu_info, resolve_device

    dev = resolve_device("cuda")
    card = gpu_info()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(dev)}"
        f", card: {card}")
    t0 = time.time()
    _build.load_library()
    log(f"sw_banded kernel built/loaded in {time.time() - t0} s")

    kstats = phase_kernel(dev, card)
    phase_golden(dev)
    main_stats = phase_main_path(dev, card)
    phase_cli(dev)

    torch.cuda.synchronize()
    check("jax" not in sys.modules, "jax was imported")
    ch = kstats["chained"]
    log(json.dumps({"kernels": [{
        "name": "sw_banded", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_stats["launches"],
        "max_abs_err": kstats["max_abs_err"], "ms": ch["ms"],
        "plain_ms": ch["plain_ms"]}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
