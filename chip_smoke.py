#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ema_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and builds the four
SW kernels from the sources in the checkout (one nvcc per source, all
started together, sm_90a).  Phases, in order; any failure raises and the
run exits non-zero:

  1. setup: torch/CUDA versions, the card, the kernel build time and what
     ptxas says of each kernel (registers, spills);
  2. kernel vs plain: each kernel (sw_banded, sw_banded16,
     sw_banded_packed, sw_batch) against its plain PyTorch version on the
     card, bit-exact on all four outputs, at the SW_CHUNK chained shape,
     the mate-rescue shape and edge sets (read lengths 0..1023, N runs,
     negative win_lo, windows past the text end, corridors up to 4096),
     with kernel and plain times;
  3. golden: the world of tests/test_golden.py aligned on the card with
     each scorer (banded, banded16, tier64, scan) must reproduce
     tests/golden/expected.sam byte for byte, launching its kernels;
  4. main path: the bench world of bench.py (BASELINE config 1: 3 Mbp
     genome, ~40.7k pairs of 100 bp reads) aligned on the card with each
     scorer, with pairs/s, launches and accuracy against the simulation
     truth; the default run also gives the stage split and re-scores one
     real chunk with the native host scorer, banded16 and tier64 must
     give the default's SAM records, and scan re-scores one real chunk
     with its plain version on the card;
  5. long reads: two pairs of 600 bp reads (mate-rescue corridors past
     1024 lanes) aligned on the card must give the CPU path's SAM;
  6. CLI: ``python -m ema_tpu_torch.cli align`` on a small input must
     give the library path's SAM records;
  7. checks: synchronise, and no jax was imported.

The line before the last is the card's name and power limit as nvidia-smi
prints them, the one before it the per-kernel JSON record; the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "expected.sam")
SW_KW = dict(match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5)
# kernel -> (gather_score scorer, source, the TPU kernel it replaces)
KERNELS = {
    "sw_banded": ("banded", "ema_tpu_torch/ops/csrc/sw_banded.cu",
                  "ema_tpu/ops/sw_pallas.py:260"),
    "sw_banded16": ("banded16", "ema_tpu_torch/ops/csrc/sw_banded16.cu",
                    "ema_tpu/ops/sw_pallas.py:469"),
    "sw_banded_packed": ("packed",
                         "ema_tpu_torch/ops/csrc/sw_banded_packed.cu",
                         "ema_tpu/ops/sw_pallas.py:670"),
    "sw_batch": ("scan", "ema_tpu_torch/ops/csrc/sw_batch.cu",
                 "ema_tpu/ops/sw_pallas.py:43"),
}
# Aligner scorer -> the kernel its main-path run must launch
MAIN_KERNEL = {"banded": "sw_banded", "banded16": "sw_banded16",
               "tier64": "sw_banded_packed", "scan": "sw_batch"}


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


def golden_sam(device, sw_impl=None) -> str:
    """Header + SAM of the golden world aligned by the port on
    ``device`` with the scorer ``sw_impl``, with the configuration of
    tests/test_golden.py."""
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
    lines = Aligner(idx, cfg, device=device,
                    sw_impl=sw_impl).align_batch_to_sam(
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
    rescue shape and edge sets (one per lanes-per-thread variant of the
    banded kernels, and long reads whose corridors take several warps)."""
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
    # the same candidates restricted to the packed tier's corridors
    small = wl <= 64
    cases["chained_w64"] = dict(base, **_to_dev(
        dev, owners=owners[small], win_lo=win_lo[small],
        win_len=win_len[small], wl=wl[small]))
    odd = np.nonzero(small)[0][:4097]
    cases["odd_w64"] = dict(base, **_to_dev(
        dev, owners=owners[odd], win_lo=win_lo[odd], win_len=win_len[odd],
        wl=wl[odd]))

    # rescue: the corridor is the whole insert window, wl = win_len = 683
    Nr = 8192
    owners = rng.integers(0, R, Nr).astype(np.int32)
    win_len = np.full(Nr, 583 + L, np.int32)
    win_lo = (pos[owners] - 59 - rng.integers(0, 500, Nr)).astype(np.int64)
    cases["rescue"] = dict(base, **_to_dev(
        dev, owners=owners, win_lo=win_lo, win_len=win_len,
        wl=win_len.copy()))

    # edge sets: mixed read lengths, N bases, negative win_lo, windows
    # past the text end, wl = 1 and wl > win_len; one set per kernel
    # variant of the banded kernels (lanes per thread 1 .. 32, then 4 and
    # 8 warps per candidate for the long reads)
    def edge_set(oriented_e, lens_e, pos_e, cap, Ne):
        owners = rng.integers(0, lens_e.shape[0], Ne).astype(np.int32)
        wl = rng.integers(1, cap + 1, Ne).astype(np.int32)
        wl[:4] = [1, cap, cap, 1]
        win_len = (lens_e[owners] + rng.integers(-20, cap + 60, Ne))
        win_len = np.maximum(win_len, 1).astype(np.int32)
        win_lo = (pos_e[owners] - rng.integers(0, 40, Ne)).astype(np.int64)
        k = Ne // 8
        win_lo[:k] = -rng.integers(1, 400, k)               # before start
        win_lo[k:2 * k] = n - rng.integers(1, 300, k)        # past the end
        win_lo[2 * k:2 * k + 8] = 1_000_000 - 50             # N run
        return dict(_to_dev(dev, text=text, oriented=oriented_e,
                            olens=lens_e), **_to_dev(
            dev, owners=owners, win_lo=win_lo, win_len=win_len, wl=wl))

    R2, L2 = 512, 300
    lens2 = rng.choice([0, 1, 5, 37, 90, 100, 151, 250, 300], R2)
    lens2 = lens2.astype(np.int32)
    oriented2, pos2 = _reads_from_text(rng, text, R2, L2, lens2)
    for cap in (32, 64, 128, 256, 512, 768, 1024):
        cases[f"edge_w{cap}"] = edge_set(oriented2, lens2, pos2, cap, 1024)
    # long reads (500..1023 bp) with corridors past one warp
    R3, L3 = 128, 1023
    lens3 = rng.integers(500, L3 + 1, R3).astype(np.int32)
    lens3[:2] = [500, L3]
    oriented3, pos3 = _reads_from_text(rng, text, R3, L3, lens3)
    for cap in (2048, 4096):
        cases[f"long_w{cap}"] = edge_set(oriented3, lens3, pos3, cap, 256)
    return cases


# the cases each kernel is held to (the packed tier takes wl <= 64)
KERNEL_CASES = {
    "sw_banded": None, "sw_banded16": None, "sw_batch": None,
    "sw_banded_packed": ("chained_w64", "odd_w64", "edge_w32", "edge_w64"),
}
# the pipeline shape each kernel is timed at, then the extra shapes
TIMED = {"sw_banded": ("chained", "rescue"),
         "sw_banded16": ("chained", "rescue"),
         "sw_banded_packed": ("chained_w64",),
         "sw_batch": ("chained", "rescue")}


def _call(fn, c, scorer):
    return fn(c["text"], c["oriented"], c["olens"], c["owners"],
              c["win_lo"], c["win_len"], c["wl"], scorer=scorer, **SW_KW)


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


def _cells(c, scorer) -> int:
    """DP cells a kernel computes: rl x wl for the banded kernels, rl x
    window for the whole-window scan."""
    rl = c["olens"][c["owners"].long()].long()
    width = c["win_len"] if scorer == "scan" else c["wl"]
    return int((rl * width.long()).sum())


def phase_kernel(dev, card: str) -> dict:
    from ema_tpu_torch.ops.sw import gather_score, gather_score_ref

    cases = sw_cases(dev)
    stats = {}
    for name, (scorer, _, _) in KERNELS.items():
        max_err = 0
        for cname in KERNEL_CASES[name] or cases:
            c = cases[cname]
            got = _call(gather_score, c, scorer)
            want = _call(gather_score_ref, c, scorer)
            torch.cuda.synchronize()
            err = (int((got.long() - want.long()).abs().max())
                   if len(got) else 0)
            max_err = max(max_err, err)
            bad = int((got != want).any(dim=1).sum())
            log(f"{name} vs plain [{cname}]: N={c['owners'].shape[0]} "
                f"max wl={int(c['wl'].max())} max window="
                f"{int(c['win_len'].max())} mismatching candidates={bad} "
                f"max_abs_err={err}")
            check(bad == 0, f"{name} kernel disagrees with the plain "
                            f"version on {cname} ({bad} candidates)")
        st = {"max_abs_err": max_err}
        for cname in TIMED[name]:
            c = cases[cname]
            cells = _cells(c, scorer)
            reps = 20 if cname.startswith("chained") else 10
            ms = _time_ms(lambda: _call(gather_score, c, scorer), reps)
            plain_ms = _time_ms(lambda: _call(gather_score_ref, c, scorer),
                                2)
            st.setdefault("ms", ms)
            st.setdefault("plain_ms", plain_ms)
            log(f"{name} [{cname}] N={c['owners'].shape[0]}: kernel {ms} "
                f"ms ({cells / ms / 1e6} Gcell/s), plain {plain_ms} ms "
                f"({cells / plain_ms / 1e6} Gcell/s), cells={cells}, "
                f"card: {card}")
        stats[name] = st
    # the packed tier's shape through the one-warp banded kernel
    c = cases["chained_w64"]
    ms = _time_ms(lambda: _call(gather_score, c, "banded"), 20)
    log(f"sw_banded [chained_w64] N={c['owners'].shape[0]}: kernel {ms} ms "
        f"({_cells(c, 'banded') / ms / 1e6} Gcell/s), card: {card}")
    return stats


# ----------------------------------------------------------------------
# phases 3-5
# ----------------------------------------------------------------------

def _launched() -> dict:
    from ema_tpu_torch.ops.sw import LAUNCHES
    return {k: c.value for k, c in LAUNCHES.items()}


def phase_golden(dev) -> None:
    from ema_tpu_torch.ops.sw import reset_counts

    with open(GOLDEN) as f:
        want = f.read()
    for sw_impl, kernel in MAIN_KERNEL.items():
        reset_counts()
        got = golden_sam(dev, sw_impl)
        launches = _launched()
        n_rec = sum(1 for ln in got.splitlines() if not ln.startswith("@"))
        log(f"golden [{sw_impl}]: {n_rec} records, identical={got == want}, "
            f"launches={launches}")
        check(got == want, f"golden SAM under {sw_impl} differs from "
                           f"tests/golden/expected.sam")
        check(launches[kernel] > 0,
              f"golden run under {sw_impl} never launched {kernel}")


def _recording(aligner, captured):
    """Wrap aligner._score_windows to keep its first call's inputs and
    output (one real chunk of the main path)."""
    score_windows = aligner._score_windows

    def recording(oriented_dev, olens_dev, owners, win_lo, win_len,
                  wl=None, **kw):
        out = score_windows(oriented_dev, olens_dev, owners, win_lo,
                            win_len, wl=wl, **kw)
        if not captured:
            captured.update(oriented_dev=oriented_dev, olens_dev=olens_dev,
                            owners=owners, win_lo=win_lo, win_len=win_len,
                            wl=wl, out=out)
        return out
    return recording


def _main_run(dev, card, idx, pairs, truth, sw_impl, metrics=False):
    """One scorer on the bench world: a warm-up pass (recording one SW
    call), then 3 timed passes; returns (lines, stats, captured)."""
    from ema_tpu import config
    from ema_tpu.utils.metrics import Metrics
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.ops.sw import reset_counts

    n_pairs = len(pairs[0])
    aligner = Aligner(idx, config.RunConfig(), device=dev, sw_impl=sw_impl)

    def run() -> list:
        return aligner.align_batch_to_sam(ReadBatch.from_pairs(*pairs))

    captured = {}
    reset_counts()
    aligner._score_windows = _recording(aligner, captured)
    t0 = time.time()
    lines = run()
    torch.cuda.synchronize()
    warm = time.time() - t0
    del aligner._score_windows
    met = Metrics() if metrics else None
    aligner.metrics = met
    passes = []
    for _ in range(3):
        t0 = time.time()
        lines = run()
        torch.cuda.synchronize()
        passes.append(time.time() - t0)
    launches = _launched()
    aligner.metrics = None

    best = min(passes)
    log(f"main path [{sw_impl}]: warm-up pass {warm} s, timed passes "
        f"{passes} s, {n_pairs / best} pairs/s (best pass), {len(lines)} "
        f"SAM records, launches over 4 passes={launches}, card: {card}")
    if met is not None:
        log("stage split, thread-seconds summed over the 3 timed passes:")
        for name in sorted(met.wall):
            log(f"  {name}: {met.wall[name]} s n={met.items.get(name, 0)}")
    ok, n = truth_share(lines, pairs[0], truth)
    log(f"accuracy [{sw_impl}]: {ok}/{n} = {ok / max(n, 1)} mapped primary "
        f"records within +-5 bp of truth")
    kernel = MAIN_KERNEL[sw_impl]
    check(launches[kernel] > 0,
          f"main path under {sw_impl} never launched {kernel}")
    check(n >= n_pairs and ok / n >= 0.98,
          f"accuracy gate failed under {sw_impl} ({ok}/{n})")
    check(bool(captured), "no SW call was recorded")
    return lines, dict(launches=launches[kernel],
                       pairs_per_s=n_pairs / best), captured


def phase_main_path(dev, card: str) -> dict:
    from ema_tpu import native
    from ema_tpu.index import build_index
    from ema_tpu_torch.ops.sw import gather_score_ref

    t0 = time.time()
    genome, pairs, truth = bench_world()
    idx = build_index({"chr1": genome})
    log(f"bench world: {idx.n} bp, {len(pairs[0])} pairs, built in "
        f"{time.time() - t0:.1f} s")

    stats = {}
    lines, stats["banded"], c = _main_run(dev, card, idx, pairs, truth,
                                          "banded", metrics=True)
    wl = np.maximum(c["wl"] if c["wl"] is not None else c["win_len"], 1)
    nat = native.sw_banded_native(
        c["oriented_dev"].cpu().numpy(), c["olens_dev"].cpu().numpy(),
        idx.text, c["owners"], c["win_lo"], c["win_len"], int(wl.max()),
        wl=wl.astype(np.int32), **SW_KW)
    same = all(np.array_equal(nat[k], c["out"][k])
               for k in ("score", "qb", "qe", "ref_end"))
    log(f"native re-score of one chunk: {len(c['owners'])} candidates, "
        f"identical={same}")
    check(same, "sw_banded output differs from native.sw_banded_native")

    for sw_impl in ("banded16", "tier64"):
        got, stats[sw_impl], _ = _main_run(dev, card, idx, pairs, truth,
                                           sw_impl)
        log(f"main path [{sw_impl}]: SAM records identical to banded="
            f"{got == lines}")
        check(got == lines, f"{sw_impl} SAM records differ from banded")

    _, stats["scan"], c = _main_run(dev, card, idx, pairs, truth, "scan")
    text = torch.from_numpy(idx.text).to(dev)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    ref = gather_score_ref(
        text, c["oriented_dev"], c["olens_dev"], put(c["owners"], np.int32),
        put(c["win_lo"], np.int64), put(c["win_len"], np.int32),
        put(np.maximum(c["win_len"], 1), np.int32), scorer="scan",
        **SW_KW).cpu().numpy()
    same = all(np.array_equal(ref[:, i], c["out"][k])
               for i, k in enumerate(("score", "qb", "qe", "ref_end")))
    log(f"plain scan re-score of one chunk on the card: "
        f"{len(c['owners'])} candidates, identical={same}")
    check(same, "sw_batch output differs from sw_score_batch_ref")
    return stats


def long_read_world():
    """Two pairs of 600 bp reads on a 60 kbp genome.  Pair 0's second
    mate carries a substitution every 12 bases, so it has no seed and is
    found only by mate rescue, whose corridor is the whole window:
    583 + 600 = 1183 lanes, more than one warp of the banded kernel
    holds.  Returns (genome, (ids, bcs, s1, q1, s2, q2))."""
    sim = simulate()
    rng = np.random.default_rng(600)
    genome = sim.rand_genome(rng, 60_000)
    gs = sim.to_str(genome)
    comp = str.maketrans("ACGT", "TGCA")

    def revcomp(s):
        return s.translate(comp)[::-1]

    ids, s1, s2 = [], [], []
    for k, p in enumerate((10_000, 40_000)):
        mate = list(gs[p + 300:p + 900])
        if k == 0:
            for j in range(5, 600, 12):
                mate[j] = "ACGT"[("ACGT".index(mate[j]) + 1) % 4]
        ids.append(f"long{k}")
        s1.append(gs[p:p + 600])
        s2.append(revcomp("".join(mate)))
    q = "I" * 600
    return genome, (ids, [7, 7], s1, [q, q], s2, [q, q])


def phase_long_reads(dev) -> None:
    from ema_tpu import config
    from ema_tpu.index import build_index
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.ops.sw import reset_counts

    genome, pairs = long_read_world()
    idx = build_index({"c": genome})
    out, widest, launches = {}, {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        aligner = Aligner(idx, config.RunConfig(), device=d)
        corridors = []
        score_windows = aligner._score_windows

        def recording(*a, wl=None, **kw):
            corridors.append(int(np.max(wl)) if wl is not None else 0)
            return score_windows(*a, wl=wl, **kw)
        aligner._score_windows = recording
        reset_counts()
        out[where] = aligner.align_batch_to_sam(
            ReadBatch.from_pairs(*pairs))
        widest[where] = max(corridors, default=0)
        launches[where] = _launched()["sw_banded"]
        log(f"long reads on the {where}: {len(out[where])} records, "
            f"widest corridor {widest[where]}, sw_banded launches="
            f"{launches[where]}")
    check(widest["card"] > 1024, "no corridor past 1024 lanes was scored")
    check(launches["card"] > 0, "the card run never launched sw_banded")
    check(len(out["card"]) == 4
          and all(ln.split("\t")[5] != "*" for ln in out["card"]),
          "a 600 bp read went unaligned on the card")
    check(out["card"] == out["cpu"],
          "long-read SAM on the card differs from the CPU path")


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
    _build.load_all()
    log(f"kernels {', '.join(KERNELS)} built/loaded in {time.time() - t0} s")
    for name in KERNELS:
        ptxas = _build.ptxas_log(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                              ptxas)]
        log(f"ptxas {name}: {len(regs)} kernels, registers {regs}, spill "
            f"stores {sum(spills)} bytes")

    kstats = phase_kernel(dev, card)
    phase_golden(dev)
    main_stats = phase_main_path(dev, card)
    phase_long_reads(dev)
    phase_cli(dev)

    torch.cuda.synchronize()
    check("jax" not in sys.modules, "jax was imported")
    by_kernel = {k: main_stats[s] for s, k in MAIN_KERNEL.items()}
    log("main path pairs/s: " + ", ".join(
        f"{s} {main_stats[s]['pairs_per_s']}" for s in MAIN_KERNEL)
        + f", card: {card}")
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": by_kernel[name]["launches"],
        "max_abs_err": kstats[name]["max_abs_err"],
        "ms": kstats[name]["ms"], "plain_ms": kstats[name]["plain_ms"]}
        for name, (_, source, replaces) in KERNELS.items()]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
