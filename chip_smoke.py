#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ema_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and builds the five
kernels (four SW kernels and the int32 ALU probe) from the sources in the
checkout (one nvcc per source, all started together, sm_90a) and the
port's native C++ library (g++).  Before its first import of the port it
installs an import finder that refuses ``jax``, ``jaxlib`` and the JAX
package ``ema_tpu``: the port stands on its own.  Phases, in order; any
failure raises and the run exits non-zero:

  1. setup: torch/CUDA versions, the card, the build times of the native
     library and the kernels, and what ptxas says of each kernel
     (registers, spills);
  2. kernel vs plain: each kernel (sw_banded, sw_banded16,
     sw_banded_packed, sw_batch) against its plain PyTorch version on the
     card, bit-exact on all four outputs, at the SW_CHUNK chained shape,
     the mate-rescue shape, a mixed-width set drawn as the pipeline draws
     its corridors (most near 50, a tail to 250, a few past 1024 in one
     call) and edge sets (read lengths 0..1023, N runs, negative win_lo,
     windows past the text end, corridors up to 4096; for sw_batch also
     one set per thread form: reads of 1 to 1023 bp at call sizes on both
     sides of its threshold), with kernel and plain times and each
     kernel's bound (the least time the card could take for the same
     cells at its peak issue and int32 rates; the s16x2 rate that the
     probe measures is logged beside them), sw_batch at 8 and 32 threads
     a candidate and sw_banded_packed at 8 x 8 and 16 x 4 lanes, each
     form held to the launch's own choice (packed also on reads to 1023
     bp whose start rows lie past 256); sw_banded in each class's
     large-call and small-call forms bit-exact on every set, under a
     scoring past a signed byte (match 200, mismatch 150) and on the tie
     sets (TIE_SETS, WARP_TIE_SET), and both forms timed across call
     sizes for corridors of 200 to 1000 lanes; sw_batch in every form
     bit-exact under that scoring (the mask form of its lookup) on all
     its sets and on the tie sets at every score times 200, where it
     must pick the byte form's cells, and its launches timed in the mask
     and the byte form;
 2b. sanitize: every instantiation of the five kernels (86: each form of
     each launch table, byte and mask scorings, the probe's unrolls and
     forms) on small sets (odd N, segments past N, mixed read lengths with
     tail rows, windows off both ends of the text, alignments that cross
     warps through shared memory) and one sorted class call, each held
     bit-exact to its plain version, in subprocesses under
     compute-sanitizer's memcheck, racecheck, synccheck and initcheck
     (only the port's kernels instrumented) and under the card's own
     checks: a fenced allocator (unmapped memory past either end of every
     buffer, its bytes poisoned) and the SW kernels built with schedule
     fuzzing; a tool that declines the card is reported as refused (with
     the tool's version, the driver and the kernel), any error fails the
     phase;
  3. fm: the torch FM-index ops on the card against the native host ops,
     bit-exact, on one bench-world chunk, at sa_rate 2 and 4: locate of
     the chunk's SMEM hit rows, greedy seeding of its reads, and the fused
     seed+locate against host compaction + locate; device and native
     locate times;
  4. em: the cloud-EM kernel (csrc/em_cloud.cu) through the dispatch on
     the card against its plain version, the host EM (numpy batch) and the
     native flat EM on the groups of one bench-world emit batch and on
     synthetic batches of multimapping groups (10x and many-clouds), each
     with a group deeper than 64 candidates and, synthetic, one past the
     kernel's shared memory: rtol 1e-9 / atol 1e-12, the same bits on a
     second run, one launch a dispatch, card and host EM times, and the
     kernel's device time beside em_run's eager chain on the card;
  5. golden: the world of tests/test_golden.py aligned on the card with
     each scorer (banded, banded16, tier64, scan), with device and host
     EM and with device locate must reproduce tests/golden/expected.sam
     byte for byte, launching its kernels; greedy seeding on the device
     must give greedy seeding on the host;
  6. main path: the bench world of bench.py (BASELINE config 1: 3 Mbp
     genome, ~40.7k pairs of 100 bp reads) aligned on the card with each
     scorer, with pairs/s, launches and accuracy against the simulation
     truth; the default run also gives the stage split and the peak
     device memory, passes check_sam with no fault and re-scores one
     real chunk with the native host scorer, sw_banded's launches of a
     pass split by chained and rescue calls, banded16 and tier64 must
     give the default's SAM records, and scan re-scores one real chunk
     with its plain version on the card; scan and banded under match
     200 / mismatch 150 must give the same records; every SW kernel
     timed on the
     default run's recorded chained and rescue calls (cells, ms, Gcell/s,
     share of the bound, each thread form apart; sw_banded's and
     sw_banded16's launch rules and the thread forms of sw_banded,
     sw_banded16, sw_banded_packed and sw_batch on that chained call);
     then device EM on and
     off in turns (on, off, off, on) with pairs/s, the whole stage table
     and 0 differing records, one torch.profiler pass (device idle share,
     the EM's launches per emit batch and per pass, and whether the EM
     stream overlaps the SW stream), and one pass with device locate
     that must give the default's records;
  7. long reads: two pairs of 600 bp reads (mate-rescue corridors past
     1024 lanes) aligned on the card must give the CPU path's SAM;
  8. CLI: the port's ``align`` with no ``--device`` (the card is the
     default) on a small input must give the SAM records of
     ``Aligner(idx, cfg)``, whose default device is the card too;
  9. bench tool: ema_tpu_torch.tools.bench_sw in this process at its full
     shape (B = 16,384, m = 100, n = 192, W = 128): Gcell/s of each SW
     kernel and plain version, every variant bit-exact, packed against
     its wl-masked plain version; the probe, all three forms, bit-exact
     against their plain versions on the TPU's [8, 128] input and on a
     card-filling grid, timed at the TPU tool's K, against the card's
     theoretical int32 rate, and the banded kernel's roofline share; what
     each s16x2 operation compiles to and the SASS instructions a cell
     of the SW kernels' inner loops (cuobjdump);
 10. -x: the bench world written as an interleaved FASTQ and a
     whitelist, then ``count``, ``preproc -n 500 -t 4`` and ``align -x``
     over the 500 buckets: coalesced, ``--no-coalesce -j 1`` and ``-j 2``
     byte-identical and with no check_sam fault, a ``--manifest`` rerun
     that touches no part, two
     ``--sort --shard`` runs merged equal to the single sorted run (MI
     masked), samdiff against the library path with 0 records differing,
     >= 98% within +-5 bp, pairs/s of each and of the library path;
 11. sharded: a 3 Mbp genome of 4 contigs in 2 index shards; the
     ShardedAligner equals the single-index Aligner (MI masked) under
     device and host EM, with pairs/s of both, and ``index --shard-bases``
     then ``align -s`` and ``align -x`` through the CLI give the library
     path's records;
 12. mesh: the sharded candidate step over ``["cuda:0"] * n`` at (data,
     cand) = (2, 1), (1, 2) and (2, 2) on 81,408 oriented bench-world
     reads, bit-exact against ``candidate_core`` on one device with
     every slot of the split (and that core against its CPU plain path on
     256 reads), its sums equal to the host's, with sw_banded's launches
     and reads/s beside the one-device step; ``bench_scaling.
     partition_check(2)``; the Aligner on ``["cuda:0"] * 2`` (default and
     device locate, whose 4th pass must also give phase 6's records, and
     greedy device seed+locate on 8,192 pairs) must give the one-device
     records, in turns.  Both cells are one card: no scaling is measured;
 13. multihost: two halves of the bench world's FASTQ counted apart, two
     ``preproc --coordinator`` processes of one gloo group on 127.0.0.1
     must give a one-process preproc's buckets byte for byte, and two
     ``align -x --coordinator`` processes sharing the card phase 10's
     records (MI masked);
 14. tools: the tool twins of ema_tpu_torch/tools/, each once on the
     card: bench at full size on the bench world (BASELINE config 1),
     ab_align (device and host EM, the SAM held equal), hostbound,
     prof_pipeline, prof_smem; bench_configs config4, bench_config5 and
     verify_drive as subprocesses through the port's CLI at reduced
     sizes; measure_accuracy (3 Mbp, 20,000 pairs: >= 98% at truth, every
     mapq bin populated), chain_recall on tests/test_chain_recall.py's
     world (d0 and d_le3 recall >= 99.9%) and diagnose_mapq;
 14b. stream sanitize: a reduced bench-world pass (8,192 pairs, 4 chunks
     in flight, device EM on its side stream), a 2 x 2 mesh step and the
     2-cell Aligner under torch's stream sanitizer, in every thread, with
     every kernel launch handed to it as the buffers it reads and writes
     on its stream: no data race;
 15. checks: synchronise, and neither jax nor ema_tpu was imported.

The line before the last is the card's name and power limit as nvidia-smi
prints them, the one before it the per-kernel JSON record (with what each
sanitizer said of the kernel); the last line is {"ok": true, "device":
{...}}.  ``--sanitize-drive SETS [--fence end|start] [--fuzz]`` and
``--stream-sanitize-drive`` are the two sanitizer phases' subprocesses,
and rerun one check alone (the drive makes SETS where it is missing).
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "expected.sam")
SW_KW = dict(match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5)
# kernel -> (gather_score scorer, source, the TPU kernel it replaces)
KERNELS = {
    "alu_probe": (None, "ema_tpu_torch/ops/csrc/alu_probe.cu",
                  "tools/bench_sw.py:193"),
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


REFUSED_IMPORTS = ("jax", "jaxlib", "ema_tpu")


class RefuseReferenceImports:
    """A ``sys.meta_path`` finder that fails any import of jax, jaxlib or
    the JAX package ``ema_tpu`` (the name itself or a submodule; not
    ``ema_tpu_torch``), so that a port module reaching for the reference
    fails loudly instead of passing unnoticed."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED_IMPORTS:
            raise ImportError(f"import of {name!r} refused: the port "
                              "imports nothing of jax or ema_tpu")
        return None


def refuse_reference_imports() -> None:
    """Install ``RefuseReferenceImports`` ahead of every other finder."""
    if not any(isinstance(f, RefuseReferenceImports) for f in sys.meta_path):
        sys.meta_path.insert(0, RefuseReferenceImports())


def reference_modules_loaded() -> list:
    """The modules of jax, jaxlib or ema_tpu in ``sys.modules``."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in REFUSED_IMPORTS)


def simulate():
    """The port's copy of the repo's read simulator (tests/simulate.py,
    which imports the JAX package's barcode codec)."""
    from ema_tpu_torch.tools import simulate as sim
    return sim


LOG_PATH = os.path.join(ROOT, "build", "ema_tpu_torch", "chip_smoke.log")
_log_file = None


def log(msg: str) -> None:
    """Print, and keep the whole run's lines in
    build/ema_tpu_torch/chip_smoke.log of the checkout (gitignored): a
    caller may only see the output's end."""
    global _log_file
    print(msg, flush=True)
    if _log_file is None:
        os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
        _log_file = open(LOG_PATH, "w")
    _log_file.write(msg + "\n")
    _log_file.flush()


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


def golden_sam(device, sw_impl=None, *, device_em=None, seed_impl=None,
               seeding=None) -> str:
    """Header + SAM of the golden world aligned by the port on
    ``device`` with the configuration of tests/test_golden.py, the scorer
    ``sw_impl``, ``RunConfig(device_em=...)``, the seeder ``seeding``
    (smem when None) and ``seed_impl``."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core.samout import write_sam_header
    from ema_tpu_torch.index import build_index
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner

    contigs, _, pairs = golden_world()
    idx = build_index(contigs)
    cfg = config.RunConfig(batch_size=512, seed=7, device_em=device_em,
                           aligner=config.AlignerParams(seeding=seeding))
    header = write_sam_header(idx.names, idx.lengths, cfg.read_group,
                              "golden", "golden")
    lines = Aligner(idx, cfg, device=device, sw_impl=sw_impl,
                    seed_impl=seed_impl).align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    return header + "".join(lines)


def bench_world():
    """The world of bench.py:132-145 (seed 2026, 3 Mbp, N_PAIRS 50,000
    requested, 100 bp reads, err 0.003, ~60 pairs per barcode), as
    ema_tpu_torch/tools/bench.bench_world builds it: returns (genome,
    pairs, truth, barcode strings)."""
    from ema_tpu_torch.tools.bench import bench_world as world
    return world()


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


def cand_inputs(text, cands) -> dict:
    """gather_score's inputs (numpy) for ``cands``, tuples (read codes,
    win_lo, win_len, wl) over ``text``: candidate b owns read b."""
    L = max(max(len(c[0]) for c in cands), 1)
    oriented = np.full((len(cands), L), 4, np.uint8)
    for b, c in enumerate(cands):
        oriented[b, :len(c[0])] = c[0]
    col = [np.array([c[i] for c in cands]) for i in (1, 2, 3)]
    return dict(text=text, oriented=oriented,
                olens=np.array([len(c[0]) for c in cands], np.int32),
                owners=np.arange(len(cands), dtype=np.int32),
                win_lo=col[0].astype(np.int64),
                win_len=col[1].astype(np.int32), wl=col[2].astype(np.int32))


# Two-letter reads and windows under scorings with many equal paths, each
# set drawn as ``tie_batch`` draws it: in the picked candidates the output
# is decided by one tie rule, so that reversing it in the plain sweep (or
# in a kernel's emulation) changes their (score, qb, qe, ref_end).  Set 1
# (open 0, extend 1, 4,096 drawn): the scan's nearer-source rule (391 ...
# 2451), the merge's diag >= horizontal (9, 15, 16) and horizontal >=
# vertical (54, 167), the vertical gap's open >= extend (499, 3310) and the
# diagonal's H >= fresh (18, 21).  Set 2 (open 1, extend 0, 1,024 drawn):
# the nearer-source rule between the threads' carries (182, 424, 789, 888).
TIE_SETS = (
    (dict(match=1, mismatch=1, gap_open=0, gap_extend=1, clip=0), 4096,
     (391, 584, 951, 1538, 1715, 2308, 2451, 9, 15, 16, 54, 167, 499, 3310,
      18, 21)),
    (dict(match=1, mismatch=1, gap_open=1, gap_extend=0, clip=0), 1024,
     (182, 424, 789, 888)),
)
# The nearer-source rule between the warps of a several-warp candidate
# (``warp_tie_batch``; open 3, extend 0): the warp carry of sw_banded's
# 4 warps x 32 x 4 form (the small call's of the 512 class) decides every
# pick (reversing it turns qb from 2 to 0), the thread carry of its
# one-warp forms.
WARP_TIE_SET = (dict(match=1, mismatch=1, gap_open=3, gap_extend=0, clip=0),
                12, (0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11))


def tie_batch(B, picks):
    """A seeded batch of B candidates: reads of 4..24 bases and windows of
    4..92 over {0, 1}, corridors 1..64, windows laid end to end as the
    text; returns the text and the picked candidates."""
    rng = np.random.default_rng(0)
    m, n = 24, 92
    reads = rng.integers(0, 2, (B, m))
    rl = rng.integers(4, m + 1, B)
    wl = rng.integers(1, 65, B)
    refs = rng.integers(0, 2, (B, n))
    nl = rng.integers(4, n + 1, B)
    text = refs.reshape(-1).astype(np.uint8)
    return text, [(reads[b, :rl[b]], b * n, int(nl[b]), int(wl[b]))
                  for b in picks]


def warp_tie_batch(B, picks, n=300):
    """B candidates whose horizontal gap has two sources of one value in
    two warps: windows of N bases (laid end to end as the text) holding,
    for a two-letter read of m bases, its first c bases with one mismatch
    on a lane below 100 (value c - 2 at row c, start row 0), its bases
    2..c on a lane of 130..189 (value c - 2, start row 2) and its bases
    c..m on a lane to the right of both, reached by a gap from row c;
    corridors of 257..512 lanes (the 512 class).  Returns the text and the
    picked candidates."""
    rng = np.random.default_rng(1)
    text = np.full((B, n), 4, np.uint8)
    cands = []
    for b in range(B):
        c = int(rng.integers(6, 11))
        m = int(rng.integers(c + 4, 25))
        read = rng.integers(0, 2, m)
        ka = int(rng.integers(0, 100))
        kb = int(rng.integers(130, 190))
        kt = int(rng.integers(kb + 5, 241))
        far = read[:c].copy()
        far[int(rng.integers(2, c - 2))] ^= 1
        text[b, ka:ka + c] = far                  # rows 1..c on lane ka
        text[b, kb + 2:kb + c] = read[2:c]        # rows 3..c on lane kb
        text[b, kt + c:kt + m] = read[c:]         # rows c+1..m on lane kt
        wl = int(rng.integers(257, 513))
        cands.append((read, b * n, int(kt + m + rng.integers(0, 10)), wl))
    return text.reshape(-1), [cands[b] for b in picks]


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

    # mixed: corridors drawn as the pipeline draws them in one call: most
    # at a chain's 2 x 24 + 2 plus a small diagonal spread, a tail to 250,
    # and a few rescue-like ones past 1024 lanes
    Nm = 16384
    owners_m = rng.integers(0, R, Nm).astype(np.int32)
    wl_m = (50 + rng.geometric(0.35, Nm) - 1).astype(np.int32)
    tail = rng.random(Nm) < 0.06
    wl_m[tail] = rng.integers(64, 251, int(tail.sum()))
    wl_m[rng.choice(Nm, 24, replace=False)] = rng.integers(1025, 1301, 24)
    wl_m[:3] = [1, 32, 33]
    lo_m = (pos[owners_m] - 24 + rng.integers(-20, 21, Nm)).astype(np.int64)
    len_m = (olens[owners_m] + wl_m + 48).astype(np.int32)
    cases["mixed"] = dict(base, **_to_dev(
        dev, owners=owners_m, win_lo=lo_m, win_len=len_m, wl=wl_m))
    small_m = wl_m <= 64
    cases["mixed_w64"] = dict(base, **_to_dev(
        dev, owners=owners_m[small_m], win_lo=lo_m[small_m],
        win_len=len_m[small_m], wl=wl_m[small_m]))

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
    # the same past 8 candidates an SM, where sw_banded16's and
    # sw_banded_packed's narrow classes take their large-call forms
    for cap in (32, 56, 64, 96):
        cases[f"edge_w{cap}_n{LARGE_CALL}"] = edge_set(
            oriented2, lens2, pos2, cap, LARGE_CALL)
    # long reads (500..1023 bp) with corridors past one warp
    R3, L3 = 128, 1023
    lens3 = rng.integers(500, L3 + 1, R3).astype(np.int32)
    lens3[:2] = [500, L3]
    oriented3, pos3 = _reads_from_text(rng, text, R3, L3, lens3)
    for cap in (2048, 4096):
        cases[f"long_w{cap}"] = edge_set(oriented3, lens3, pos3, cap, 256)
    # sw_batch picks its thread form from the longest read of the call and
    # from its size: reads of 0 bases to `top` (one of exactly `top`), at
    # sizes on both sides of its threshold, windows that run off both ends
    # of the text
    for top, Ne in SCAN_FORM_CASES:
        Rs = 256
        lens_s = rng.integers(0, top + 1, Rs).astype(np.int32)
        lens_s[:3] = [top, top, min(1, top)]
        oriented_s, pos_s = _reads_from_text(rng, text, Rs, max(top, 2),
                                             lens_s)
        cases[f"scan_rl{top}_n{Ne}"] = edge_set(oriented_s, lens_s, pos_s,
                                                48, Ne)
    # the packed tier's corridors on reads of 300..1023 bases whose first
    # 280 bases do not align, so that start rows lie past 256; an odd N
    R4, L4 = 64, 1023
    lens4 = rng.integers(300, L4 + 1, R4).astype(np.int32)
    oriented4, pos4 = _reads_from_text(rng, text, R4, L4, lens4)
    oriented4[:, :280] = rng.integers(0, 4, (R4, 280))
    cases["long_w64"] = edge_set(oriented4, lens4, pos4, 64, 1023)
    return cases


# sw_batch, sw_banded16 and sw_banded_packed take their large-call forms
# from more than 8 candidates an SM (kWarpCallPerSm, kWarpClassPerSm in
# csrc/; sw_banded's classes cross at 1 to 16 an SM, its launch table): a
# size on that side of the threshold on any card, and the threshold on a
# card of 132 SMs
LARGE_CALL = 2048
WARP_CALL_132 = 8 * 132
# (longest read, candidates) of sw_batch's thread-form cases: every form of
# its table (8 x 4, 7, 10, 13; 32 x 4, 8, 16, 24, 32 rows)
SCAN_FORM_CASES = (
    [(top, LARGE_CALL) for top in (1, 31, 56, 80, 100, 200, 250)]
    + [(1, 512), (31, 512), (100, 512), (250, 512), (512, 256), (600, 256),
       (1023, 256)])
# the cases each kernel is held to: every case but sw_batch's thread-form
# ones (None), or a list (the packed tier takes wl <= 64)
KERNEL_CASES = {
    "sw_banded": None, "sw_banded16": None, "sw_batch": "all",
    "sw_banded_packed": ("chained_w64", "odd_w64", "mixed_w64", "edge_w32",
                         "edge_w64", f"edge_w56_n{LARGE_CALL}",
                         "long_w64"),
}
# scorer -> the sets on which its kernel's thread forms (ops/sw.FORM_GROUPS)
# are held to the launch's own choice and timed against each other
FORM_CASES = {"banded": ("chained", "rescue", "mixed"),
              "scan": ("chained", "rescue"), "packed": ("chained_w64",)}
# a scoring past a signed byte, which sw_banded and sw_batch take in the
# mask form of their lookups (the JAX banded and scan scorers take any
# int32 scoring)
WIDE_SCORES = dict(SW_KW, match=200, mismatch=150)
# the tie sets' scorings are scaled by this into sw_batch's mask form: on
# their reads and windows, which hold no N, each value scales and every
# tie falls as at the original scoring
TIE_SCALE = 200
# the pipeline shape each kernel is timed at, then the extra shapes
TIMED = {"sw_banded": ("chained", "rescue", "mixed"),
         "sw_banded16": ("chained", "rescue"),
         "sw_banded_packed": ("chained_w64",),
         "sw_batch": ("chained", "rescue")}


def _call(fn, c, scorer, scoring=SW_KW):
    return fn(c["text"], c["oriented"], c["olens"], c["owners"],
              c["win_lo"], c["win_len"], c["wl"], scorer=scorer, **scoring)


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


def _planned(c, scorer, group=0, scoring=SW_KW):
    """(out, launch) of the wrapper's plan for the scorer's kernel on
    ``c``; ``group`` asks the kernel for one thread form
    (``ops/sw.FORM_GROUPS``) in place of the launch's own choice."""
    from ema_tpu_torch.ops.sw import _plan_kernel

    return _plan_kernel(c["text"], c["oriented"], c["olens"], c["owners"],
                        c["win_lo"], c["win_len"], c["wl"], scorer=scorer,
                        group=group, **scoring)


def _kernel_ms(c, scorer, reps: int, group=0, scoring=SW_KW) -> float:
    """Mean device time of the scorer's kernel launches alone on ``c``:
    the wrapper's plan (checks, the bounds' readback, the class sort) is
    made once, outside the timed window."""
    return _time_ms(_planned(c, scorer, group, scoring)[1], reps)


def _form_out(c, scorer, group, scoring=SW_KW) -> torch.Tensor:
    """The kernel's output on ``c`` at one thread form."""
    out, launch = _planned(c, scorer, group, scoring)
    launch()
    torch.cuda.synchronize()
    return out


def _cells(c, scorer) -> int:
    """DP cells a kernel computes: rl x wl for the banded kernels, rl x
    window for the whole-window scan."""
    rl = c["olens"][c["owners"].long()].long()
    width = c["win_len"] if scorer == "scan" else c["wl"]
    return int((rl * width.long()).sum())


_RATES = {}


def instr_rates(dev) -> dict:
    """The card's instruction rates: ``int32``, the peak every bound is
    stated at (SMs x max SM clock x 64, which the probe's alu form
    reaches), and ``s16x2_measured``, the packed instructions of
    sw_banded16 as the probe's s16x2 form runs them here: logged beside
    the peak, used in no bound."""
    from ema_tpu_torch.tools import bench_sw

    if not _RATES:
        rate = bench_sw.int32_instr_per_s(dev)
        rate16, per_step, ms = bench_sw.s16x2_instr_per_s(dev)
        log(f"s16x2 probe: {ms} ms, {per_step} SASS integer instructions a "
            f"chain step, {rate16 / 1e12} T packed instructions/s measured "
            f"= {rate16 / rate} of the int32 peak of {rate / 1e12} T (SMs x "
            f"max SM clock x {bench_sw.INT32_OPS_PER_CLOCK_PER_SM}), at "
            f"which sw_banded16's bound is stated")
        _RATES.update(int32=rate, s16x2_measured=rate16)
    return _RATES


def _bound(name, c, scorer, rates) -> tuple:
    """(bound ms, bound_by, cells) of kernel ``name`` on the inputs ``c``,
    at the card's peak rates: the cells these inputs need times the fewest
    instructions a cell admits (tools/bench_sw.MIN_INSTR_PER_CELL: all of
    them over the SMs' issue slots, those only the integer pipe takes over
    the int32 rate, whichever takes longer), against the bytes that must
    move (each candidate's read row and window, its index entries, its
    output row) over the memory rate."""
    from ema_tpu_torch.tools import bench_sw

    cells = _cells(c, scorer)
    N = c["owners"].shape[0]
    rl = c["olens"][c["owners"].long()].long()
    n_bytes = int(rl.sum()) + int(c["win_len"].long().sum()) + N * (20 + 16)
    every, int_pipe = bench_sw.MIN_INSTR_PER_CELL[name]
    ms, by = bench_sw.bound_ms(cells * every, cells * int_pipe, n_bytes,
                               rates["int32"])
    return ms, by, cells


def phase_kernel(dev, card: str) -> dict:
    from ema_tpu_torch.ops.sw import (FORM_GROUPS, LAUNCHES, gather_score,
                                      gather_score_ref, reset_counts)
    from ema_tpu_torch.tools import bench_sw

    rate = instr_rates(dev)
    log(f"int32 instruction rate of the card (SMs x max SM clock x "
        f"{bench_sw.INT32_OPS_PER_CLOCK_PER_SM}): {rate['int32'] / 1e12} T "
        f"instructions/s, issue slots x "
        f"{bench_sw.SCHED_SLOTS_PER_CLOCK_PER_SM}; minimum instructions a "
        f"cell (hand count, tools/bench_sw.py: all, and those only the "
        f"integer pipe takes): {bench_sw.MIN_INSTR_PER_CELL}")
    cases = sw_cases(dev)
    stats = {}
    for name, (scorer, _, _) in KERNELS.items():
        if scorer is None:
            continue                   # the probe: phase_bench_sw
        max_err = 0
        held = KERNEL_CASES[name]
        if held is None:
            held = [k for k in cases if not k.startswith("scan_")]
        for cname in (cases if held == "all" else held):
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
            if scorer == "banded":      # every form on every set
                for group in FORM_GROUPS[scorer]:
                    check(torch.equal(_form_out(c, scorer, group), want),
                          f"{name} in its form {group} disagrees with the "
                          f"plain version on {cname}")
        st = {"max_abs_err": max_err}
        for cname in TIMED[name]:
            c = cases[cname]
            bound, by, cells = _bound(name, c, scorer, rate)
            reps = 20 if cname.startswith("chained") else 10
            reset_counts()
            _call(gather_score, c, scorer)
            per_call = LAUNCHES[name].value
            ms = _time_ms(lambda: _call(gather_score, c, scorer), reps)
            launch_ms = _kernel_ms(c, scorer, reps)
            plain_ms = _time_ms(lambda: _call(gather_score_ref, c, scorer),
                                2)
            st.setdefault("ms", ms)
            st.setdefault("launch_ms", launch_ms)
            st.setdefault("plain_ms", plain_ms)
            st.setdefault("bound_ms", bound)
            st.setdefault("bound_by", by)
            log(f"{name} [{cname}] N={c['owners'].shape[0]}: wrapper call "
                f"{ms} ms in {per_call} launches, the launches alone "
                f"{launch_ms} ms ({cells / launch_ms / 1e6} Gcell/s), "
                f"plain {plain_ms} ms ({cells / plain_ms / 1e6} Gcell/s), "
                f"cells={cells}, bound {bound} ms by {by} = "
                f"{bound / launch_ms} of the launches' time, "
                f"{bound / ms} of the call's, library call: none, "
                f"card: {card}")
        stats[name] = st
    _phase_forms(cases, card)
    _phase_banded_scorings(dev, cases, card)
    stats["sw_batch"]["mask_launch_ms"] = _phase_scan_scorings(dev, cases,
                                                               card)
    _phase_wide_forms(cases, card)
    # the packed tier's shape through the one-warp banded kernel
    c = cases["chained_w64"]
    ms = _time_ms(lambda: _call(gather_score, c, "banded"), 20)
    launch_ms = _kernel_ms(c, "banded", 20)
    log(f"sw_banded [chained_w64] N={c['owners'].shape[0]}: wrapper call "
        f"{ms} ms, the launches alone {launch_ms} ms "
        f"({_cells(c, 'banded') / launch_ms / 1e6} Gcell/s), card: {card}")
    return stats


def _phase_forms(cases, card: str) -> None:
    """The thread forms of sw_banded (each class's large-call and
    small-call forms), sw_batch (8 and 32 threads a candidate) and
    sw_banded_packed (8 x 8 and 16 x 4 lanes) against each other on the
    sets of FORM_CASES (the launch's own choice is timed by the caller),
    each held to the default form's output."""
    from ema_tpu_torch.ops.sw import FORM_GROUPS, KERNEL_OF, gather_score

    for scorer, cnames in FORM_CASES.items():
        name = KERNEL_OF[scorer]
        for cname in cnames:
            c = cases[cname]
            want = _call(gather_score, c, scorer)
            row = []
            for group in FORM_GROUPS[scorer]:
                check(torch.equal(_form_out(c, scorer, group), want),
                      f"{name} at {_form_label(scorer, group)} differs on "
                      f"{cname}")
                row.append(f"{_form_label(scorer, group)} "
                           f"{_kernel_ms(c, scorer, 10, group)} ms")
            log(f"{name} thread forms [{cname}] N={c['owners'].shape[0]}, "
                f"the launch alone: " + ", ".join(row) + f"; card: {card}")


def _form_label(scorer, group) -> str:
    """What ``group`` asks of the scorer's kernel (ops/sw.FORM_GROUPS)."""
    if scorer in ("banded", "banded16"):
        return {8: "the large-call form", 32: "the small-call form"}[group]
    return f"{group} threads"


def _phase_banded_scorings(dev, cases, card: str) -> None:
    """sw_banded beyond the default scoring, in every form (the launch's
    own choice and each of FORM_GROUPS): a scoring past a signed byte
    (WIDE_SCORES, the mask form of the lookups) on the pipeline's shapes,
    the edge sets and corridors to 4096, and the tie sets (TIE_SETS,
    WARP_TIE_SET), each bit-exact against the plain version."""
    from ema_tpu_torch.ops.sw import FORM_GROUPS, gather_score_ref

    forms = (0, *FORM_GROUPS["banded"])
    for cname in ("chained", "rescue", "mixed", "edge_w64",
                  f"edge_w64_n{LARGE_CALL}", "edge_w1024", "long_w4096"):
        c = cases[cname]
        want = _call(gather_score_ref, c, "banded", WIDE_SCORES)
        for group in forms:
            check(torch.equal(_form_out(c, "banded", group, WIDE_SCORES),
                              want),
                  f"sw_banded (match {WIDE_SCORES['match']}, mismatch "
                  f"{WIDE_SCORES['mismatch']}, form {group}) differs from "
                  f"the plain version on {cname}")
        log(f"sw_banded [{cname}] N={c['owners'].shape[0]} with match "
            f"{WIDE_SCORES['match']}, mismatch {WIDE_SCORES['mismatch']} "
            f"(the mask form of the lookups): bit-exact in forms {forms}, "
            f"the launch alone {_kernel_ms(c, 'banded', 10, 0, WIDE_SCORES)}"
            f" ms against {_kernel_ms(c, 'banded', 10)} ms with byte "
            f"scores; card: {card}")
    sets = [(scoring, tie_batch(B, picks)) for scoring, B, picks in TIE_SETS]
    scoring, B, picks = WARP_TIE_SET
    sets.append((scoring, warp_tie_batch(B, picks)))
    for k, (scoring, (text, cands)) in enumerate(sets):
        c = _to_dev(dev, **cand_inputs(text, cands))
        want = _call(gather_score_ref, c, "banded", scoring)
        for group in forms:
            check(torch.equal(_form_out(c, "banded", group, scoring), want),
                  f"sw_banded (form {group}) breaks a tie rule of set {k}")
        log(f"sw_banded on tie set {k} ({len(cands)} candidates, {scoring})"
            f": bit-exact in forms {forms}")


def _phase_scan_scorings(dev, cases, card: str) -> float:
    """sw_batch beyond the default scoring: in the mask form of its lookup
    (WIDE_SCORES) on every one of its kernel sets in every thread form
    (the launch's own choice and each of FORM_GROUPS), and on the tie
    sets at every score times TIE_SCALE, where it must pick the byte
    form's cells; each bit-exact against the plain version.  The launches
    alone are timed in the mask and the byte form on the sets sw_batch is
    timed at; returns the mask form's time on the first of them."""
    from ema_tpu_torch.ops.sw import FORM_GROUPS, gather_score_ref

    forms = (0, *FORM_GROUPS["scan"])
    for cname, c in cases.items():
        want = _call(gather_score_ref, c, "scan", WIDE_SCORES)
        for group in forms:
            check(torch.equal(_form_out(c, "scan", group, WIDE_SCORES),
                              want),
                  f"sw_batch (match {WIDE_SCORES['match']}, mismatch "
                  f"{WIDE_SCORES['mismatch']}, form {group}) differs from "
                  f"the plain version on {cname}")
    log(f"sw_batch with match {WIDE_SCORES['match']}, mismatch "
        f"{WIDE_SCORES['mismatch']} (the mask form of the lookup): "
        f"bit-exact in forms {forms} on all {len(cases)} sets")
    sets = [(scoring, tie_batch(B, picks)) for scoring, B, picks in TIE_SETS]
    for k, (scoring, (text, cands)) in enumerate(sets):
        c = _to_dev(dev, **cand_inputs(text, cands))
        wide = {key: v * TIE_SCALE for key, v in scoring.items()}
        byte = _call(gather_score_ref, c, "scan", scoring)
        want = _call(gather_score_ref, c, "scan", wide)
        check(torch.equal(want[:, 1:], byte[:, 1:])
              and torch.equal(want[:, 0], byte[:, 0] * TIE_SCALE),
              f"the plain scan at {TIE_SCALE} x the scores of tie set {k} "
              f"picks other cells")
        for group in forms:
            check(torch.equal(_form_out(c, "scan", group, wide), want),
                  f"sw_batch (mask form {group}) breaks a tie rule of set "
                  f"{k}")
        log(f"sw_batch on tie set {k} ({len(cands)} candidates, {wide}): "
            f"the mask form bit-exact in forms {forms}, the byte form's "
            f"cells")
    mask_ms = None
    for cname in TIMED["sw_batch"]:
        c = cases[cname]
        ms = _kernel_ms(c, "scan", 10, 0, WIDE_SCORES)
        mask_ms = mask_ms if mask_ms is not None else ms
        log(f"sw_batch [{cname}] N={c['owners'].shape[0]}, the launch "
            f"alone: mask form (match {WIDE_SCORES['match']}, mismatch "
            f"{WIDE_SCORES['mismatch']}) {ms} ms against "
            f"{_kernel_ms(c, 'scan', 10)} ms in the byte form; card: {card}")
    return mask_ms


def _phase_wide_forms(cases, card: str) -> None:
    """Where the large-call and small-call forms of sw_banded's classes
    of 256 to 1024 lanes cross: the rescue set's candidates with window
    and corridor cut to 200, 450, 683 and 1000 lanes, at call sizes from
    one candidate to 8,192, each form held to the other and, on the
    whole call, to the plain version."""
    from ema_tpu_torch.ops.sw import gather_score_ref

    r = cases["rescue"]
    for width in (200, 450, 683, 1000):
        full = dict(r, win_len=torch.full_like(r["win_len"], width),
                    wl=torch.full_like(r["wl"], width))
        want = _call(gather_score_ref, full, "banded")
        row = []
        for n in (1, 2, 8, 33, 132, 264, 528, WARP_CALL_132,
                  WARP_CALL_132 + 1, 2112, 8192):
            c = dict(full, owners=full["owners"][:n],
                     win_lo=full["win_lo"][:n], win_len=full["win_len"][:n],
                     wl=full["wl"][:n])
            times = []
            for group in (8, 32):
                check(torch.equal(_form_out(c, "banded", group), want[:n]),
                      f"sw_banded [wl = {width}, N={n}, form {group}] "
                      f"differs from the plain version")
                times.append(_kernel_ms(c, "banded", 10, group))
            row.append(f"N={n} {times[0]} / {times[1]} ms")
        log(f"sw_banded [rescue set, wl = {width}] the launch alone in the "
            f"large-call / small-call form: " + ", ".join(row)
            + f"; card: {card}")


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
    runs = [(sw_impl, dict(sw_impl=sw_impl), kernel)
            for sw_impl, kernel in MAIN_KERNEL.items()]
    runs += [(label, kw, "sw_banded") for label, kw in (
        ("device_em", dict(device_em=True)),
        ("host_em", dict(device_em=False)),
        ("seed_device", dict(seed_impl="device")))]
    for label, kw, kernel in runs:
        reset_counts()
        got = golden_sam(dev, **kw)
        launches = _launched()
        n_rec = sum(1 for ln in got.splitlines() if not ln.startswith("@"))
        log(f"golden [{label}]: {n_rec} records, identical={got == want}, "
            f"launches={launches}")
        check(got == want, f"golden SAM under {label} differs from "
                           f"tests/golden/expected.sam")
        check(launches[kernel] > 0,
              f"golden run under {label} never launched {kernel}")
    greedy = {impl: golden_sam(dev, seeding="greedy", seed_impl=impl)
              for impl in ("native", "device")}
    log(f"golden [greedy]: device seeding identical to host seeding="
        f"{greedy['device'] == greedy['native']}")
    check(greedy["device"] == greedy["native"],
          "greedy seeding on the device gives another SAM than on the host")


def _recording(aligner, captured):
    """Wrap aligner._score_windows to keep the inputs and output of its
    first chained call and of its first rescue call (the corridor is the
    whole window there): one real chunk of the main path each.  Under
    the banded scorer ``captured["launches"]`` counts sw_banded's
    launches by kind of call, from the class plan of each call that
    scores (a call past SW_CHUNK only splits itself)."""
    from ema_tpu_torch.core.pipeline import SW_CHUNK
    from ema_tpu_torch.ops.sw import plan_class_launches

    score_windows = aligner._score_windows
    lock = threading.Lock()
    split = captured.setdefault("launches", {"chained": 0, "rescue": 0})

    def recording(oriented_dev, olens_dev, owners, win_lo, win_len,
                  wl=None, **kw):
        out = score_windows(oriented_dev, olens_dev, owners, win_lo,
                            win_len, wl=wl, **kw)
        kind = ("rescue" if wl is None or np.array_equal(wl, win_len)
                else "chained")
        # chunks score on worker threads: one atomic setdefault each
        captured.setdefault(kind, dict(
            oriented_dev=oriented_dev, olens_dev=olens_dev, owners=owners,
            win_lo=win_lo, win_len=win_len, wl=wl, out=out))
        if aligner.sw_impl == "banded" and 0 < len(owners) <= SW_CHUNK:
            w = torch.from_numpy(np.maximum(
                wl if wl is not None else win_len, 1).astype(np.int32))
            _, spans = plan_class_launches(w, int(w.min()), int(w.max()))
            with lock:
                split[kind] += len(spans)
        return out
    return recording


def _main_run(dev, card, idx, pairs, truth, sw_impl, metrics=False,
              label=None, cfg_kw=None, seed_impl=None):
    """One configuration on the bench world: a warm-up pass (recording
    one chained and one rescue SW call), then 3 timed passes; returns
    (lines, stats, captured).
    stats: launches of the scorer's kernel over the 4 passes, pairs/s of
    the best pass, the pass times and (``metrics``) each stage's
    thread-seconds per timed pass."""
    from ema_tpu_torch import config
    from ema_tpu_torch.utils.metrics import Metrics
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.ops.sw import reset_counts

    label = label or sw_impl
    n_pairs = len(pairs[0])
    aligner = Aligner(idx, config.RunConfig(**(cfg_kw or {})), device=dev,
                      sw_impl=sw_impl, seed_impl=seed_impl)

    def run() -> list:
        return aligner.align_batch_to_sam(ReadBatch.from_pairs(*pairs))

    captured = {}
    reset_counts()
    aligner._score_windows = _recording(aligner, captured)
    torch.cuda.reset_peak_memory_stats(dev)
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
    peak = torch.cuda.max_memory_allocated(dev)
    if sw_impl == "banded":
        log(f"main path [{label}]: sw_banded launches of the warm-up pass "
            f"by kind of call: {captured['launches']}")
    log(f"main path [{label}]: device_em={aligner.cfg.device_em}, "
        f"seed_impl={aligner.seed_impl}, warm-up pass {warm} s, timed "
        f"passes {passes} s, {n_pairs / best} pairs/s (best pass), "
        f"{len(lines)} SAM records, launches over 4 passes={launches}, "
        f"peak device memory over the 4 passes {peak} bytes = "
        f"{peak / 2**20} MiB (torch.cuda.max_memory_allocated, the index "
        f"and the aligner's buffers included), card: {card}")
    stages = {}
    if met is not None:
        log("stage split, thread-seconds summed over the 3 timed passes:")
        for name in sorted(met.wall):
            log(f"  {name}: {met.wall[name]} s n={met.items.get(name, 0)}")
            stages[name] = met.wall[name] / 3
    ok, n = truth_share(lines, pairs[0], truth)
    log(f"accuracy [{label}]: {ok}/{n} = {ok / max(n, 1)} mapped primary "
        f"records within +-5 bp of truth")
    kernel = MAIN_KERNEL[sw_impl]
    check(launches[kernel] > 0,
          f"main path under {label} never launched {kernel}")
    check(n >= n_pairs and ok / n >= 0.98,
          f"accuracy gate failed under {label} ({ok}/{n})")
    check("chained" in captured and "rescue" in captured,
          f"SW calls recorded: {sorted(captured)}, not chained and rescue")
    return lines, dict(launches=launches[kernel], pairs_per_s=n_pairs / best,
                       passes=passes, stages=stages,
                       device_em=aligner.cfg.device_em), captured


def phase_main_path(dev, card: str, idx, pairs, truth) -> tuple:
    """The bench world under each scorer; returns (stats by scorer, the
    default run's SAM lines)."""
    from ema_tpu_torch import native
    from ema_tpu_torch.core.samout import write_sam_header
    from ema_tpu_torch.ops.sw import gather_score_ref
    from ema_tpu_torch.utils.samcheck import check_sam

    stats = {}
    lines, stats["banded"], recorded = _main_run(
        dev, card, idx, pairs, truth, "banded", metrics=True)
    header = write_sam_header(idx.names, idx.lengths, None, "smoke", "smoke")
    faults = check_sam(header.splitlines(keepends=True) + lines)
    log(f"check_sam over the bench world's default SAM: {len(lines)} "
        f"records, {len(faults)} faults {faults[:3]}")
    check(not faults, f"check_sam: {len(faults)} faults in the bench "
                      f"world's SAM: {faults[:3]}")
    c = recorded["chained"]
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
    c = c["chained"]
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
    _scan_wide_main_path(dev, card, idx, pairs)
    return stats, lines, recorded


def _scan_wide_main_path(dev, card: str, idx, pairs) -> None:
    """The bench world under WIDE_SCORES with the scan scorer (sw_batch's
    mask form) and the banded scorer (sw_banded's): one pass each, the
    same SAM records."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.ops.sw import reset_counts

    cfg = config.RunConfig(aligner=config.AlignerParams(
        match=WIDE_SCORES["match"], mismatch=WIDE_SCORES["mismatch"]))
    got = {}
    for sw_impl in ("banded", "scan"):
        reset_counts()
        t0 = time.time()
        got[sw_impl] = Aligner(idx, cfg, device=dev, sw_impl=sw_impl
                               ).align_batch_to_sam(ReadBatch.from_pairs(
                                   *pairs))
        torch.cuda.synchronize()
        launched = _launched()[MAIN_KERNEL[sw_impl]]
        log(f"main path [{sw_impl}, match {WIDE_SCORES['match']}, mismatch "
            f"{WIDE_SCORES['mismatch']}]: one pass (the Aligner's first, "
            f"warm-up included) {time.time() - t0} s, "
            f"{len(got[sw_impl])} SAM records, {MAIN_KERNEL[sw_impl]} "
            f"launched {launched} times, card: {card}")
        check(launched > 0, f"{sw_impl} at match {WIDE_SCORES['match']} "
                            f"never launched {MAIN_KERNEL[sw_impl]}")
    n_diff = sum(a != b for a, b in zip(got["banded"], got["scan"]))
    log(f"main path at match {WIDE_SCORES['match']}: scan against banded, "
        f"{n_diff} records differ")
    check(got["scan"] == got["banded"],
          f"scan and banded differ at match {WIDE_SCORES['match']}")


def phase_recorded(dev, card: str, idx, recorded) -> None:
    """Every SW kernel on the default run's recorded chained and rescue
    calls, the shapes the pipeline really sends: cells, ms, Gcell/s and
    the share of the bound; the banded kernels must reproduce the
    recorded output."""
    from ema_tpu_torch.ops.sw import (FORM_GROUPS, LAUNCHES, PACKED_MAX_WL,
                                      gather_score, reset_counts)
    rate = instr_rates(dev)
    text = torch.from_numpy(idx.text).to(dev)
    for kind in ("chained", "rescue"):
        r = recorded[kind]
        wl = np.maximum(r["wl"] if r["wl"] is not None else r["win_len"], 1)
        want = np.stack([r["out"][k] for k in ("score", "qb", "qe",
                                               "ref_end")], axis=1)
        edges = (32, 64, 128, 256, 1024)
        hist = {f"<={e}": int((wl <= e).sum()) for e in edges}
        log(f"recorded {kind} call: N={wl.shape[0]}, wl min/median/mean/max "
            f"{int(wl.min())}/{float(np.median(wl))}/{float(wl.mean())}/"
            f"{int(wl.max())}, cumulative {hist}")
        for name, (scorer, _, _) in KERNELS.items():
            if scorer is None:
                continue
            keep = np.arange(wl.shape[0])
            if scorer == "packed":
                keep = np.nonzero(wl <= PACKED_MAX_WL)[0]
                if keep.shape[0] == 0:
                    log(f"{name} [recorded {kind}]: not applicable, every "
                        f"corridor is wider than {PACKED_MAX_WL}")
                    continue
            c = dict(text=text, oriented=r["oriented_dev"],
                     olens=r["olens_dev"], **_to_dev(
                         dev, owners=r["owners"][keep].astype(np.int32),
                         win_lo=r["win_lo"][keep].astype(np.int64),
                         win_len=r["win_len"][keep].astype(np.int32),
                         wl=wl[keep].astype(np.int32)))
            reset_counts()
            got = _call(gather_score, c, scorer).cpu().numpy()
            per_call = LAUNCHES[name].value
            if scorer != "scan":          # scan scores the whole window
                check(np.array_equal(got, want[keep]),
                      f"{name} differs from the recorded {kind} output")
            bound, by, cells = _bound(name, c, scorer, rate)
            ms = _time_ms(lambda: _call(gather_score, c, scorer), 20)
            launch_ms = _kernel_ms(c, scorer, 20)
            forms = []
            if scorer == "scan":
                forms.append(f"mask form (match {WIDE_SCORES['match']}, "
                             f"mismatch {WIDE_SCORES['mismatch']}) "
                             f"{_kernel_ms(c, scorer, 20, 0, WIDE_SCORES)}"
                             f" ms")
            for group in FORM_GROUPS.get(scorer, ()):
                if scorer != "scan":
                    check(np.array_equal(_form_out(c, scorer, group).cpu()
                                         .numpy(), want[keep]),
                          f"{name} in {_form_label(scorer, group)} differs "
                          f"from the recorded {kind} output")
                forms.append(f"{_form_label(scorer, group)} "
                             f"{_kernel_ms(c, scorer, 20, group)} ms")
            log(f"{name} [recorded {kind}] N={keep.shape[0]}: wrapper call "
                f"{ms} ms in {per_call} launches, the launches alone "
                f"{launch_ms} ms ({cells / launch_ms / 1e6} Gcell/s; "
                + ", ".join(forms) + f"), cells={cells}, bound {bound} ms "
                f"by {by} = {bound / launch_ms} of the launches' time, "
                f"{bound / ms} of the call's, card: {card}")
    _phase_class_rules(dev, card, text, recorded["chained"], rate)


def _phase_class_rules(dev, card: str, text, r, rate) -> None:
    """sw_banded's two launch rules, on the recorded chained call with
    other corridors.  Real reads with small indels widen a chain's
    corridor past the simulator's 50: the call is timed with wl drawn in
    50..60 (one class, never sorted), in 50..70 (two classes; the default
    plan against a forced sort and a forced single launch) and with a 6%
    tail to 250 (the same three).  Then a wl = 50 call on both sides of
    the size from which a class takes its large-call form, with each form
    of sw_banded, sw_banded16 and sw_banded_packed timed on it.  Every
    variant is held bit-exact against the plain version."""
    from ema_tpu_torch.ops import sw
    from ema_tpu_torch.ops.sw import gather_score, gather_score_ref

    rng = np.random.default_rng(11)
    N = r["owners"].shape[0]
    base = dict(text=text, oriented=r["oriented_dev"], olens=r["olens_dev"])

    def call_with(wl, keep=slice(None)):
        wl = wl.astype(np.int32)
        grow = wl - np.maximum(r["wl"][keep], 1)
        return dict(base, **_to_dev(
            dev, owners=r["owners"][keep].astype(np.int32),
            win_lo=r["win_lo"][keep].astype(np.int64),
            win_len=(r["win_len"][keep] + grow).astype(np.int32), wl=wl))

    tail = rng.integers(50, 61, N)
    far = rng.random(N) < 0.06
    tail[far] = rng.integers(64, 251, int(far.sum()))
    sets = {"wl 50..60": rng.integers(50, 61, N),
            "wl 50..70": rng.integers(50, 71, N),
            "wl 50..60, 6% to 250": tail}
    default = sw.SORT_PAYS_SLOTS
    try:
        for label, wl in sets.items():
            c = call_with(wl)
            want = _call(gather_score_ref, c, "banded")
            row = []
            for plan, pays in (("default", default), ("sorted", 0),
                               ("one launch", 1 << 62)):
                sw.SORT_PAYS_SLOTS = pays
                sw.reset_counts()
                got = _call(gather_score, c, "banded")
                per_call = sw.LAUNCHES["sw_banded"].value
                check(torch.equal(got, want), f"sw_banded [{label}, {plan}] "
                      f"differs from the plain version")
                ms = _time_ms(lambda: _call(gather_score, c, "banded"), 20)
                row.append(f"{plan} {ms} ms in {per_call} launches")
            bound, by, cells = _bound("sw_banded", c, "banded", rate)
            log(f"sw_banded [recorded chained, {label}] N={N}: "
                + "; ".join(row) + f"; cells={cells}, bound {bound} ms by "
                f"{by}, card: {card}")
    finally:
        sw.SORT_PAYS_SLOTS = default
    for name, scorer in (("sw_banded", "banded"),
                         ("sw_banded16", "banded16"),
                         ("sw_banded_packed", "packed")):
        for n in (132, 264, 512, 1024, WARP_CALL_132, WARP_CALL_132 + 1,
                  1536, 12 * 132, 12 * 132 + 1, 2048, 4096, 8192):
            keep = np.arange(min(n, N))
            c = call_with(np.full(keep.shape[0], 50), keep)
            check(torch.equal(_call(gather_score, c, scorer),
                              _call(gather_score_ref, c, scorer)),
                  f"{name} [wl = 50, N={n}] differs from the plain version")
            bound, by, cells = _bound(name, c, scorer, rate)
            ms = _time_ms(lambda: _call(gather_score, c, scorer), 20)
            row = [f"wrapper call {ms} ms",
                   f"the launch alone {_kernel_ms(c, scorer, 20)} ms"]
            row += [f"in {_form_label(scorer, group)} "
                    f"{_kernel_ms(c, scorer, 20, group)} ms"
                    for group in sw.FORM_GROUPS.get(scorer, ())]
            log(f"{name} [wl = 50] N={keep.shape[0]}: " + ", ".join(row)
                + f"; cells={cells}, bound {bound} ms by {by}, card: {card}")
    # sw_batch's two group widths on the recorded call, on both sides of
    # its size threshold
    for n in sorted({1, 256, 512, 1024, WARP_CALL_132, WARP_CALL_132 + 1,
                     1536, 2048, 4096, N}):
        keep = np.arange(min(n, N))
        c = call_with(np.maximum(r["wl"][keep], 1), keep)
        want = _call(gather_score_ref, c, "scan")
        check(torch.equal(_call(gather_score, c, "scan"), want),
              f"sw_batch [recorded chained, N={n}] differs from the plain "
              f"version")
        ms = _time_ms(lambda: _call(gather_score, c, "scan"), 20)
        row = [f"wrapper call {ms} ms",
               f"the launch alone {_kernel_ms(c, 'scan', 20)} ms"]
        for group in (8, 32):
            check(torch.equal(_form_out(c, "scan", group), want),
                  f"sw_batch at {group} threads differs (N={n})")
            row.append(f"on {group} threads "
                       f"{_kernel_ms(c, 'scan', 20, group)} ms")
        bound, by, cells = _bound("sw_batch", c, "scan", rate)
        log(f"sw_batch [recorded chained] N={keep.shape[0]}: "
            + ", ".join(row) + f"; cells={cells}, bound {bound} ms by {by}, "
            f"card: {card}")


def phase_device_em(dev, card: str, idx, pairs, truth,
                    default_lines) -> dict:
    """Device EM on and off in turns (on, off, off, on) on the bench
    world: pairs/s medians over the 6 timed passes of each, the em
    stage's thread-seconds per pass, and 0 differing records."""
    from ema_tpu_torch.core.pipeline import resolve_device_em

    n_pairs = len(pairs[0])
    runs, first = {True: [], False: []}, {}
    for dem in (True, False, False, True):
        lines, st, _ = _main_run(dev, card, idx, pairs, truth, "banded",
                                 metrics=True, label=f"device_em={dem}",
                                 cfg_kw=dict(device_em=dem))
        check(st["device_em"] == dem, "RunConfig(device_em) was not kept")
        runs[dem].append(st)
        check(lines == first.setdefault(dem, lines),
              f"two runs with device_em={dem} gave different records")
    on, off = first[True], first[False]
    n_diff = sum(a != b for a, b in zip(on, off)) + abs(len(on) - len(off))
    out = {}
    for dem, stage in ((True, "em[device]"), (False, "em[host]")):
        rates = [n_pairs / t for st in runs[dem] for t in st["passes"]]
        em_s = [st["stages"].get(stage, 0.0) for st in runs[dem]]
        emit_s = [st["stages"].get("select+emit[host]", 0.0)
                  for st in runs[dem]]
        out[dem] = dict(median=statistics.median(rates), em_s=em_s)
        names = sorted({k for st in runs[dem] for k in st["stages"]})
        log(f"stage table, device_em={dem}, thread-seconds per pass (mean "
            f"of the 3 timed passes of each of {len(runs[dem])} runs): "
            + ", ".join(f"{k} {[st['stages'].get(k, 0.0) for st in runs[dem]]}"
                        for k in names))
        log(f"in turns, device_em={dem}: median {out[dem]['median']} "
            f"pairs/s over {len(rates)} passes {sorted(rates)}, {stage} "
            f"thread-s per pass {em_s}, select+emit[host] {emit_s}, "
            f"card: {card}")
    log(f"device EM vs host EM: {n_diff} of {len(on)} SAM records differ; "
        f"auto device_em on this card resolves to "
        f"{resolve_device_em(None, dev)}")
    check(n_diff == 0, f"{n_diff} SAM records differ between device and "
                       f"host EM")
    check(on == default_lines, "device EM records differ from the default")
    return out


def _merge(iv) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _span(iv) -> float:
    return sum(b - a for a, b in iv)


def _intersect(x, y) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        tot += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return tot


def phase_profile(dev, card: str, idx, pairs) -> float:
    """One default bench-world pass under torch.profiler: the device's
    busy time by stream and its idle share, and how long the EM's side
    stream ran while the SW kernels' stream was busy."""
    from torch.profiler import ProfilerActivity, profile

    from ema_tpu_torch import config
    from ema_tpu_torch.ops.sw import KERNEL_SYMBOL
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner

    from ema_tpu_torch.core import pipeline as tp

    aligner = Aligner(idx, config.RunConfig(), device=dev)
    batch = ReadBatch.from_pairs(*pairs)
    aligner.align_batch_to_sam(batch)
    torch.cuda.synchronize()
    em_batches = []               # EM-gated groups of each emit batch
    dispatch = tp.dispatch_em_batch

    def counting(states, *a, **kw):
        em_batches.append(sum(1 for st in states if st.needs_em))
        return dispatch(states, *a, **kw)

    tp.dispatch_em_batch = counting
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            aligner.align_batch_to_sam(batch)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        tp.dispatch_em_batch = dispatch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(events, "the profiler saw no device activity")
    streams, sw_streams = {}, set()
    for e in events:
        st = e.get("args", {}).get("stream")
        streams.setdefault(st, []).append((e["ts"], e["ts"] + e["dur"]))
        if any(k in e["name"] for k in KERNEL_SYMBOL.values()):
            sw_streams.add(st)
    merged = {st: _merge(iv) for st, iv in streams.items()}
    busy = _span(_merge([x for iv in streams.values() for x in iv])) / 1e6
    sw = _merge([x for st in sw_streams for x in merged[st]])
    other = _merge([x for st in streams if st not in sw_streams
                    for x in merged[st]])
    for st, iv in sorted(merged.items(), key=lambda kv: str(kv[0])):
        log(f"profile: stream {st} ({'SW' if st in sw_streams else 'other'}"
            f"): {len(streams[st])} device events, busy "
            f"{_span(iv) / 1e3} ms")
    # the EM's launches: every device event (kernel, copy, memset) on a
    # stream that runs no SW kernel, which is the EM's side stream
    em_events = [e for e in events
                 if e.get("args", {}).get("stream") not in sw_streams]
    by_cat = {cat: sum(e["cat"] == cat for e in em_events)
              for cat in ("kernel", "gpu_memcpy", "gpu_memset")}
    n_b = max(len(em_batches), 1)
    log(f"profile: EM launches in one pass: {len(em_events)} device events "
        f"on the EM's stream ({by_cat}) in {len(em_batches)} emit batches "
        f"of {em_batches} EM-gated groups = {len(em_events) / n_b} per emit "
        f"batch; the SW streams carry {len(events) - len(em_events)} "
        f"events")
    check(aligner.cfg.device_em and em_events,
          "the profiled pass ran no device EM")
    idle = 1.0 - busy / wall
    log(f"profile [device_em={aligner.cfg.device_em}]: pass {wall} s, "
        f"device busy {busy * 1e3} ms, idle share {idle}; the other "
        f"streams ran {_intersect(sw, other) / 1e3} ms of their "
        f"{_span(other) / 1e3} ms while an SW stream was busy; card: "
        f"{card}")
    check(sw_streams, "the profiled pass launched no SW kernel")
    return idle


def phase_seed_device(dev, card: str, idx, pairs, truth,
                      default_lines) -> None:
    """The bench world with SMEM seeding and device locate, which must
    give the default's records (the same number of passes, so the same
    MI ids)."""
    lines, st, _ = _main_run(dev, card, idx, pairs, truth, "banded",
                             metrics=True, label="seed_impl=device",
                             seed_impl="device")
    log(f"main path [seed_impl=device]: identical to the default="
        f"{lines == default_lines}")
    check(st["stages"].get("locate[device]", 0) > 0, "no device locate ran")
    check(lines == default_lines,
          "device locate gives other records than the default")


def _chunk(pairs, n_pairs: int = 4096):
    """The reads of the bench world's first chunk in the pipeline's
    barcode order: (codes uint8 [2P, L], lens int32 [2P])."""
    from ema_tpu_torch.core.batch import ReadBatch

    order = np.argsort(np.asarray(pairs[1]), kind="stable")[:n_pairs]
    b = ReadBatch.from_pairs(*([x[i] for i in order] for x in pairs))
    return b.codes, np.ascontiguousarray(b.lens, np.int32)


def _host_ms(fn, reps: int = 3) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_fm(dev, card: str, genome, idx, pairs) -> None:
    """The torch FM ops on the card against the native host ops, bit for
    bit, on one bench-world chunk, at sa_rate 2 (the bench index) and 4."""
    from ema_tpu_torch import config, native
    from ema_tpu_torch.index import build_index
    from ema_tpu_torch.core.pipeline import _compact_seed_hits, locate_rows
    from ema_tpu_torch.index import fm

    p = config.AlignerParams()
    codes, lens = _chunk(pairs)
    codes_dev = torch.from_numpy(codes).to(dev)
    lens_dev = torch.from_numpy(lens).to(dev)
    for ix in (idx, build_index({"chr1": genome}, sa_rate=4)):
        tag = f"fm [sa_rate {ix.sa_rate}]"
        fma = fm.FMIndexArrays.from_index(ix, dev)
        # locate of the chunk's real SMEM hit rows
        sm = native.smem_seed_batch(
            ix.occ_blocks, ix.counts, ix.primary, ix.fm_n, codes, lens,
            min_seed_len=p.min_seed_len,
            split_len=int(p.min_seed_len * 1.5 + 0.499),
            split_width=p.split_width, max_mem_intv=p.max_mem_intv)
        rows = _compact_seed_hits(sm[:4], sm[4], p.max_hits_per_seed)[3]
        want = native.locate_batch(ix, rows)
        got = locate_rows(fma, rows)
        check(np.array_equal(got, want),
              f"{tag}: device locate differs from native.locate_batch")
        rows_dev = torch.from_numpy(rows).to(dev)
        dev_ms = _time_ms(lambda: fm.locate(fma, rows_dev), 10)
        e2e_ms = _host_ms(lambda: locate_rows(fma, rows))
        nat_ms = _host_ms(lambda: native.locate_batch(ix, rows))
        log(f"{tag}: locate of {rows.shape[0]} hit rows identical; device "
            f"{dev_ms} ms (CUDA events), {e2e_ms} ms with upload and "
            f"readback; native locate_batch {nat_ms} ms; card: {card}")

        # greedy seeding of the chunk's reads
        sd = [a.cpu().numpy() for a in fm.seed_reads(
            fma, codes_dev, lens_dev, max_seeds=16,
            min_seed_len=p.seed_len)]
        host = native.greedy_seed_batch(
            ix.occ_blocks, ix.counts, ix.primary, ix.fm_n, codes, lens,
            min_seed_len=p.seed_len, max_seeds=16)
        live = np.arange(16)[None, :] < host[4][:, None]
        same = np.array_equal(sd[4], host[4]) and all(
            np.array_equal(np.where(live, a, 0), np.where(live, b, 0))
            for a, b in zip(sd[:4], host[:4]))
        log(f"{tag}: greedy seeds of {codes.shape[0]} reads "
            f"({int(host[4].sum())} seeds) identical={same}")
        check(same, f"{tag}: seed_reads differs from greedy_seed_batch")

        # fused seed+locate against host compaction + native locate
        budget = 4 * codes.shape[0]

        def fused():
            return fm.seed_locate_reads(
                fma, codes_dev, lens_dev, max_seeds=16,
                min_seed_len=p.seed_len, max_hits=p.max_hits_per_seed,
                budget=budget, max_occ=p.max_occ)

        def two_step():
            h = native.greedy_seed_batch(
                ix.occ_blocks, ix.counts, ix.primary, ix.fm_n, codes, lens,
                min_seed_len=p.seed_len, max_seeds=16)
            o, q, sl, r = _compact_seed_hits(h[:4], h[4],
                                             p.max_hits_per_seed)
            return o, q, sl, native.locate_batch(ix, r)

        packed, total, frd = fused()
        total = int(total)
        want = two_step()
        check(total == want[0].shape[0] and total <= budget,
              f"{tag}: {total} fused hits against {want[0].shape[0]}")
        ph = packed[:, :total].cpu().numpy()
        s_w = np.where(live, host[1] - host[0], 0)
        frac = np.minimum(np.where(s_w > p.max_occ, host[3], 0).sum(axis=1)
                          / np.maximum(lens, 1), 1.0).astype(np.float32)
        same = (all(np.array_equal(ph[i], want[i]) for i in range(4))
                and np.array_equal(frd.cpu().numpy(), frac))
        fused_ms = _host_ms(lambda: int(fused()[1]))
        host_ms = _host_ms(two_step)
        log(f"{tag}: seed+locate of {total} hits identical={same}; device "
            f"{fused_ms} ms, native greedy + compaction + locate "
            f"{host_ms} ms; card: {card}")
        check(same, f"{tag}: seed_locate_reads differs from the host path")


def deep_em_group(n_cand: int = 80, n_anchor: int = 40, bc: int = 9):
    """The group of tests/test_em_jax.py:140, cut to ``n_cand``
    candidates per mate (past EM_NATIVE_C = 64): anchor pairs in one
    cloud and one pair whose candidates lie 1 Mb apart.  Returns
    (records, idents)."""
    from ema_tpu_torch.core.records import empty_records

    rows, idents = [], []
    for p in range(n_anchor):
        for mate in (0, 1):
            rows.append((p, mate, 1000 + 60 * p + 200 * mate, mate, -1.0))
            idents.append(f"a{p}")
    for mate in (0, 1):
        for c in range(n_cand):
            rows.append((n_anchor, mate, 1500 + 200 * mate + c * 1_000_000,
                         mate, -1.0 - 0.01 * c))
            idents.append("deep")
    recs = empty_records(len(rows))
    for i, (p, mate, pos, rev, score) in enumerate(rows):
        recs["pair"][i], recs["mate"][i], recs["pos"][i] = p, mate, pos
        recs["rev"][i], recs["score"][i], recs["bc"][i] = rev, score, bc
    return recs, np.array(idents, dtype=object)


def _copy_states(states):
    import dataclasses
    return [dataclasses.replace(st, gammas=st.gammas.copy(),
                                weights=st.weights.copy()) for st in states]


def synthetic_em_group(rng, n_pairs: int, bc: int = 42):
    """A barcode group with clouds, mates and multimaps, built as
    tests/test_em_jax.py:_synthetic_group builds one: pairs in four
    clusters, 1-3 candidates per mate (the extra ones up to 2 Mb away),
    random strands and scores.  Returns (records, idents)."""
    from ema_tpu_torch.core.records import empty_records

    rows, idents = [], []
    base_positions = rng.integers(1, 5, 4).cumsum() * 100_000
    for p in range(n_pairs):
        cluster = int(rng.integers(0, len(base_positions)))
        anchor = int(base_positions[cluster]) + int(rng.integers(0, 20_000))
        for mate in (0, 1):
            for c in range(int(rng.integers(1, 4))):
                pos = anchor + (200 if mate else 0) + c * int(
                    rng.integers(0, 2_000_000, 1)[0] if c else 0)
                rows.append((p, mate, max(pos, 1), int(rng.integers(0, 2)),
                             -float(rng.random() * 8)))
                idents.append(f"r{p}")
    recs = empty_records(len(rows))
    for i, (p, mate, pos, rev, score) in enumerate(rows):
        recs["pair"][i], recs["mate"][i], recs["pos"][i] = p, mate, pos
        recs["rev"][i], recs["score"][i], recs["bc"][i] = rev, score, bc
    return recs, np.array(idents, dtype=object)


def _device_events(fn, reps: int):
    """The device events (kernels, copies, memsets) of ``reps`` runs of
    ``fn`` under torch.profiler, as (name, microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(e["name"], e["dur"]) for e in trace.get("traceEvents", [])
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def phase_em(dev, card: str, idx, pairs) -> None:
    """The cloud-EM kernel (csrc/em_cloud.cu) through dispatch_em_batch on
    the card against its plain version (em_run on the flat pack, on the
    CPU), the host EM (numpy batch) and the native flat EM, on the groups
    of one bench-world emit batch (captured before their EM ran) and on
    synthetic batches of multimapping groups for a 10x and a many-clouds
    (tru) platform; each batch also holds a group deeper than 64
    candidates, and each synthetic batch one group too large for the
    kernel's shared memory.  Two runs give the same bits, and each
    dispatch launches the kernel once.  On the bench batch the kernel's
    device time is logged beside em_run's eager chain on the card."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core import groups
    from ema_tpu_torch.core import em
    from ema_tpu_torch.core import pipeline as tp
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.ops import _build, em_cloud

    _build.load_library("em_cloud")
    fns = ptxas_functions(_build.ptxas_log("em_cloud"))
    log(f"ptxas em_cloud: {fns} (function, registers, spill stores)")
    captured = []
    dispatch = tp.dispatch_em_batch

    def recording(states, *a, **kw):
        if not captured:
            captured.extend(_copy_states(states))
        return dispatch(states, *a, **kw)

    tp.dispatch_em_batch = recording
    try:
        tp.Aligner(idx, config.RunConfig(device_em=True), device=dev
                   ).align_batch_to_sam(ReadBatch.from_pairs(*pairs))
    finally:
        tp.dispatch_em_batch = dispatch
    rng = np.random.default_rng(7)
    batches = {"bench": captured}
    for platform in ("10x", "tru"):
        profile = config.get_platform_profile(platform)
        batches[platform] = [groups.sweep_group(
            *synthetic_em_group(rng, n, bc=i), profile, n_pairs_in_group=n)
            for i, n in enumerate((45, 31, 60, 80, 120, 5, 1700))]
    cpu = torch.device("cpu")
    for name, states in batches.items():
        profile = config.get_platform_profile("tru" if name == "tru"
                                              else "10x")
        states.append(groups.sweep_group(*deep_em_group(), profile))
        gated = [st for st in states if st.needs_em]
        shallow = [st for st in gated
                   if st.cmask.shape[1] <= groups.EM_NATIVE_C]
        check(len(shallow) >= 4 and len(gated) > len(shallow),
              f"the {name} EM batch lacks shallow or deep EM-gated groups")
        pack = em.pack_states(shallow)
        smem, fits = em_cloud.smem_plan(
            np.diff(pack.cand_off[pack.e_off]), np.diff(pack.k_off))
        check(name == "bench" or not fits.all(),
              f"no group of the {name} batch overflows shared memory")

        host, nat, plain = (_copy_states(states) for _ in range(3))
        groups.run_em_host_batch(host)
        for st in nat:
            if st.needs_em:
                groups.run_em_native(st)
        em.dispatch_em_batch(plain, cpu)()
        stream = torch.cuda.Stream(dev)
        runs = []
        for _ in range(2):
            run = _copy_states(states)
            n0 = em_cloud.LAUNCHES.value
            em.dispatch_em_batch(run, dev, stream)()
            check(em_cloud.LAUNCHES.value - n0 == 1,
                  f"a dispatch of the {name} batch launched the kernel "
                  f"{em_cloud.LAUNCHES.value - n0} times")
            runs.append(run)
        err = 0.0
        for c1, c2, p, h, n in zip(*runs, plain, host, nat):
            for ref in (p, h, n):
                np.testing.assert_allclose(c1.gammas, ref.gammas, rtol=1e-9,
                                           atol=1e-12)
                err = max(err, float(np.abs(c1.gammas - ref.gammas).max()))
            check(np.array_equal(c1.gammas, c2.gammas),
                  "two card EM runs on the same inputs gave different bits")
        moved = sum(not np.array_equal(c.gammas, s.gammas)
                    for c, s in zip(runs[0], states)
                    if s.needs_em and s.cmask.shape[1] <= groups.EM_NATIVE_C)
        check(name == "bench" or moved > 0,
              f"the card EM moved no gamma of the {name} batch")

        def card_em():
            em.dispatch_em_batch(_copy_states(states), dev, stream)()

        card_ms = statistics.median([_host_ms(card_em, 1) for _ in range(5)])
        host_ms = statistics.median([_host_ms(
            lambda: groups.run_em_host_batch(_copy_states(states)), 1)
            for _ in range(3)])
        pack_ms = statistics.median([_host_ms(
            lambda: em.pack_states(shallow), 1) for _ in range(5)])
        n_bytes = em_cloud.flat_bytes(pack)
        log(f"em [{name}]: {len(states)} groups, {len(gated)} EM-gated "
            f"({len(gated) - len(shallow)} deep), flat {pack.score.size} "
            f"candidates, {pack.comp.size} clouds, {n_bytes} bytes, smem "
            f"{smem} bytes ({int((~fits).sum())} groups overflow); the card "
            f"EM moved the gammas of {moved} shallow groups; card vs "
            f"plain/host/native max abs diff {err} (rtol 1e-9, atol "
            f"1e-12), two card runs identical, one launch a dispatch; EM "
            f"ms (host, dispatch + wait, median) card {card_ms} (pack "
            f"{pack_ms}), host run_em_host_batch {host_ms}; card: {card}")
        if name != "bench":
            continue
        # the kernel's device time against em_run's eager chain on the
        # card over the same groups, padded as the eager dispatch padded
        reps = 20
        ev = _device_events(card_em, reps)
        k_us = sum(us for n, us in ev if em_cloud.KERNEL_SYMBOL in n) / reps
        all_us = sum(us for _, us in ev) / reps
        d, (G, E, C, NC) = groups._pack_states(shallow)
        d["run_em"] = np.ones(G, bool)
        with torch.cuda.stream(stream):
            inp = em.EMInputs(**{k: torch.from_numpy(np.ascontiguousarray(
                v)).to(dev) for k, v in d.items()})
        torch.cuda.synchronize()

        def eager():
            with torch.cuda.stream(stream):
                em.em_run(inp, many=shallow[0].many)

        ev_run = _device_events(eager, 5)
        run_us = sum(us for _, us in ev_run) / 5
        run_host_ms = statistics.median([_host_ms(
            lambda: (eager(), torch.cuda.synchronize()), 1)
            for _ in range(5)])
        bound_us = n_bytes / 3.35e12 * 1e6
        log(f"em_cloud [bench]: kernel {k_us} us a launch (device events of "
            f"a dispatch {all_us} us, {len(ev) / reps} events: copy up, "
            f"kernel, copy back); em_run eager on the card [G, E, C, NC] = "
            f"{(G, E, C, NC)}: {run_us} us of device time in "
            f"{len(ev_run) / 5} device events a call, {run_host_ms} ms "
            f"host wall a call; bound (flat bytes at 3.35 TB/s) {bound_us} "
            f"us, kernel at {100 * bound_us / k_us if k_us else 0}% of it "
            f"(latency-bound); card: {card}")


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
    from ema_tpu_torch import config
    from ema_tpu_torch.index import build_index
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
    from ema_tpu_torch import config
    from ema_tpu_torch.index import build_index
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
        # no --device: the card is the CLI's default
        _cli("align", "-r", ref, "-s", bucket, "-o", out)
        with open(out) as f:
            cli_lines = [ln for ln in f if not ln.startswith("@")]
        # no device=: the card is the Aligner's default too
        lib_aligner = Aligner(build_index(contigs), config.RunConfig())
        check(lib_aligner.device == dev, f"Aligner's default device is "
                                         f"{lib_aligner.device}, not {dev}")
        lib_lines = lib_aligner.align_batch_to_sam(
            read_special_fastq(bucket))
    log(f"CLI: {len(cli_lines)} records, identical to the library "
        f"path={cli_lines == lib_lines}")
    check(len(cli_lines) > 0 and cli_lines == lib_lines,
          "CLI SAM records differ from the library path")


# ----------------------------------------------------------------------
# phases 9-11: the bench tool, -x over preproc buckets, sharded indexes
# ----------------------------------------------------------------------

def phase_bench_sw(dev, card: str) -> dict:
    """The probe on the TPU's [8, 128] input against its plain version,
    then every step of ema_tpu_torch.tools.bench_sw at its full shape.
    Returns the probe's record for the kernels line: its launches in the
    bench tool's run, and its K_CHECK times beside the plain version's."""
    from ema_tpu_torch.ops import probe
    from ema_tpu_torch.tools import bench_sw

    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    err = 0
    for form in probe.FORMS:
        ref = (probe.alu_probe_s16x2_ref if form == "s16x2"
               else probe.alu_probe_ref)
        want = ref(x, bench_sw.K_CHECK, probe.UNROLL_TPU)
        got = probe.alu_probe(x, bench_sw.K_CHECK, probe.UNROLL_TPU, form)
        err = max(err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"alu_probe ({form}) differs from "
                                      f"its plain version on [8, 128]")
    log(f"alu_probe vs plain [8, 128], K={bench_sw.K_CHECK} x "
        f"{probe.UNROLL_TPU}, forms {probe.FORMS}: max_abs_err={err}")
    probe.LAUNCHES.reset()
    art = bench_sw.run(dev)
    launches = probe.LAUNCHES.value
    for name, v in art["variants"].items():
        log(f"bench_sw [{name}]: {v['ms']} ms, {v['gcells_per_s']} Gcell/s"
            f" (B={art['shape']['B']}), card: {card}")
    log(f"bench_sw: probe {art['vpu_int32_tops_measured']} Tops/s (alu), "
        f"{art['dpx_int32_tops_measured']} Tops/s (dpx), theoretical "
        f"{art['int32_tops_theoretical']} Tops/s; sw_banded "
        f"{art['banded_int32_tops_achieved']} Tops/s = "
        f"{art['banded_roofline_pct']}% of the probe, "
        f"{art['banded_roofline_pct_of_theoretical']}% of theoretical; "
        f"bit_exact_across_variants={art['bit_exact_across_variants']}, "
        f"packed vs wl-masked plain="
        f"{art['packed_bit_exact_vs_wl_masked_ref']}; probe launches "
        f"{launches}; card: {card}")
    for label, v in art["cell_loops"].items():
        log(f"SASS instructions a cell [{label}]: {v['sass_instr_per_cell']}"
            f" ({v['loop']} in the loop over {v['cells_per_pass']} cells; "
            f"{v['sass_imad_per_cell']} of them IMAD; hand count, all and "
            f"integer pipe only, {v['hand_count']})")
    log(f"s16x2 operations, SASS instructions each: "
        + ", ".join(f"{k} {v['instructions']}"
                    for k, v in art["s16x2_forms"].items())
        + f"; probe s16x2 form {art['s16x2_int32_instr_tera_per_s']} T "
        f"packed instructions/s, bit-exact against its plain version")
    log("bench_sw artifact: " + json.dumps(art))
    check(art["bit_exact_across_variants"]
          and art["packed_bit_exact_vs_wl_masked_ref"],
          "bench_sw variants disagree")
    check(launches > 0, "the bench tool never launched alu_probe")
    # the probe's bound at its K_CHECK run: the chain steps times the two
    # instructions ptxas emits for a step (a LOP3 and a VIADDMNMX, both
    # the integer pipe's), over the card's int32 rate
    steps = probe.probe_ops(art["probe_elements"], bench_sw.K_CHECK,
                            probe.UNROLL_TPU) // 3
    instr = steps * bench_sw.PROBE_INSTR_PER_STEP
    bound, by = bench_sw.bound_ms(instr, instr, 8 * art["probe_elements"],
                                  art["int32_tops_theoretical"] * 1e12)
    log(f"alu_probe at K={bench_sw.K_CHECK}: kernel "
        f"{art['alu_k_check_ms']} ms, bound {bound} ms by {by} "
        f"({steps} steps x {bench_sw.PROBE_INSTR_PER_STEP} instructions) = "
        f"{bound / art['alu_k_check_ms']} of the kernel's time; measured "
        f"instruction rate {art['alu_int32_instr_tera_per_s']} T/s against "
        f"the theoretical {art['int32_tops_theoretical']}; library call: "
        f"none; card: {card}")
    return dict(launches=launches,
                max_abs_err=max(err, *(art[f"{f}_max_abs_err"]
                                       for f in probe.FORMS)),
                ms=art["alu_k_check_ms"], plain_ms=art["alu_probe_plain_ms"],
                bound_ms=bound, bound_by=by)


def _write_fasta(path, contigs) -> None:
    to_str = simulate().to_str
    with open(path, "w") as f:
        for name, codes in contigs.items():
            s = to_str(codes)
            f.write(f">{name}\n")
            f.writelines(s[i:i + 80] + "\n" for i in range(0, len(s), 80))


def _body(path) -> list:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def _norm(lines) -> list:
    """SAM records with MI masked, sorted (tests/test_sharded_index.py:
    27-28): MI numbering follows the visit order."""
    return sorted(re.sub(r"\tMI:i:\d+", "\tMI:i:*", ln) for ln in lines)


# the port's CLI as ``python -m ema_tpu_torch.cli`` runs it, behind this
# script's import finder
GUARDED_CLI = ("import sys; import chip_smoke; "
               "chip_smoke.refuse_reference_imports(); "
               "from ema_tpu_torch import cli; "
               "sys.exit(cli.main(sys.argv[1:]))")


def _cli(*args, stdin=None) -> str:
    """The port's CLI in a subprocess, with jax and ema_tpu refused; its
    stderr."""
    r = subprocess.run([sys.executable, "-c", GUARDED_CLI, *args],
                       cwd=ROOT, stdin=stdin, capture_output=True,
                       text=True, timeout=900)
    check(r.returncode == 0, f"CLI {args[0]} failed:\n{r.stderr[-4000:]}")
    return r.stderr


def _cli_in_process(dev, args) -> tuple:
    """The CLI's main() in this process (so that the launch counts are
    visible): (seconds until it returns and ``dev`` is idle, sw_banded
    launches)."""
    from ema_tpu_torch import cli
    from ema_tpu_torch.ops.sw import reset_counts

    reset_counts()
    t0 = time.time()
    rc = cli.main(args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    check(rc == 0, f"CLI {' '.join(args[:3])} returned {rc}")
    return dt, _launched()["sw_banded"]


def phase_x(dev, card: str, genome, pairs, truth, bc_strs) -> dict:
    """The documented workflow on the bench world: count, preproc -n 500
    and align -x over the buckets, each mode against the others and
    against the library path."""
    from ema_tpu_torch import config
    from ema_tpu_torch.cli import _load_or_build_index
    from ema_tpu_torch.core.samout import write_sam_header
    from ema_tpu_torch.utils.samcheck import check_sam
    from ema_tpu_torch.utils.samdiff import diff_sams
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.io import read_special_rows
    from ema_tpu_torch.parallel.distrib import merge_sorted_shards

    ids, _, s1, q1, s2, q2 = pairs
    rates, launches = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        _write_fasta(ref, {"chr1": genome})
        wl = os.path.join(tmp, "wl.txt")
        with open(wl, "w") as f:
            f.writelines(b + "\n" for b in sorted(set(bc_strs)))
        fq = os.path.join(tmp, "inter.fq")
        with open(fq, "w") as f:
            for i in range(len(ids)):
                r1 = bc_strs[i] + "ACGTACG" + s1[i]
                f.write(f"@{ids[i]}\n{r1}\n+\n{'I' * 23}{q1[i]}\n"
                        f"@{ids[i]}\n{s2[i]}\n+\n{q2[i]}\n")
        t0 = time.time()
        with open(fq, "rb") as fh:
            _cli("count", "-w", wl, "-o", os.path.join(tmp, "cnt"),
                 stdin=fh)
        with open(fq, "rb") as fh:
            _cli("preproc", "-w", wl, "-o", os.path.join(tmp, "bkt"), "-n",
                 "500", "-t", "4", os.path.join(tmp, "cnt.ema-ncnt"),
                 stdin=fh)
        bdir = os.path.join(tmp, "bkt")
        buckets = sorted(os.path.join(bdir, b) for b in os.listdir(bdir)
                         if b.startswith("ema-bin-"))
        rows = [read_special_rows(b) for b in buckets]
        n_pairs = sum(len(r[0]) for r in rows)
        log(f"-x: count + preproc -n 500 -t 4 in {time.time() - t0} s: "
            f"{len(buckets)} buckets, {n_pairs} pairs")
        check(len(buckets) == 500 and n_pairs == len(ids),
              f"preproc gave {len(buckets)} buckets of {n_pairs} pairs")

        def out(name):
            return os.path.join(tmp, f"{name}.sam")

        def align(*flags, o):
            return ["align", "-r", ref, "--device", str(dev), "-x", "-o",
                    out(o), *flags, *buckets]

        man = os.path.join(tmp, "run.jsonl")
        # the module entry point, which also builds the index cache
        t0 = time.time()
        _cli(*align("--manifest", man, o="coal_man"))
        log(f"-x: python -m ema_tpu_torch.cli align -x --manifest (index "
            f"build included) in {time.time() - t0} s")
        first = open(out("coal_man")).read()
        parts = os.path.join(tmp, "coal_man.sam.parts")
        mtimes = {p: os.path.getmtime(os.path.join(parts, p))
                  for p in os.listdir(parts)}
        check(len(mtimes) == 500, f"{len(mtimes)} parts written")
        _cli_in_process(dev, align("--manifest", man, o="coal_man"))
        same_mt = all(os.path.getmtime(os.path.join(parts, p)) == t
                      for p, t in mtimes.items())
        same = open(out("coal_man")).read() == first
        log(f"-x --manifest rerun: parts untouched={same_mt}, output "
            f"identical={same}")
        check(same_mt and same, "the manifest rerun touched parts or "
                                "changed the output")

        bodies = {"coalesced+manifest": _body(out("coal_man"))}
        for label, flags in (("coalesced", ()),
                             ("-j 1", ("--no-coalesce", "-j", "1")),
                             ("-j 2", ("--no-coalesce", "-j", "2"))):
            dt, n = _cli_in_process(
                dev, align(*flags, o=label.replace(" ", "")))
            rates[label] = n_pairs / dt
            launches += n
            bodies[label] = _body(out(label.replace(" ", "")))
            log(f"-x [{label}]: {dt} s for {n_pairs} pairs = "
                f"{rates[label]} pairs/s (index load included), sw_banded "
                f"launches {n}, card: {card}")
        with open(out("coal_man")) as f:
            faults = check_sam(f.readlines())
        log(f"check_sam over the -x run's SAM: {len(faults)} faults "
            f"{faults[:3]}")
        check(not faults, f"check_sam: {len(faults)} faults in the -x "
                          f"run's SAM: {faults[:3]}")
        ref_body = bodies["coalesced+manifest"]
        for label, b in bodies.items():
            log(f"-x [{label}]: {len(b)} records, identical to the "
                f"coalesced manifest run={b == ref_body}")
            check(b == ref_body, f"-x [{label}] body differs")

        _cli_in_process(dev, align("--sort", o="sorted"))
        shards = []
        for s in range(2):
            _, n = _cli_in_process(dev, align("--sort", "--shard", str(s),
                                              "--nshards", "2",
                                              o=f"shard{s}"))
            launches += n
            shards.append(out(f"shard{s}"))
        idx = _load_or_build_index(ref)
        merge_sorted_shards(shards, out("merged"), idx.names)
        same = _norm(_body(out("merged"))) == _norm(_body(out("sorted")))
        log(f"-x --sort --shard 0/1 of 2, merged: identical to the single "
            f"sorted run (MI masked)={same}")
        check(same, "merged shards differ from the single sorted run")

        # the library path on the same pairs
        batch = ReadBatch.from_pairs(*(sum((r[k] for r in rows), [])
                                       for k in range(6)))
        cfg = config.RunConfig()
        aligner = Aligner(idx, cfg, device=dev)
        t0 = time.time()
        lib = aligner.align_batch_to_sam(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rates["library"] = n_pairs / (time.time() - t0)
        with open(out("library"), "w") as f:
            f.write(write_sam_header(idx.names, idx.lengths, cfg.read_group,
                                     "library", "library"))
            f.writelines(lib)
        st = diff_sams(out("coal_man"), out("library"))
        fields = (st.pos_match, st.flag_match, st.cigar_match,
                  st.mapq_match, st.bx_match, st.xg_close,
                  st.mi_consistent, st.mate_match, st.seq_match,
                  st.xa_match)
        n_diff = st.only_a + st.only_b + max(st.shared - f for f in fields)
        _cli("samdiff", out("coal_man"), out("library"), "--fail-under",
             "100")
        log(f"-x vs library path: samdiff over {st.shared} primary "
            f"records: {n_diff} differ (a={st.n_a}, b={st.n_b}, "
            f"mismatches {st.mismatches[:3]}); library {rates['library']} "
            f"pairs/s, card: {card}")
        check(n_diff == 0, f"samdiff: {n_diff} records differ from the "
                           f"library path")
        ok, n = truth_share(ref_body, ids, truth)
        log(f"-x accuracy: {ok}/{n} = {ok / max(n, 1)} mapped primary "
            f"records within +-5 bp of truth")
        check(n >= n_pairs and ok / n >= 0.98, f"-x accuracy gate ({ok}/{n})")
    check(launches > 0, "the -x runs never launched sw_banded")
    log(f"-x pairs/s: coalesced {rates['coalesced']}, -j 1 {rates['-j 1']}, "
        f"-j 2 {rates['-j 2']}, library {rates['library']}; coalesced / "
        f"-j 1 = {rates['coalesced'] / rates['-j 1']}; card: {card}")
    return rates, ref_body


SHARD_BASES = 1_600_000     # two shards of the 4 x 750 kbp sharded world


def sharded_world():
    """A 3 Mbp genome of 4 random 750 kbp contigs and ~40k pairs simulated
    as in bench_world, a quarter of the barcodes on each contig: no
    fragment spans two contigs, as no molecule spans two chromosomes.
    (A read across the boundary of two contigs in different shards is the
    one place where a sharded and a single index differ, in the JAX
    package as in the port: ROADMAP C.)  Returns (contigs, barcode
    strings, pairs)."""
    sim = simulate()
    rng = np.random.default_rng(2027)
    contigs = {f"chr{i + 1}": sim.rand_genome(rng, 750_000)
               for i in range(4)}
    cols = [[] for _ in range(7)]      # ids, bc_strs, bcs, s1, q1, s2, q2
    for name, codes in contigs.items():
        got = sim.simulate_pairs(
            rng, sim.to_str(codes), n_barcodes=50_000 // 60 // 4,
            frags_per_bc=(2, 4), pairs_per_frag=(15, 25), frag_len=30_000,
            read_len=100, err=0.003)
        cols[0] += [f"{name}_{i}" for i in got[0]]
        for col, vals in zip(cols[1:], got[1:7]):
            col += vals
    ids, bc_strs, bcs, s1, q1, s2, q2 = cols
    return contigs, bc_strs, (ids, bcs, s1, q1, s2, q2)


def phase_sharded(dev, card: str) -> dict:
    """Two index shards against one index, in the library and through the
    CLI."""
    from ema_tpu_torch import config
    from ema_tpu_torch.index import build_index, build_index_sharded
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner, ShardedAligner
    from ema_tpu_torch.io import read_special_fastq
    from ema_tpu_torch.ops.sw import reset_counts

    contigs, bc_strs, pairs = sharded_world()
    n_pairs = len(pairs[0])
    single = build_index(contigs)
    sharded = build_index_sharded(contigs, max_shard_bases=SHARD_BASES)
    check(sharded.n_shards == 2, f"{sharded.n_shards} shards, not 2")
    rates = {}
    for dem in (True, False):
        out = {}
        for label, cls, idx in (("single", Aligner, single),
                                ("sharded", ShardedAligner, sharded)):
            aligner = cls(idx, config.RunConfig(device_em=dem), device=dev)
            reset_counts()
            t0 = time.time()
            out[label] = aligner.align_batch_to_sam(
                ReadBatch.from_pairs(*pairs))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            rates[(label, dem)] = n_pairs / (time.time() - t0)
            n = _launched()["sw_banded"]
            log(f"sharded [{label}, device_em={dem}]: {len(out[label])} "
                f"records, {rates[(label, dem)]} pairs/s, sw_banded "
                f"launches {n}, card: {card}")
            check(n > 0, f"{label} run never launched sw_banded")
        same = (len(out["sharded"]) == len(out["single"])
                and _norm(out["sharded"]) == _norm(out["single"]))
        log(f"sharded [device_em={dem}]: ShardedAligner equals Aligner "
            f"(MI masked)={same}")
        check(same, f"ShardedAligner differs from Aligner (device_em={dem})")

    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        _write_fasta(ref, contigs)
        ids, _, s1, q1, s2, q2 = pairs
        rank = {b: i for i, b in enumerate(sorted(set(bc_strs)))}
        bucket = os.path.join(tmp, "all")
        xb = [os.path.join(tmp, f"ema-bin-{k:03d}") for k in range(8)]
        fhs = [open(p, "w") for p in [bucket, *xb]]
        try:
            for row in zip(bc_strs, ids, s1, q1, s2, q2):
                line = " ".join(row) + "\n"
                fhs[0].write(line)
                fhs[1 + rank[row[0]] % 8].write(line)
        finally:
            for fh in fhs:
                fh.close()
        _cli("index", "-r", ref, "--shard-bases", str(SHARD_BASES))
        check(len(os.listdir(ref + ".emaidx.d")) == 2,
              f"index --shard-bases {SHARD_BASES} did not write 2 shards")
        s_out, x_out = (os.path.join(tmp, f"{k}.sam") for k in "sx")
        _cli_in_process(dev, ["align", "-r", ref, "--device", str(dev),
                              "-s", bucket, "-o", s_out])
        _cli_in_process(dev, ["align", "-r", ref, "--device", str(dev),
                              "-x", "-o", x_out, *xb])
        lib = ShardedAligner(sharded, config.RunConfig(), device=dev
                             ).align_batch_to_sam(read_special_fastq(bucket))
        same_s = _body(s_out) == lib
        same_x = _norm(_body(x_out)) == _norm(lib)
    log(f"sharded CLI: align -s identical to the library path={same_s}, "
        f"align -x equal (MI masked)={same_x}")
    check(same_s and same_x, "the sharded CLI differs from the library")
    log(f"sharded pairs/s: ShardedAligner {rates[('sharded', True)]} "
        f"(device EM), {rates[('sharded', False)]} (host EM); Aligner "
        f"{rates[('single', True)]}, {rates[('single', False)]}; card: "
        f"{card}")
    return rates


# ----------------------------------------------------------------------
# phases 12-13: the mesh and two processes
# ----------------------------------------------------------------------

STEP_STATIC = dict(max_seeds=4, hits_per_seed=4, window_pad=12,
                   min_seed_len=19)     # ema_tpu_torch.parallel.bench_scaling
MESHES = ((2, 1), (1, 2), (2, 2))


def _step_reads(pairs, dev, n_rows: int = 40_704):
    """The first ``n_rows`` reads of the bench world's pairs, forward and
    reverse-complemented: int32 [2 * n_rows, 100] oriented reads and
    their lengths on ``dev``."""
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import orient_device

    b = ReadBatch.from_pairs(*(col[:(n_rows + 1) // 2] for col in pairs))
    codes = torch.from_numpy(b.codes[:n_rows]).to(dev)
    lens = torch.from_numpy(b.lens[:n_rows].astype(np.int32)).to(dev)
    reads, lens = orient_device(codes, lens)
    return reads.to(torch.int32), lens


def _timed(fn, dev, reps: int = 3) -> tuple:
    """(the last result, the best of ``reps`` wall times in s, ``dev``
    idle at the end of each)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize(dev)
        best = min(best, time.time() - t0)
    return out, best


def phase_mesh(dev, card: str, idx, pairs, default_lines) -> None:
    """The sharded candidate step and the Aligner's data split over cells
    that share the one card: bit-exact against one device, with
    sw_banded's launches on each path.  No scaling is measured: every
    cell is the same card."""
    from ema_tpu_torch import config
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.index.fm import FMIndexArrays
    from ema_tpu_torch.ops.sw import reset_counts
    from ema_tpu_torch.parallel import (bench_scaling, candidate_core,
                                        make_mesh,
                                        make_sharded_candidate_step)

    fm = FMIndexArrays.from_index(idx, dev)
    text = torch.from_numpy(idx.text).to(dev)
    reads, lens = _step_reads(pairs, dev)
    B = reads.shape[0]
    K = STEP_STATIC["hits_per_seed"]
    kw = {k: v for k, v in STEP_STATIC.items() if k != "hits_per_seed"}
    # the plain path: the step's core on the CPU, on the first 1,024 reads
    n_cpu = 256
    cpu_out = candidate_core(FMIndexArrays.from_index(idx, "cpu"),
                             torch.from_numpy(idx.text), reads[:n_cpu].cpu(),
                             lens[:n_cpu].cpu(), hits_per_seed=2 * K, **kw)
    one = make_sharded_candidate_step(make_mesh(1, 1, [dev]), fm, text,
                                      **STEP_STATIC)
    _, t_one = _timed(lambda: one(reads, lens), dev)
    log(f"mesh step: {B} oriented reads, one device {B / t_one} reads/s "
        f"(best of 3), card: {card}")
    for n_data, n_cand in MESHES:
        # one device, every slot of the mesh's split
        reset_counts()
        want = candidate_core(fm, text, reads, lens, hits_per_seed=K * n_cand,
                              **kw)
        n_one = _launched()["sw_banded"]
        step = make_sharded_candidate_step(
            make_mesh(n_data, n_cand, [str(dev)] * (n_data * n_cand)), fm,
            text, **STEP_STATIC)
        reset_counts()
        out = step(reads, lens)
        torch.cuda.synchronize(dev)
        n_mesh = _launched()["sw_banded"]
        _, t = _timed(lambda: step(reads, lens), dev)
        b = want[0].cpu().numpy()
        same = (torch.equal(out.best_score, want[0])
                and torch.equal(out.best_gpos, want[1]))
        sums = (int(out.n_aligned) == int((b > 0).sum())
                and int(out.sum_score) == int(b[b > 0].sum()))
        log(f"mesh step {n_data}x{n_cand} over [{dev}] * "
            f"{n_data * n_cand}: bit-exact against candidate_core with "
            f"{K * n_cand} hits a seed on one device={same}, n_aligned "
            f"{int(out.n_aligned)} and sum_score {int(out.sum_score)} equal "
            f"to the host sums={sums}, sw_banded launches {n_mesh} (one "
            f"device {n_one}), {B / t} reads/s (best of 3; one device "
            f"{B / t_one}), collectives {step.collectives}, card: {card}")
        check(same and sums, f"the {n_data}x{n_cand} step differs from one "
                             "device")
        check(n_mesh >= n_data * n_cand, f"the {n_data}x{n_cand} step "
                                         "launched sw_banded "
                                         f"{n_mesh} times")
        if (n_data, n_cand) == (1, 2):
            same_cpu = all(torch.equal(a[:n_cpu].cpu(), c)
                           for a, c in zip(want, cpu_out))
            log(f"mesh step: the card's candidate_core with {2 * K} hits a "
                f"seed equals the CPU's plain path on {n_cpu} reads="
                f"{same_cpu}")
            check(same_cpu, "candidate_core on the card differs from the "
                            "CPU")

    part = bench_scaling.partition_check(2, devices=[str(dev)] * 2)
    log(f"bench_scaling.partition_check(2) over [{dev}] * 2: "
        f"{json.dumps(part)}, card: {card}")
    check(part["ok"], "partition_check(2) failed")

    batch = ReadBatch.from_pairs(*pairs)
    greedy = config.RunConfig(aligner=config.AlignerParams(seeding="greedy"))
    turns = (("one device", None), ("2 cells", [str(dev)] * 2),
             ("2 cells again", [str(dev)] * 2), ("one device again", None))

    def n_differ(a, b) -> int:
        return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))

    # the fused greedy seed+locate runs at about 3k pairs/s (a loop of
    # small launches, PERF.md): its check takes the first 8,192 pairs
    for label, cfg, seed_impl, b, runs in (
            ("default", None, None, batch, turns),
            ("device locate", None, "device", batch, turns),
            ("greedy, device seed+locate, 8,192 pairs", greedy, "device",
             ReadBatch.from_pairs(*(col[:8192] for col in pairs)),
             turns[:2])):
        rates, out, aligners = {}, {}, {}
        for name, devices in runs:
            aligner = Aligner(idx, cfg, device=dev, seed_impl=seed_impl,
                              devices=devices)
            check((aligner.mesh is None) == (devices is None),
                  f"Aligner(devices={devices}) mesh {aligner.mesh}")
            reset_counts()
            t0 = time.time()
            out[name] = aligner.align_batch_to_sam(b)
            torch.cuda.synchronize(dev)
            rates[name] = len(b.ids) / (time.time() - t0)
            aligners[name] = aligner
            n = _launched()["sw_banded"]
            check(n > 0, f"Aligner [{label}, {name}] never launched "
                         "sw_banded")
        n_diff = n_differ(out["2 cells"], out["one device"])
        same = all(o == out["one device"] for o in out.values())
        log(f"mesh Aligner [{label}] on [{dev}] * 2: {len(out['2 cells'])} "
            f"records, {n_diff} differ from the one-device run, all "
            f"{len(runs)} runs identical={same}; pairs/s in turns {rates} (no "
            f"scaling: one card), sw_banded launches {n} in the last run, "
            f"card: {card}")
        check(same and n_diff == 0, f"the 2-cell Aligner [{label}] differs")
        if cfg is None:
            # phase_main_path's lines are the 4th pass of one Aligner (the
            # MI ids run on across passes): 3 more passes on 2 cells
            for _ in range(3):
                last = aligners["2 cells"].align_batch_to_sam(batch)
            n_diff = n_differ(last, default_lines)
            log(f"mesh Aligner [{label}] on [{dev}] * 2, 4th pass: "
                f"{n_diff} of {len(default_lines)} records differ from "
                f"phase_main_path's default lines")
            check(n_diff == 0, f"the 2-cell Aligner [{label}] differs from "
                               "the default lines")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(args_of, stdin_of=lambda i: None) -> float:
    """The port's CLI as processes 0 and 1 of one gloo group on this
    host, behind the import finder; ``args_of(i)`` = (mode, *args).
    Returns the wall time until both have exited."""
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.time()
    procs = []
    try:
        for i in range(2):
            mode, *args = args_of(i)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", GUARDED_CLI, mode, "--coordinator",
                 coord, "--nprocs", "2", "--procid", str(i), *args],
                cwd=ROOT, stdin=stdin_of(i), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"process {i} of {' '.join(args_of(i)[:1])}"
                                 f" --coordinator failed:\n{err[-4000:]}")
    return time.time() - t0


def _records(lines) -> dict:
    """SAM records by (name, mate) without MI and tags (tests/
    test_multihost.py:130-150)."""
    out = {}
    for ln in lines:
        f = ln.rstrip("\n").split("\t")
        out[(f[0], int(f[1]) & 0xC0)] = (f[1], f[2], f[3], f[4], f[5], f[9])
    return out


def phase_multihost(dev, card: str, idx, genome, pairs, bc_strs,
                    x_body) -> None:
    """Two processes of one gloo group sharing the card: ``preproc
    --coordinator`` over the two halves of the bench world's FASTQ must
    give a one-process preproc's buckets, and ``align -x --coordinator``
    over those buckets phase_x's records."""
    from ema_tpu_torch.cli import _index_path

    ids, _, s1, q1, s2, q2 = pairs
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        _write_fasta(ref, {"chr1": genome})
        idx.save(_index_path(ref))          # both processes load it
        wl = os.path.join(tmp, "wl.txt")
        with open(wl, "w") as f:
            f.writelines(b + "\n" for b in sorted(set(bc_strs)))
        recs = [f"@{ids[i]}\n{bc_strs[i]}ACGTACG{s1[i]}\n+\n{'I' * 23}"
                f"{q1[i]}\n@{ids[i]}\n{s2[i]}\n+\n{q2[i]}\n"
                for i in range(len(ids))]
        fq = os.path.join(tmp, "inter.fq")
        halves = [os.path.join(tmp, f"half{i}.fq") for i in range(2)]
        for path, part in ((fq, recs), (halves[0], recs[:len(recs) // 2]),
                           (halves[1], recs[len(recs) // 2:])):
            with open(path, "w") as f:
                f.writelines(part)
        t0 = time.time()
        for i in range(2):
            with open(halves[i], "rb") as fh:
                _cli("count", "-w", wl, "-o", os.path.join(tmp, f"cnt{i}"),
                     stdin=fh)
        cnts = [os.path.join(tmp, f"cnt{i}.ema-ncnt") for i in range(2)]
        with open(fq, "rb") as fh:
            _cli("preproc", "-w", wl, "-o", os.path.join(tmp, "one"), "-n",
                 "500", "-t", "4", *cnts, stdin=fh)
        t_one = time.time() - t0
        fhs = [open(h, "rb") for h in halves]
        try:
            t_two = _two_processes(
                lambda i: ("preproc", "-w", wl, "-o",
                           os.path.join(tmp, "two"), "-n", "500", "-t", "4",
                           cnts[i]), lambda i: fhs[i])
        finally:
            for fh in fhs:
                fh.close()
        names = sorted(n for n in os.listdir(os.path.join(tmp, "one"))
                       if n.startswith("ema-"))
        bad = [n for n in names if b"".join(
            open(os.path.join(tmp, "two", f"host{i:02d}", n), "rb").read()
            for i in range(2)) != open(os.path.join(tmp, "one", n),
                                       "rb").read()]
        log(f"multihost preproc: two processes (gloo, 127.0.0.1) in {t_two}"
            f" s; count of both halves + one-process preproc in {t_one} s; "
            f"{len(names)} bucket files, {len(bad)} differ from the "
            f"one-process run, card: {card}")
        check(len(names) == 501 and not bad,
              f"the two-process buckets differ: {bad[:3]}")

        buckets = sorted(os.path.join(tmp, "one", n) for n in names
                         if n.startswith("ema-bin-"))
        t_x = _two_processes(
            lambda i: ("align", "-r", ref, "--device", str(dev), "-x", "-o",
                       os.path.join(tmp, "x.sam"), *buckets))
        got = {}
        for i in range(2):
            got.update(_records(_body(os.path.join(
                tmp, f"x.shard{i:02d}of02.sam"))))
    want = _records(x_body)
    n_diff = sum(got.get(k) != v for k, v in want.items()) \
        + len(set(got) - set(want))
    log(f"multihost align -x: two processes on [{dev}] in {t_x} s "
        f"(index load and kernel load included), {len(got)} records, "
        f"{n_diff} differ from phase_x's one-process run (MI masked), "
        f"card: {card}")
    check(n_diff == 0 and len(got) == len(want),
          "the two-process align -x records differ from phase_x's")


def _tool_cli(tool: str, *args) -> dict:
    """``python -m ema_tpu_torch.tools.<tool> *args`` behind the import
    finder; returns its JSON line."""
    r = subprocess.run(
        [sys.executable, "-c", "import sys, runpy, chip_smoke; "
         "chip_smoke.refuse_reference_imports(); sys.argv[0] = 'tool'; "
         f"runpy.run_module('ema_tpu_torch.tools.{tool}', "
         "run_name='__main__')", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    check(r.returncode == 0, f"tools.{tool} failed (exit {r.returncode}):"
                             f"\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_tools(dev, card: str, idx, pairs) -> None:
    """The tool twins of ema_tpu_torch/tools/ on the card, each once: the
    bench (BASELINE config 1 at full size, on the smoke's bench world and
    index), ab_align, hostbound, prof_pipeline and prof_smem on the same
    world; the config tools (bench_configs config4, bench_config5, as
    subprocesses through the port's CLI) and the accuracy tools at the
    reduced sizes logged beside them.  Each JSON line is logged and each
    tool's own checks must hold."""
    from ema_tpu_torch.tools import (ab_align, bench, chain_recall,
                                     diagnose_mapq, hostbound,
                                     measure_accuracy, prof_pipeline,
                                     prof_smem)

    def show(name, payload, t0):
        log(f"tools.{name} ({time.time() - t0} s): {json.dumps(payload)}")

    t0 = time.time()
    res = bench.measure(idx, pairs, dev, card, stage_timers=True)
    show("bench [BASELINE config 1, full size]", res, t0)
    check(res["device"] == str(dev) and res["card"] == card
          and len(res["passes_s"]) <= bench.MAX_PASSES and res["value"] > 0,
          f"tools.bench gave {res}")
    t0 = time.time()
    res = ab_align.run(idx, pairs, ["devem", "hostem"], dev, card, reps=2,
                       check_equal=True)
    show("ab_align devem hostem --check-equal --reps 2", res, t0)
    t0 = time.time()
    res = hostbound.measure(idx, pairs, dev, card, reps=1)
    show("hostbound --reps 1", res, t0)
    check(res["frontend_overlap_wall_s"] > 0 and "sw[device]"
          in res["stages_thread_s"], "tools.hostbound found no SW stage")
    t0 = time.time()
    res = prof_pipeline.measure(idx, pairs, dev, card, reps=1)
    show("prof_pipeline --reps 1", res, t0)
    t0 = time.time()
    res = prof_smem.measure(idx, pairs, reps=1)
    show("prof_smem --reps 1", res, t0)
    check(len(res["seeders"]) == 5, "tools.prof_smem ran no seeder")

    t0 = time.time()
    res = _tool_cli("bench_configs", "config4", "--genome", "2000000",
                    "--pairs", "8000", "--buckets", "50")
    show("bench_configs config4 --genome 2000000 --pairs 8000 --buckets 50",
         res, t0)
    check(res["card"] == card, "tools.bench_configs ran off the card")
    t0 = time.time()
    res = _tool_cli("bench_config5", "--barcodes", "100")
    show("bench_config5 --barcodes 100", res, t0)
    t0 = time.time()
    res = _tool_cli("verify_drive")
    show("verify_drive", res, t0)
    check(res["ok"], "tools.verify_drive failed")

    t0 = time.time()
    res = measure_accuracy.measure(dev, card, 3_000_000, 20_000)
    show("measure_accuracy --genome 3000000 --pairs 20000", res, t0)
    check(res["at_truth_pct_of_mapped"] >= 98
          and all(b["n"] for b in res["mapq_calibration"].values()),
          "tools.measure_accuracy: under 98% at truth or an empty mapq bin")
    t0 = time.time()
    genome, fams, sim = chain_recall.build_world(np.random.default_rng(5),
                                                 2_000_000, 6_000)
    res = chain_recall.measure_recall(genome, fams, sim, device=dev)
    show("chain_recall (the world of tests/test_chain_recall.py: 2 Mbp, "
         "6,000 pairs, smem)", res, t0)
    by = res["recall_by_edit_delta"]
    check(by["d_le3"]["n"] >= 200 and by["d_le3"]["recall_pct"] >= 99.9
          and by["d0"]["recall_pct"] >= 99.9,
          "tools.chain_recall: near-co-optimal recall under 99.9%")
    t0 = time.time()
    terms, stats, _ = diagnose_mapq.capture(
        *diagnose_mapq.repeat_world(2_000_000, 8_000), dev)
    show("diagnose_mapq --genome 2000000 --pairs 8000",
         diagnose_mapq.decompose(terms, stats), t0)


# ----------------------------------------------------------------------
# sanitizers: every kernel instantiation under compute-sanitizer and under
# the on-card fence, poison and schedule checks; torch's stream sanitizer
# over the main path
# ----------------------------------------------------------------------

# The thread forms of the kernels' launch tables as csrc/*.cu name them
# (tests/test_torch_sanitize.py reads each table back from its source).
# sw_banded and sw_banded16: corridor class -> (the small call's form,
# which group 32 asks for, and the large call's, group 8); a form is
# (lanes a thread, threads a segment, warps a candidate), for sw_banded16
# (registers of two lanes, threads a segment, warps a candidate)
SAN_BANDED = {32: ((2, 16, 1), (4, 8, 1)), 64: ((2, 32, 1), (8, 8, 1)),
              96: ((3, 32, 1), (6, 16, 1)), 128: ((4, 32, 1), (8, 16, 1)),
              256: ((8, 32, 1), (8, 32, 1)),
              512: ((4, 32, 4), (16, 32, 1)), 768: ((3, 32, 8), (12, 32, 2)),
              1024: ((8, 32, 4), (16, 32, 2)),
              2048: ((8, 32, 8), (16, 32, 4)),
              4096: ((16, 32, 8), (16, 32, 8))}
SAN_BANDED16 = {32: ((1, 16, 1), (2, 8, 1)), 64: ((1, 32, 1), (4, 8, 1)),
                96: ((2, 32, 1), (3, 16, 1)), 128: ((2, 32, 1),) * 2,
                256: ((4, 32, 1),) * 2, 512: ((8, 32, 1),) * 2,
                768: ((6, 32, 2),) * 2, 1024: ((8, 32, 2),) * 2,
                2048: ((8, 32, 4),) * 2, 4096: ((8, 32, 8),) * 2}
# sw_banded_packed: group -> (lanes a thread, threads a candidate)
SAN_PACKED = {8: (8, 8), 16: (4, 16)}
# sw_batch: group (threads a candidate) -> (the longest read a form takes,
# its rows a thread) in the order of its table; the last form of 32
# threads takes every read to the kernel's 32 x 32 rows
SAN_BATCH = {8: ((32, 4), (56, 7), (80, 10), (104, 13)),
             32: ((128, 4), (256, 8), (512, 16), (768, 24), (1024, 32))}
SAN_SCORINGS = {"byte": SW_KW, "mask": WIDE_SCORES}
SAN_TEXT = 20_000          # bases of the sets' text, a multiple of 4
SAN_READ = 151             # the banded sets' read matrix width
SAN_PROBE = dict(n=300, K=3)
SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
SANITIZE_OK = "SANITIZE-DRIVE-OK"


def sanitize_launches() -> list:
    """One launch per instantiation of the five kernels, as dicts of
    ``kernel``, ``form`` (the template arguments), ``group`` (the
    ``_plan_kernel`` form it asks for), ``scoring`` (byte or mask) and the
    corridor class ``edge`` or the longest read ``rows``; the probe's by
    ``unroll`` and ``probe_form``."""
    from ema_tpu_torch.ops import probe
    from ema_tpu_torch.ops.sw import MAX_READ

    out = []
    for kernel, table, scorings in (
            ("sw_banded", SAN_BANDED, ("byte", "mask")),
            ("sw_banded16", SAN_BANDED16, ("byte",))):
        seen = set()
        for edge, forms in table.items():
            for group, form in zip((32, 8), forms):
                if form not in seen:
                    seen.add(form)
                    out += [dict(kernel=kernel, form=form, group=group,
                                 edge=edge, scoring=s) for s in scorings]
    for group, form in SAN_PACKED.items():
        out.append(dict(kernel="sw_banded_packed", form=form, group=group,
                        edge=64, scoring="byte"))
    for group, forms in SAN_BATCH.items():
        for rows, per_thread in forms:
            out += [dict(kernel="sw_batch", form=(per_thread, group),
                         group=group, rows=min(rows, MAX_READ), scoring=s)
                    for s in ("byte", "mask")]
    for unroll in probe.UNROLLS:
        out += [dict(kernel="alu_probe", form=(unroll, probe.FORMS.index(f)),
                     unroll=unroll, probe_form=f) for f in probe.FORMS]
    return out


def _san_text(rng) -> np.ndarray:
    text = rng.integers(0, 4, SAN_TEXT).astype(np.uint8)
    text[9000:9024] = 4                                # a run of N
    return text


def _zigzag_read(rng, text, p, rl, step=20) -> np.ndarray:
    """``rl`` bases of ``text`` from ``p`` with a deletion, then an
    insertion, every ``step`` bases: the alignment's diagonal moves from
    lane k to k + 1 and back, by a horizontal gap and a vertical one."""
    out, j = [], p
    for a in range(rl):
        if a and a % step == 0:
            if (a // step) % 2:
                j += 1                                   # deletion
            else:
                out.append(int(rng.integers(0, 4)))      # insertion
                continue
        out.append(int(text[j]))
        j += 1
    return np.array(out[:rl], np.uint8)


def _san_candidates(rng, text, N, L, lens, wl, cross=0, lanes=0) -> dict:
    """gather_score's inputs for N candidates, candidate b owning read b
    (lengths ``lens``, one more read that no candidate owns) with corridor
    ``wl[b]``: candidate 0 reads the text's first bases in a window that
    starts before the text, the last candidate its last bases in a window
    past its end, candidate 1 has tail rows (a window shorter than its last
    diagonal), candidate 2 a window narrower than its corridor, the rest
    full windows.  With ``lanes`` (a banded form's lanes a candidate), the
    last window starts ``lanes`` plus half the read before the text's end,
    so that the base entering the last lane, loaded a period ahead, reaches
    the text's last base and the column past it halfway down the read.
    With ``cross`` (the lanes of one warp of a several-warp form),
    candidate 1's read zigzags (``_zigzag_read``) between lanes
    ``cross - 1`` and ``cross``, so that its alignment passes from warp 0
    to warp 1 and back through shared memory every 20 rows."""
    n = text.shape[0]
    oriented, pos = _reads_from_text(rng, text, N + 1, L, lens)
    rl = lens[:N].astype(np.int64)
    pos[0] = 0
    pos[N - 1] = n - rl[N - 1]
    for b in (0, N - 1):
        oriented[b] = 4
        oriented[b, :rl[b]] = text[pos[b]:pos[b] + rl[b]]
        oriented[b, rl[b] // 2] ^= 1 if rl[b] > 4 else 0
    wl = wl.astype(np.int64)
    win_lo = pos[:N] - rng.integers(0, 16, N)
    win_len = rl + wl - 1 + rng.integers(0, 24, N)
    win_lo[0] = -(wl[0] // 2 + 7)
    win_len[0] = rl[0] + wl[0] + 40
    win_lo[N - 1] = (n - lanes - rl[N - 1] // 2 if lanes
                     else n - rl[N - 1] - 9)
    win_len[N - 1] = rl[N - 1] + wl[N - 1] + 30
    if N > 2:
        win_len[1] = rl[1] + wl[1] // 2
    if N > 3:
        win_len[2] = max(int(wl[2]) // 3, 1)
    if cross:
        # the read's first base at lane cross - 1 (a lane k aligns read
        # base i with window column i + k)
        oriented[1] = 4
        oriented[1, :rl[1]] = _zigzag_read(rng, text, pos[1], rl[1])
        win_lo[1] = pos[1] - (cross - 1)
    return dict(text=text, oriented=oriented, olens=lens.astype(np.int32),
                owners=np.arange(N, dtype=np.int32),
                win_lo=win_lo.astype(np.int64),
                win_len=np.maximum(win_len, 1).astype(np.int32),
                wl=wl.astype(np.int32))


def _san_count(form) -> int:
    """Candidates of an SW form's set: a part-warp form takes one warp of
    segments and one segment of the next (the others stay past N for its
    shuffles), any other three (a block's fourth warp, or a several-warp
    block, leaves at once)."""
    segw = form[1]
    return 32 // segw + 1 if segw < 32 else 3


def sanitize_inputs(spec, rng) -> dict:
    """The inputs of one launch of ``sanitize_launches``, numpy arrays
    (the probe's: ``x``)."""
    if spec["kernel"] == "alu_probe":
        return dict(x=rng.integers(-(1 << 31), 1 << 31, SAN_PROBE["n"],
                                   dtype=np.int64).astype(np.int32))
    text = _san_text(rng)
    N = _san_count(spec["form"])
    if spec["kernel"] == "sw_batch":
        L = spec["rows"]
        lens = rng.integers(1, L + 1, N + 1).astype(np.int32)
        lens[0] = L
        return _san_candidates(rng, text, N, L, lens,
                               rng.integers(1, 49, N))
    edges = (0,) + tuple(SAN_BANDED)
    lo = (1 if spec["kernel"] == "sw_banded_packed"
          else edges[edges.index(spec["edge"]) - 1] + 1)
    wl = rng.integers(lo, spec["edge"] + 1, N)
    wl[0] = spec["edge"]
    lens = rng.integers(1, SAN_READ + 1, N + 1).astype(np.int32)
    lens[0] = SAN_READ
    lens[1] |= 1
    per_lane = 2 if spec["kernel"] == "sw_banded16" else 1
    lanes = per_lane * int(np.prod(spec["form"]))
    wl[N - 1] = spec["edge"]
    lens[N - 1] = min(SAN_READ, lanes)
    cross = 0
    if len(spec["form"]) == 3 and spec["form"][2] > 1:
        # several warps: a read of SAN_READ bases that crosses from warp 0
        # to warp 1 at the widest corridor of the class
        cross = per_lane * spec["form"][0] * 32
        wl[1] = spec["edge"]
        lens[1] = SAN_READ
    return _san_candidates(rng, text, N, SAN_READ, lens, wl, cross, lanes)


def sanitize_sorted_inputs(rng) -> dict:
    """A call of 300 corridors to 32 lanes and one of 4096 through
    gather_score: sorting pays (ops/sw.SORT_PAYS_SLOTS), so two class
    launches read the permutation."""
    text = _san_text(rng)
    N = 301
    lens = rng.integers(1, SAN_READ + 1, N + 1).astype(np.int32)
    wl = rng.integers(1, 33, N)
    wl[N // 2] = 4096
    return _san_candidates(rng, text, N, SAN_READ, lens, wl)


def _san_plain(spec, c) -> torch.Tensor:
    """The plain version's output on the inputs ``c`` (CPU tensors)."""
    from ema_tpu_torch.ops import probe
    from ema_tpu_torch.ops.sw import (KERNEL_OF, gather_score_by_class_ref,
                                      gather_score_ref)

    if spec["kernel"] == "alu_probe":
        ref = (probe.alu_probe_s16x2_ref if spec["probe_form"] == "s16x2"
               else probe.alu_probe_ref)
        return ref(c["x"], SAN_PROBE["K"], spec["unroll"])
    scorer = {v: k for k, v in KERNEL_OF.items()}[spec["kernel"]]
    fn = gather_score_by_class_ref if spec.get("sorted") else \
        gather_score_ref
    return _call(fn, c, scorer, SAN_SCORINGS[spec["scoring"]])


def sanitize_sets(seed: int = 13) -> list:
    """(spec, inputs as CPU tensors, the plain version's output) for every
    launch of ``sanitize_launches`` and the sorted class call."""
    rng = np.random.default_rng(seed)
    sets = []
    specs = sanitize_launches() + [dict(kernel="sw_banded", form=None,
                                        group=0, scoring="byte",
                                        sorted=True)]
    for spec in specs:
        arrays = (sanitize_sorted_inputs(rng) if spec.get("sorted")
                  else sanitize_inputs(spec, rng))
        c = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in arrays.items()}
        sets.append((spec, c, _san_plain(spec, c)))
    return sets


def save_sanitize_sets(path: str) -> list:
    """``sanitize_sets()`` saved at ``path`` for the sanitize drive; returns
    their specs."""
    sets = sanitize_sets()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sets, path)
    return [spec for spec, _, _ in sets]


def sanitizer_filters() -> list:
    """compute-sanitizer's kernel filters: the port's five __global__
    functions by name, so that torch's own kernels are not instrumented."""
    from ema_tpu_torch.ops import probe
    from ema_tpu_torch.ops.sw import KERNEL_SYMBOL

    names = (*KERNEL_SYMBOL.values(), probe.KERNEL_SYMBOL)
    return [a for name in names for a in ("--kernel-name", f"kns={name}")]


def sanitizer_report(text: str, tool: str) -> dict:
    """What compute-sanitizer's output ``text`` says: ``{"status":
    "clean" | "errors" | "refused", "errors": n, "line": ...}``, refused
    where the tool declined the device.  A report without its summary
    line (a run cut short) raises ValueError."""
    refused = re.search(r"=+ Error: (Device not supported)", text)
    if refused:
        return {"status": "refused", "errors": None,
                "line": refused.group(1).strip()}
    if tool == "racecheck":
        m = re.findall(r"RACECHECK SUMMARY: (\d+) hazards? displayed "
                       r"\((\d+) errors?, (\d+) warnings?\)", text)
        n = [int(errors) + int(warnings) for _, errors, warnings in m]
    else:
        n = [int(a) for a in re.findall(r"ERROR SUMMARY: (\d+) errors?",
                                        text)]
    if len(n) != 1:
        raise ValueError(f"compute-sanitizer {tool}: {len(n)} summary lines "
                         f"in its report, not one:\n{text[-2000:]}")
    return {"status": "clean" if n[0] == 0 else "errors", "errors": n[0],
            "line": None}


def compute_sanitizer() -> str:
    """The compute-sanitizer beside nvcc; raises where there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    for rel in ("bin/compute-sanitizer",
                "extras/compute-sanitizer/compute-sanitizer"):
        path = os.path.join(CUDA_HOME or "", rel)
        if CUDA_HOME and os.access(path, os.X_OK):
            return path
    raise RuntimeError(f"compute-sanitizer not found under CUDA_HOME "
                       f"{CUDA_HOME}")


# An allocator for torch.cuda.memory.CUDAPluggableAllocator that fences
# every allocation: each gets a mapping of its own between two unmapped
# guard granules, the buffer set against the upper guard (FENCE_SIDE=end,
# 4-byte aligned) or the lower one (start), and the mapping filled with
# the byte FENCE_POISON.  A read or a write past either end of a buffer
# faults; a read of memory that no one wrote returns the poison.  Built by
# ``build_sanitize_support`` with nvcc, used by the sanitize drive only.
FENCE_ALLOC_SRC = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <sys/types.h>
#include <cstdlib>
#include <map>
#include <mutex>

namespace {
struct Block { CUdeviceptr va, lo; size_t va_size, mapped;
               CUmemGenericAllocationHandle h; };
std::mutex mu;
std::map<void *, Block> blocks;

bool fence_end() {
    const char *s = getenv("FENCE_SIDE");
    return !(s && s[0] == 's');
}
unsigned char poison() {
    const char *p = getenv("FENCE_POISON");
    return p ? (unsigned char)strtol(p, nullptr, 0) : 0xa5;
}
}  // namespace

extern "C" {
void *fence_malloc(ssize_t size, int device, cudaStream_t) {
    std::lock_guard<std::mutex> g(mu);
    cudaSetDevice(device);
    CUmemAllocationProp prop = {};
    prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
    prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
    prop.location.id = device;
    size_t gran = 0;
    if (cuMemGetAllocationGranularity(&gran, &prop,
            CU_MEM_ALLOC_GRANULARITY_MINIMUM) != CUDA_SUCCESS)
        return nullptr;
    const size_t want = size > 0 ? (size_t)size : 1;
    Block b = {};
    b.mapped = (want + gran - 1) / gran * gran;
    b.va_size = b.mapped + 2 * gran;
    if (cuMemAddressReserve(&b.va, b.va_size, gran, 0, 0) != CUDA_SUCCESS)
        return nullptr;
    b.lo = b.va + gran;
    CUmemAccessDesc acc = {};
    acc.location = prop.location;
    acc.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
    if (cuMemCreate(&b.h, b.mapped, &prop, 0) != CUDA_SUCCESS) {
        cuMemAddressFree(b.va, b.va_size);
        return nullptr;
    }
    if (cuMemMap(b.lo, b.mapped, 0, b.h, 0) != CUDA_SUCCESS
            || cuMemSetAccess(b.lo, b.mapped, &acc, 1) != CUDA_SUCCESS
            || cuMemsetD8(b.lo, poison(), b.mapped) != CUDA_SUCCESS
            || cuCtxSynchronize() != CUDA_SUCCESS) {
        cuMemUnmap(b.lo, b.mapped);
        cuMemRelease(b.h);
        cuMemAddressFree(b.va, b.va_size);
        return nullptr;
    }
    void *p = (void *)(fence_end() ? b.lo + b.mapped - (want + 3) / 4 * 4
                                   : b.lo);
    blocks[p] = b;
    return p;
}

void fence_free(void *ptr, ssize_t, int, cudaStream_t) {
    std::lock_guard<std::mutex> g(mu);
    auto it = blocks.find(ptr);
    if (it == blocks.end()) return;
    const Block b = it->second;
    blocks.erase(it);
    cuCtxSynchronize();          // no queued work may touch it any more
    cuMemUnmap(b.lo, b.mapped);
    cuMemRelease(b.h);
    cuMemAddressFree(b.va, b.va_size);
}
}  // extern "C"
"""
# the nvcc define that builds the SW kernels' schedule fuzzing in
# (csrc/sw_common.cuh: sw::fuzz_delay)
FUZZ_DEFINE = "-DSW_SCHEDULE_FUZZ"
SW_KERNELS = ("sw_banded", "sw_banded16", "sw_banded_packed", "sw_batch")


def fence_library() -> str:
    return os.path.join(ROOT, "build", "ema_tpu_torch", "libfence_alloc.so")


def build_sanitize_support() -> None:
    """What the sanitize drives need beyond the kernels, built at once:
    the fence allocator (nvcc, linked against the driver API) and the four
    SW kernels with FUZZ_DEFINE (their own libraries: the flags are in
    their names' hash).  Raises if a build fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    from ema_tpu_torch.ops import _build

    so = fence_library()
    os.makedirs(os.path.dirname(so), exist_ok=True)
    src = so[:-3] + ".cu"
    with open(src, "w") as f:
        f.write(FENCE_ALLOC_SRC)
    fence = subprocess.Popen(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), "-std=c++17", "-O2",
         "-shared", "-Xcompiler", "-fPIC", src, "-o", so,
         "-L" + os.path.join(CUDA_HOME, "lib64", "stubs"), "-lcuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    flags = _build.NVCC_FLAGS
    try:
        _build.NVCC_FLAGS = flags + (FUZZ_DEFINE,)
        _build._compile(SW_KERNELS)
    finally:
        _build.NVCC_FLAGS = flags
    out, _ = fence.communicate()
    check(fence.returncode == 0, f"nvcc failed for the fence allocator:\n"
                                 f"{out}")


def sanitize_drive(path: str, fence: str = "", poison: int = 0xa5,
                   fuzz: bool = False) -> int:
    """Run every launch of the sets saved at ``path`` on the card and hold
    each to its plain version; the process the sanitizers watch.
    ``fence`` (end or start) installs the fence allocator with ``poison``;
    ``fuzz`` loads the SW kernels built with FUZZ_DEFINE.  Prints
    SANITIZE_OK and the launches by kernel.  Where ``path`` is missing, it
    is made first (``save_sanitize_sets``), on the CPU."""
    refuse_reference_imports()
    if not os.path.exists(path):
        save_sanitize_sets(path)
    if fence:
        if not os.path.exists(fence_library()):
            build_sanitize_support()
        os.environ.update(FENCE_SIDE=fence, FENCE_POISON=str(poison))
        alloc = torch.cuda.memory.CUDAPluggableAllocator(
            fence_library(), "fence_malloc", "fence_free")
        torch.cuda.memory.change_current_allocator(alloc)
    from ema_tpu_torch.ops import _build, probe
    from ema_tpu_torch.ops.sw import (KERNEL_OF, LAUNCHES, _plan_kernel,
                                      gather_score, reset_counts)

    if fuzz:
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + (FUZZ_DEFINE,)
    dev = torch.device("cuda")
    sets = torch.load(path)
    scorer_of = {v: k for k, v in KERNEL_OF.items()}
    reset_counts()
    probe.LAUNCHES.reset()
    for spec, c, want in sets:
        # the last line before a fault names the launch that made it
        print(f"launch {json.dumps(spec)}", flush=True)
        if spec["kernel"] == "alu_probe":
            got = probe.alu_probe(c["x"].to(dev), SAN_PROBE["K"],
                                  spec["unroll"], spec["probe_form"])
        else:
            c = {k: v.to(dev) for k, v in c.items()}
            scoring = SAN_SCORINGS[spec["scoring"]]
            scorer = scorer_of[spec["kernel"]]
            if spec.get("sorted"):
                got = _call(gather_score, c, scorer, scoring)
            else:
                got, launch = _plan_kernel(
                    c["text"], c["oriented"], c["olens"], c["owners"],
                    c["win_lo"], c["win_len"], c["wl"], scorer=scorer,
                    group=spec["group"], **scoring)
                launch()
        torch.cuda.synchronize()
        check(torch.equal(got.cpu(), want),
              f"{spec} differs from the plain version under the sanitize "
              f"drive (fence {fence or 'off'}, fuzz {fuzz})")
    launches = {k: c.value for k, c in LAUNCHES.items()}
    launches["alu_probe"] = probe.LAUNCHES.value
    print(f"{SANITIZE_OK} {json.dumps(launches)}", flush=True)
    return 0


def sanitizer_refusal_context(cs: str) -> str:
    """What a refusal of the card can be read against: the tool's version,
    the card's driver, the toolkit and the kernel the machine reports (a
    sandboxed kernel may not pass the tools' debugger interface on)."""
    from torch.utils.cpp_extension import CUDA_HOME

    def line(cmd, last=False):
        if shutil.which(cmd[0]) is None:
            return "(not found)"
        out = subprocess.run(cmd, capture_output=True, text=True).stdout
        lines = out.strip().splitlines() or ["(no output)"]
        return lines[-1] if last else lines[0]

    u = os.uname()
    driver = line(["nvidia-smi", "--query-gpu=driver_version",
                   "--format=csv,noheader"])
    nvcc = line([os.path.join(CUDA_HOME, "bin", "nvcc"), "--version"],
                last=True)
    return (f"compute-sanitizer {line([cs, '--version'], last=True)}; "
            f"driver {driver}; nvcc {nvcc}; torch CUDA {torch.version.cuda}"
            f"; kernel {u.sysname} {u.nodename} {u.release}; dmesg "
            f"{line(['dmesg'])}")


def _drive_cmd(path: str, *args) -> list:
    return [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
            "--sanitize-drive", path, *args]


def phase_sanitize(dev, card: str) -> dict:
    """Every instantiation of the five kernels (``sanitize_launches``: 86,
    and one sorted class call) in a subprocess that compute-sanitizer
    watches, once per tool (memcheck, racecheck, synccheck, initcheck;
    only the port's kernels instrumented, no leak check: torch's caching
    allocator keeps its blocks to the end), and under three checks on the
    card itself: every allocation fenced by unmapped memory on its upper
    side with its bytes poisoned 0xa5, then on its lower side poisoned
    0x5a (an access past either end of any buffer faults, a read of
    unwritten memory changes the output), and the SW kernels built with
    schedule fuzzing (a warp sleeps at random at each hand-over through
    shared memory).  Each run must hold every launch bit-exact to its
    plain version.  A tool that reports an error, or a report without its
    summary, fails the phase; a tool that declines the card (``Device not
    supported``) is reported as refused, and the card's checks stand for
    it.  Returns each kernel's ``sanitized`` record."""
    cs = compute_sanitizer()
    t0 = time.time()
    path = os.path.join(ROOT, "build", "ema_tpu_torch", "sanitize_sets.pt")
    specs = save_sanitize_sets(path)
    per_kernel = {k: sum(s["kernel"] == k and not s.get("sorted")
                         for s in specs) for k in KERNELS}
    log(f"sanitize sets: {len(specs) - 1} instantiations "
        f"({json.dumps(per_kernel)}) and one sorted class call, with their "
        f"plain outputs, in {time.time() - t0} s")
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    runs = {tool: [cs, "--tool", tool, "--error-exitcode", "1",
                   *sanitizer_filters(), *_drive_cmd(path)]
            for tool in SANITIZER_TOOLS}
    runs["fence_end"] = _drive_cmd(path, "--fence", "end", "--poison",
                                   "0xa5")
    runs["fence_start"] = _drive_cmd(path, "--fence", "start", "--poison",
                                     "0x5a")
    runs["fuzz"] = _drive_cmd(path, "--fuzz")
    t0 = time.time()
    logs = {name: os.path.join(os.path.dirname(path), f"sanitize_{name}.log")
            for name in runs}
    procs, ended = {}, {}
    try:
        for name, cmd in runs.items():
            with open(logs[name], "w") as f:
                procs[name] = subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT, text=True)
        while len(ended) < len(procs):
            for name, proc in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.time() - t0
            check(time.time() - t0 < 600, f"sanitize runs still going after "
                                          f"600 s: {set(procs) - set(ended)}")
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results, failed = {}, []
    for name, proc in procs.items():
        secs = ended[name]
        with open(logs[name]) as f:
            out = f.read()
        ok = re.search(SANITIZE_OK + r" (\{.*\})", out)
        launched = json.loads(ok.group(1)) if ok else None
        whole = (ok is not None and proc.returncode == 0
                 and launched["alu_probe"] == per_kernel["alu_probe"]
                 and sum(launched.values()) == len(specs) + 1)
        if name in SANITIZER_TOOLS:
            rep = sanitizer_report(out, name)
            if rep["status"] == "refused":
                results[name] = "refused: " + rep["line"]
            elif rep["status"] == "clean" and whole:
                results[name] = "0 errors"
            else:
                results[name] = f"{rep['errors']} errors"
                failed.append(name)
        elif whole:
            results[name] = "bit-exact"
        else:
            results[name] = f"failed (exit {proc.returncode})"
            failed.append(name)
        log(f"sanitize {name}: {results[name]} over {len(specs) - 1} "
            f"instantiations and the sorted call in {secs} s, launches "
            f"{launched}; card: {card}")
        if name in failed:
            log(f"sanitize {name} output (its end):\n{out[-3000:]}")
    log(f"sanitize: all runs in {time.time() - t0} s: {json.dumps(results)}")
    if any(r.startswith("refused") for r in results.values()):
        log("sanitize refused: " + sanitizer_refusal_context(cs))
    check(not failed, f"sanitize: {', '.join(failed)} failed")
    return {k: {"instantiations": per_kernel[k], **results}
            for k in KERNELS}


STREAM_SANITIZE_OK = "STREAM-SANITIZE-DRIVE-OK"
STREAM_PAIRS = 8192          # the main-path pass under the stream sanitizer


def _sanitize_every_thread(mode) -> dict:
    """Enter torch's stream-sanitizer dispatch ``mode`` in every thread
    started from here on (a dispatch mode is thread-local, and the
    Aligner's chunk workers are threads), and serialise its bookkeeping of
    each launch, which assumes one thread.  Returns the count of launches
    it checks by thread (a pool's workers under the pool's name)."""
    lock = threading.Lock()
    handle = mode.event_handler._handle_kernel_launch
    checked = {}

    def handle_locked(*args, **kwargs):
        name = threading.current_thread().name.split("_")[0]
        with lock:
            checked[name] = checked.get(name, 0) + 1
            return handle(*args, **kwargs)

    mode.event_handler._handle_kernel_launch = handle_locked
    run = threading.Thread.run

    def run_sanitized(self):
        with mode:
            run(self)

    threading.Thread.run = run_sanitized
    return checked


def stream_sanitize_drive() -> int:
    """The main path under torch's stream sanitizer (TORCH_CUDA_SANITIZER
    set before torch was imported): one pass of a reduced bench world
    (STREAM_PAIRS pairs in chunks of 2,048, 4 in flight, device EM on its
    side stream), one sharded candidate step at (data, cand) = (2, 2) over
    ["cuda:0"] * 4, and one pass of the 2-cell Aligner
    held to the first pass's records.  Every kernel launch of the port is
    handed to the sanitizer as the reads and the write it makes on its
    stream (ops/sw.LAUNCH_OBSERVERS).  Prints STREAM_SANITIZE_OK and the
    launches by stream; a data race raises CUDASanitizerErrors."""
    import torch.cuda._sanitizer as csan

    check(os.environ.get("TORCH_CUDA_SANITIZER") and
          csan.cuda_sanitizer.enabled,
          "torch's stream sanitizer is not enabled")
    refuse_reference_imports()
    from ema_tpu_torch import config
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.index import build_index
    from ema_tpu_torch.index.fm import FMIndexArrays
    from ema_tpu_torch.ops import sw
    from ema_tpu_torch.parallel import make_mesh, make_sharded_candidate_step
    from ema_tpu_torch.tools.bench import bench_world as world

    mode = csan.cuda_sanitizer.dispatch
    checked = _sanitize_every_thread(mode)
    handler = mode.event_handler
    seen = []

    def observe(kernel, stream, reads, writes):
        """A ctypes launch as the sanitizer's kernel launch: its reads and
        its write on ``stream``; also which buffers another stream wrote
        last (ordered before this launch, or the sanitizer raises)."""
        w = {t.data_ptr() for t in writes}
        r = {t.data_ptr() for t in reads} - w
        names = {t.data_ptr(): [f"{kernel} buffer {k}"]
                 for k, t in enumerate((*reads, *writes))}
        last = [handler.tensors_accessed.accesses.get(p) for p in r]
        crossed = sum(1 for a in last if a is not None and a.write
                      is not None and a.write.stream != stream)
        errors = handler._handle_kernel_launch(
            stream, r, w, w, f"{kernel} (ctypes launch)", names)
        seen.append((kernel, stream, threading.current_thread().name,
                     crossed))
        if errors:
            for e in errors:
                print(e, file=sys.stderr)
            raise csan.CUDASanitizerErrors(errors)

    sw.LAUNCH_OBSERVERS.append(observe)
    dev = torch.device("cuda:0")
    genome, pairs, _, _ = world(pairs=10_000)
    idx = build_index({"chr1": genome})
    pairs = tuple(col[:STREAM_PAIRS] for col in pairs)
    cfg = config.RunConfig(batch_size=2048, inflight_chunks=4,
                           device_em=True)
    runs = {}
    t0 = time.time()
    lines = Aligner(idx, cfg, device=dev).align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    torch.cuda.synchronize()
    runs["pass"] = (len(seen), time.time() - t0)
    check(len(lines) == 2 * len(pairs[0]), f"{len(lines)} records")

    fm = FMIndexArrays.from_index(idx, dev)
    text = torch.from_numpy(idx.text).to(dev)
    reads, lens = _step_reads(pairs, dev, n_rows=1024)
    n0, t0 = len(seen), time.time()
    step = make_sharded_candidate_step(make_mesh(2, 2, [str(dev)] * 4), fm,
                                       text, **STEP_STATIC)
    out = step(reads, lens)
    torch.cuda.synchronize()
    # phase_mesh holds the step bit-exact against one device
    check(int(out.n_aligned) > 0, "the 2 x 2 step aligned no read")
    runs["mesh 2x2"] = (len(seen) - n0, time.time() - t0)

    n0, t0 = len(seen), time.time()
    cells = Aligner(idx, cfg, device=dev, devices=[str(dev)] * 2)
    two = cells.align_batch_to_sam(ReadBatch.from_pairs(*pairs))
    torch.cuda.synchronize()
    check(two == lines, "the 2-cell Aligner's records differ from the "
                        "one-device pass's")
    runs["2-cell Aligner"] = (len(seen) - n0, time.time() - t0)
    launched = sum(c.value for c in sw.LAUNCHES.values())
    check(launched == len(seen) and launched > 0,
          f"{launched} kernel launches, {len(seen)} handed to the sanitizer")
    streams = {}
    for kernel, stream, thread, crossed in seen:
        key = f"{kernel} on stream {stream}"
        n, c, threads = streams.get(key, (0, 0, set()))
        streams[key] = (n + 1, c + crossed, threads | {thread.split("_")[0]})
    print(STREAM_SANITIZE_OK + " " + json.dumps({
        "runs": runs, "checked by thread": checked,
        "launches": {k: {"launches": n, "buffers written last by another "
                         "stream": c, "threads": sorted(t)}
                     for k, (n, c, t) in streams.items()}}), flush=True)
    return 0


def phase_stream_sanitize(dev, card: str) -> None:
    """``stream_sanitize_drive`` in a subprocess with TORCH_CUDA_SANITIZER
    set before torch is imported, behind the import finder: any data race
    the sanitizer reports fails the phase."""
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--stream-sanitize-drive"], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, TORCH_CUDA_SANITIZER="1"))
    out = r.stdout + r.stderr
    with open(os.path.join(ROOT, "build", "ema_tpu_torch",
                           "stream_sanitize.log"), "w") as f:
        f.write(out)
    ok = re.search(STREAM_SANITIZE_OK + r" (\{.*\})", r.stdout)
    check(r.returncode == 0 and ok and "CSAN detected" not in out,
          f"stream sanitizer (exit {r.returncode}):\n{out[-6000:]}")
    report = json.loads(ok.group(1))
    for name, (n, secs) in report["runs"].items():
        log(f"stream sanitize [{name}]: 0 races over {n} kernel launches "
            f"and every torch operation, {secs} s under the sanitizer; "
            f"card: {card}")
    log(f"stream sanitize: launches checked (torch's and the port's) by "
        f"thread: {json.dumps(report['checked by thread'])}")
    for key, st in report["launches"].items():
        log(f"stream sanitize: {key}: {json.dumps(st)}")
    log(f"stream sanitize: {time.time() - t0} s in all")


def ptxas_functions(text: str) -> list:
    """(kernel, registers, spill-store bytes) of each entry function that
    ``ptxas -v`` reports, the kernel named by its template arguments
    where it has them."""
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"([a-z][a-z0-9_]*_kernel)I(\w+?)E+v",
                          m.group(1))
            fn = [f"{t.group(1)}<{t.group(2)}>" if t else m.group(1), 0, 0]
            out.append(fn)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            fn[2] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            fn[1] = int(m.group(1))
    return [tuple(f) for f in out]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sanitize-drive", metavar="SETS",
                    help="run the launches saved at SETS (phase_sanitize's "
                         "subprocess; SETS is made first where it is "
                         "missing)")
    ap.add_argument("--fence", choices=("end", "start"), default="")
    ap.add_argument("--poison", type=lambda v: int(v, 0), default=0xa5)
    ap.add_argument("--fuzz", action="store_true")
    ap.add_argument("--stream-sanitize-drive", action="store_true",
                    help="phase_stream_sanitize's subprocess")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card\n")
        return 1
    if args.sanitize_drive:
        return sanitize_drive(args.sanitize_drive, args.fence, args.poison,
                              args.fuzz)
    if args.stream_sanitize_drive:
        return stream_sanitize_drive()
    refuse_reference_imports()
    from ema_tpu_torch import native
    from ema_tpu_torch.ops import _build
    from ema_tpu_torch.utils.backend import gpu_info, resolve_device

    dev = resolve_device("cuda")
    card = gpu_info()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(dev)}"
        f", card: {card}")
    t0 = time.time()
    native.get_lib()
    log(f"native library {native._so_path().name} built/loaded with g++ in "
        f"{time.time() - t0} s")
    t0 = time.time()
    # the fence allocator and the schedule-fuzzed SW kernels of
    # phase_sanitize, built beside the kernels in a process of their own
    san_build = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.refuse_reference_imports(); "
         "chip_smoke.build_sanitize_support()"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: san_build.poll() is None and san_build.kill())
    _build.load_all()
    log(f"kernels {', '.join(KERNELS)} built/loaded in {time.time() - t0} s")
    for name in KERNELS:
        fns = ptxas_functions(_build.ptxas_log(name))
        log(f"ptxas {name}: {len(fns)} kernels, registers "
            f"{[f[1] for f in fns]}, spill stores "
            f"{sum(f[2] for f in fns)} bytes")
        if name == "sw_banded":
            for fn, regs, spill in fns:
                log(f"ptxas {name} {fn}: {regs} registers, {spill} bytes "
                    f"spill stores")

    t_start = time.time()

    def phase(fn, *args):
        t0 = time.time()
        out = fn(*args)
        log(f"phase {fn.__name__}: {time.time() - t0} s")
        return out

    def sanitize_support():
        out, _ = san_build.communicate(timeout=600)
        check(san_build.returncode == 0,
              f"building the sanitize checks failed:\n{out[-4000:]}")
        log(f"fence allocator and schedule-fuzzed SW kernels ready "
            f"{time.time() - t0} s after the kernels' build began (built "
            f"beside it)")

    from ema_tpu_torch.index import build_index
    kstats = phase(phase_kernel, dev, card)
    sanitize_support()
    sanitized = phase(phase_sanitize, dev, card)
    t0 = time.time()
    genome, pairs, truth, bc_strs = bench_world()
    idx = build_index({"chr1": genome})
    log(f"bench world: {idx.n} bp, {len(pairs[0])} pairs, sa_rate "
        f"{idx.sa_rate}, built in {time.time() - t0:.1f} s")
    phase(phase_fm, dev, card, genome, idx, pairs)
    phase(phase_em, dev, card, idx, pairs)
    phase(phase_golden, dev)
    main_stats, default_lines, recorded = phase(
        phase_main_path, dev, card, idx, pairs, truth)
    phase(phase_recorded, dev, card, idx, recorded)
    del recorded
    phase(phase_device_em, dev, card, idx, pairs, truth, default_lines)
    phase(phase_profile, dev, card, idx, pairs)
    phase(phase_seed_device, dev, card, idx, pairs, truth, default_lines)
    phase(phase_long_reads, dev)
    phase(phase_cli, dev)
    kstats["alu_probe"] = phase(phase_bench_sw, dev, card)
    _, x_body = phase(phase_x, dev, card, genome, pairs, truth, bc_strs)
    phase(phase_sharded, dev, card)
    phase(phase_mesh, dev, card, idx, pairs, default_lines)
    phase(phase_multihost, dev, card, idx, genome, pairs, bc_strs, x_body)
    phase(phase_tools, dev, card, idx, pairs)
    phase(phase_stream_sanitize, dev, card)

    torch.cuda.synchronize()
    loaded = reference_modules_loaded()
    check(not loaded, f"modules of jax or ema_tpu were imported: {loaded}")
    log(f"all phases: {time.time() - t_start} s")
    launches = {k: main_stats[s]["launches"] for s, k in MAIN_KERNEL.items()}
    launches["alu_probe"] = kstats["alu_probe"]["launches"]
    log("main path pairs/s: " + ", ".join(
        f"{s} {main_stats[s]['pairs_per_s']}" for s in MAIN_KERNEL)
        + f", card: {card}")
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": kstats[name]["max_abs_err"],
        # ms: the wrapper's call; launch_ms: its kernel launches alone
        "ms": kstats[name]["ms"],
        "launch_ms": kstats[name].get("launch_ms", kstats[name]["ms"]),
        **({"mask_launch_ms": kstats[name]["mask_launch_ms"]}
           if "mask_launch_ms" in kstats[name] else {}),
        "plain_ms": kstats[name]["plain_ms"],
        "bound_ms": kstats[name]["bound_ms"],
        "bound_by": kstats[name]["bound_by"],
        # no PyTorch call computes a banded affine-gap Smith-Waterman with
        # these tie rules, or the probe's chains
        "library_ms": None,
        "sanitized": sanitized[name]}
        for name, (_, source, replaces) in KERNELS.items()]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
