"""SW-kernel micro-benchmark and int32 roofline of the port, at pipeline
shapes: the port of tools/bench_sw.py.

    python -m ema_tpu_torch.tools.bench_sw [cpu] [--json OUT.json]

Without ``cpu`` it runs on the first CUDA card (and fails if there is
none) at the JAX tool's SHAPE, B = 16,384 candidates of m = 100 read bases
against n = 192-base windows with a W = 128-lane band; ``cpu`` runs the
plain versions on the CPU at B = 64 and takes no probe step.
EMA_TPU_BENCH_SW_B sets B in either mode.  Steps, in order, each under
the JAX tool's name where it has one:

  banded-pallas      the sw_banded kernel at W (ops/sw.gather_score)
  banded-packed      sw_banded_packed with _case_wl's corridors
  banded16           sw_banded16 (a kernel the JAX tool never timed)
  pallas             sw_batch, the whole window
  banded-scan        sw_score_banded_ref, the plain row sweep, same device
  scan               sw_score_batch_ref, the plain anti-diagonal sweep
  banded-packed-ref  the wl-masked plain sweep, banded-packed's contract
  vpu-probe          the int32 ALU probe (ops/probe.py), alu, dpx and s16x2
                     forms; what each s16x2 operation compiles to; the
                     SASS instructions a cell of the SW kernels' loops
  wl-sample          corridor widths of the port's Aligner on a 400 kbp
                     world, from a chaining.chain_hits spy

The JAX tool's banded-pallas-t128/-t512/-t1024 steps set the Pallas
grid's tile_b; the CUDA kernels have no such knob, so they have no
counterpart.  The kernels score a device text, not a [B, n] refs array,
so the case's windows are laid end to end as the text (``gather_layout``).
Steps run in this process, one after another; the artifact is rewritten
after each, and a step that fails (or a variant that disagrees) raises,
so the tool exits non-zero.  On a card every time is taken with CUDA
events and every number stands beside the card's name and power limit.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ema_tpu_torch.ops import _build, probe
from ema_tpu_torch.ops.sw import (KERNEL_SYMBOL, gather_score,
                                  sw_score_banded_ref, sw_score_batch_ref)

SHAPE = (16384, 100, 192, 128)      # B, m, n, W (tools/bench_sw.py:33)
CPU_B = 64
ITERS = 5
SW_KW = dict(match=1, mismatch=4, gap_open=6, gap_extend=1, clip=5)
OUTS = ("score", "qb", "qe", "ref_end")
# the variants whose outputs must agree bit for bit (banded-packed is held
# to banded-packed-ref instead: its contract is the wl-masked corridor)
EXACT = ("banded-pallas", "banded16", "pallas", "banded-scan", "scan")

# Static int32 op count per banded DP cell of csrc/sw_banded.cu's one-pass
# row sweep at W = 128 (the large call's form there: 16 threads x 8
# lanes), by the JAX tool's rule (one unit per elementwise op, select,
# compare or shuffle; a max is one op, ``c ? a : b`` on a fresh compare
# two):
#   part 1, per lane: the score (a prmt, and a quarter of the quad's) 1.25,
#     vertical open/extend 2, F 1, its start 2, max(H, fresh) 1, Hd 1,
#     Sd 2, H0 1, S0 2, the scan value 1, the thread aggregate 3 = 17.25;
#   part 2, per lane: E 2, max(E, F) 1, H 1, SH 4, the scan value 1, the
#     running prefix 3, H/F masked 2, the end-of-read add 1, the lane's
#     best 4 = 19;
#   per thread and row, over its 8 lanes: the loop and the staged loads
#     6, 7 shuffles 7, the segment edge 6, the score word 4, the selector
#     shifts 2, fresh, end and the tail-row test 5, the 4-step carry scan
#     28, the exclusive shift 5 = 63, so 7.9 a cell.
# 17.25 + 19 + 7.9 = 44.1, counted as 44 (the former two-pass sweep: 102).
BANDED_OPS_PER_CELL = 44
# The fewest integer instructions a cell of that recurrence admits on
# sm_90 (csrc/sw_banded.cu:16-20 with the start rows its outputs need), with
# the DPX instructions, counted by hand for a sequential sweep with no
# second pass: what bounds any kernel of this function, not what this one
# emits.  The fusion that counts here is the min/max with a predicate
# output (__vibmax_s32(a, b, &pred), one VIMNMX): every maximum whose
# start row the outputs need is that one instruction and one select on
# its predicate, not max + compare + select.  VIADDMNMX (max(a + b, c))
# and VIMNMX3 (max(a, b, c)) give no predicate, so they save nothing
# where a start row follows the maximum, which is everywhere here.  (As
# compiled for sm_90a, __vibmax_s32 comes out as ISETP + SEL, three
# instructions with the start row's select: ``cell_loops`` and
# ``s16x2_forms`` print what ptxas emits beside this count.)  Each line
# gives all its instructions and, of them, the adds: an add can issue as
# an IMAD on the multiply-add pipe, beside the integer pipe that every
# compare, min/max, select, bitwise op and byte permute needs.
#   sub-score: one byte permute of a word of four score bytes (one per
#     base of the row or column; all -1 for an N) by the other side's
#     selector, as sw_batch.cu and sw_banded16.cu do it              1, 0
#   Hd = max(H[i-1][k], fresh) + sub: max with predicate, add        2, 1
#     its start row: select                                          1, 0
#   F = max(H[i-1][k+1] - go - ge, F[i-1][k+1] - ge): 2 adds, max    3, 2
#     its start row: select                                          1, 0
#   H0 = max(Hd, F) and its start row: max, select                   2, 0
#   scan value H0 + k ge, k ge a per-lane constant: add              1, 1
#   running horizontal prefix (value, start): max, select            2, 0
#   E = P - (k ge + go), the subtrahend a per-lane constant          1, 1
#   EF = max(E, F) and its start: max, select                        2, 0
#   H = max(Hd, EF) and its start (diag >= horizontal >= vertical):
#     max, select                                                    2, 0
#   best cell of the lane: max with predicate, 2 selects (row, start;
#     or, per row, column and start packed: an or and a select)      3, 0
# 21 a cell, 5 of them adds, so 16 for the integer pipe.  Not counted,
# because the function does not need them per
# cell: validity (i + k <= nl is a prefix of a row's lanes, and always
# true where the window holds rl + wl columns, as every chained call's
# does), the NEG kept in invalid H and F, the end-of-read adjustment (0
# on the last row, -clip on every other: the last row can be offered
# apart), and the window base of the next row (a move that belongs to a
# register layout).  The s16x2 kernel is counted at two cells an
# instruction (10.5 and 8 a cell), select on two predicates included, at
# the int32 rates: the probe's s16x2 form measures 97% of them.  The
# whole-window scorer has no corridor scan: its horizontal gap is
# E = max(H[i][j-1] - go - ge, E[i][j-1] - ge) with its start (4, 2 of
# them adds) in place of H0, the scan value, the prefix and E (6, 2
# adds): 19 and 14.
# kernel -> (all instructions a cell, those only the integer pipe takes)
MIN_INSTR_PER_CELL = {"sw_banded": (21, 16), "sw_banded16": (10.5, 8),
                      "sw_banded_packed": (21, 16), "sw_batch": (19, 14)}
# the probe's chain step as ptxas emits it: LOP3 and VIADDMNMX
PROBE_INSTR_PER_STEP = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# int32 results per clock per SM at compute capability 9.0 for 32-bit
# integer add, compare/min/max and bitwise ops: the throughput table of
# the CUDA C++ Programming Guide ("Arithmetic Instructions").
INT32_OPS_PER_CLOCK_PER_SM = 64
# Instructions of any kind an SM issues a clock: its 4 schedulers issue
# one warp instruction (32 threads) each.  Integer work can fill them:
# 32-bit multiply-add (IMAD, which also adds and moves) has a pipe of its
# own with 64 results a clock and SM in the same table.
SCHED_SLOTS_PER_CLOCK_PER_SM = 128
K_CHECK = 256              # rounds of the probe's check against its plain
PROBE_SAMPLE = 4           # full-K elements checked against the plain
# the integer SASS opcodes of the probe's chain steps
INT_OPCODES = ("LOP3", "IADD3", "VIADD", "IMNMX", "VIMNMX", "VIADDMNMX")
# the never-launched one-operation kernels of csrc/alu_probe.cu
S16X2_FORMS = ("base", "vcmpges2", "vcmpgts2", "vadd2", "vsub2", "vmaxs2",
               "vibmax_s16x2", "viaddmax_s16x2", "vimax3_s16x2", "sign_mask")
# The inner loop of each SW kernel at the thread form the recorded chained
# call (100 bp reads, corridors of 50) takes, and the cells one pass of the
# loop covers per thread: (library, mangled-name part, cells).
def _fn(kernel: str, args: str) -> str:
    """The mangled-name part of one instantiation of a kernel's
    __global__ function (ops/sw.KERNEL_SYMBOL)."""
    return f"{KERNEL_SYMBOL[kernel]}I{args}E"


CELL_LOOPS = {
    "sw_batch 8x13": ("sw_batch", _fn("sw_batch", "Li13ELi8E"), 13),
    "sw_batch 32x4": ("sw_batch", _fn("sw_batch", "Li4ELi32E"), 4),
    "sw_banded16 8x8": ("sw_banded16", _fn("sw_banded16", "Li4ELi8ELi1E"),
                        8),
    "sw_banded16 32x2": ("sw_banded16",
                         _fn("sw_banded16", "Li1ELi32ELi1E"), 2),
    # the large call's form and the small call's (csrc/sw_banded.cu)
    "sw_banded 8x8": ("sw_banded", _fn("sw_banded", "Li8ELi8ELi1ELb1E"), 8),
    "sw_banded 32x2": ("sw_banded", _fn("sw_banded", "Li2ELi32ELi1ELb1E"),
                       2),
    "sw_banded_packed 8x8": ("sw_banded_packed",
                             _fn("sw_banded_packed", "Li8ELi8E"), 8),
    "sw_banded_packed 16x4": ("sw_banded_packed",
                              _fn("sw_banded_packed", "Li4ELi16E"), 4),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_case(B, m, n, W):
    """tools/bench_sw.py:71-84: reads planted in random windows with 3
    substitutions each."""
    rng = np.random.default_rng(0)
    reads = rng.integers(0, 4, (B, m)).astype(np.int32)
    refs = rng.integers(0, 4, (B, n)).astype(np.int32)
    rlens = np.full(B, m, np.int32)
    nlens = np.full(B, n, np.int32)
    off = rng.integers(0, min(W - 8, n - m), B)
    for b in range(B):
        o = int(off[b])
        refs[b, o:o + m] = reads[b]
        for _ in range(3):
            p = rng.integers(0, m)
            refs[b, o + p] = (refs[b, o + p] + 1) % 4
    return reads, rlens, refs, nlens


def _case_wl(B):
    """tools/bench_sw.py:87-91: pipeline-like corridors, a clipped normal
    within the packed tier's 64 lanes."""
    rng = np.random.default_rng(1)
    return np.clip(rng.normal(50, 10, B), 8, 64).astype(np.int32)


def gather_layout(reads, rlens, refs, nlens, wl, device) -> dict:
    """The case as gather_score's inputs: the B windows laid end to end
    as the text (window b at b * n), read b its own owner."""
    B, n = refs.shape

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return dict(text=put(refs.reshape(-1), np.uint8),
                oriented=put(reads, np.uint8), olens=put(rlens, np.int32),
                owners=put(np.arange(B), np.int32),
                win_lo=put(np.arange(B, dtype=np.int64) * n, np.int64),
                win_len=put(nlens, np.int32), wl=put(wl, np.int32))


def _gather(layout, scorer):
    c = layout
    return gather_score(c["text"], c["oriented"], c["olens"], c["owners"],
                        c["win_lo"], c["win_len"], c["wl"], scorer=scorer,
                        **SW_KW)


def _timed(fn, device, iters):
    """(output of a warm-up call, mean ms of ``iters`` more calls):
    CUDA events on a card, the host clock on the CPU."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        return out, t0.elapsed_time(t1) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return out, (time.perf_counter() - t0) / iters * 1e3


def max_sm_clock_mhz() -> float:
    """The first card's max SM clock, from nvidia-smi."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(r.stdout.strip().splitlines()[0])


def int32_instr_per_s(device) -> float:
    """The card's peak int32 instruction rate: SMs x max SM clock x
    INT32_OPS_PER_CLOCK_PER_SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max_sm_clock_mhz() * 1e6 * INT32_OPS_PER_CLOCK_PER_SM


def bound_ms(instructions: float, int_pipe_instructions: float,
             n_bytes: float, int32_per_s: float):
    """The least time the card could take, at its peak rates: the largest
    of all the instructions over its issue slots, those that only the
    integer pipe takes over its int32 rate ``int32_per_s``
    (``int32_instr_per_s``), and the bytes (each input read once, each
    output written once) over its memory rate.  Returns (ms, "operations"
    or "bytes")."""
    slots_per_s = (int32_per_s * SCHED_SLOTS_PER_CLOCK_PER_SM
                   / INT32_OPS_PER_CLOCK_PER_SM)
    t_ops = max(instructions / slots_per_s,
                int_pipe_instructions / int32_per_s) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _sass_functions(so_path) -> dict:
    """``cuobjdump -sass`` of a library: mangled function name -> its
    instructions in order, as (address, opcode, the branch target or
    None)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", str(so_path)],
                       capture_output=True, text=True, check=True,
                       timeout=300)
    out, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = re.search(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"(.*)", line)
        if m and fn:
            target = None
            if m.group(2) == "BRA":
                t = re.search(r"0x([0-9a-f]+)", m.group(3))
                target = int(t.group(1), 16) if t else None
            out[fn].append((int(m.group(1), 16), m.group(2), target))
    return out


def _one_function(kernel: str, function: str) -> list:
    found = [v for k, v in _sass_functions(_build._so_path(kernel)).items()
             if function in k]
    if not found or not found[0]:
        raise RuntimeError(f"no SASS for {function} in {kernel}")
    return found[0]


def sass_opcodes(kernel: str, function: str) -> dict:
    """Opcode counts of the function of ``kernel``'s library whose mangled
    name contains ``function``, from ``cuobjdump -sass``: what the
    compiler emitted for it."""
    counts = collections.Counter(op for _, op, _ in
                                 _one_function(kernel, function))
    return dict(counts.most_common())


def sass_loop(kernel: str, function: str) -> dict:
    """The main loop of a function, read from its SASS: the widest span
    closed by a backward branch (the row or step loop; every loop inside
    it is unrolled).  Returns the function's instruction count, the
    loop's (NOPs left out) and the loop's opcode counts; ``loop`` is None
    where no backward branch was found."""
    return _loop_of(_one_function(kernel, function))


def _loop_of(ins: list) -> dict:
    spans = [(addr - target, target, addr) for addr, op, target in ins
             if op == "BRA" and target is not None and target <= addr]
    res = {"total": sum(op != "NOP" for _, op, _ in ins), "loop": None,
           "loop_opcodes": {}}
    # a span that holds the function's exit or a store is not the loop
    addr_of = {op: [a for a, o, _ in ins if o == op] for op in ("EXIT",
                                                                 "STG")}
    spans = [sp for sp in spans
             if not any(sp[1] <= a <= sp[2] for v in addr_of.values()
                        for a in v)]
    if spans:
        _, lo, hi = max(spans)
        body = collections.Counter(op for addr, op, _ in ins
                                   if lo <= addr <= hi and op != "NOP")
        res["loop"] = sum(body.values())
        res["loop_opcodes"] = dict(body.most_common())
    return res


def sass_loops_in(so_path, stem: str) -> dict:
    """``sass_loop`` of every function of the library at ``so_path`` whose
    mangled name contains ``stem``, keyed by its template arguments (the
    ``I...E`` part of the name): for a library built from another
    checkout's source (tools/ab_smoke.py --sass)."""
    out = {}
    for fn, ins in _sass_functions(so_path).items():
        if stem in fn and ins:
            m = re.search(re.escape(stem) + r"I(\w+?)E+v", fn)
            out[m.group(1) if m else fn] = _loop_of(ins)
    return out


def cell_loops() -> dict:
    """The SASS instructions a cell of each SW kernel's inner loop at the
    thread forms of the recorded chained call (CELL_LOOPS): the loop's
    static instruction count over the cells one pass covers per thread,
    and the IMADs among them, beside the hand count MIN_INSTR_PER_CELL.  Static: a branch not taken
    (a tail row, a lane guard) counts as if it were."""
    out = {}
    for label, (kernel, function, cells) in CELL_LOOPS.items():
        loop = sass_loop(kernel, function)
        per_cell = None if loop["loop"] is None else loop["loop"] / cells
        # IMAD (multiply-add, adds and moves) issues beside the integer pipe
        imad = sum(v for k, v in loop["loop_opcodes"].items()
                   if k.startswith("IMAD")) / cells
        out[label] = dict(loop, cells_per_pass=cells,
                          sass_instr_per_cell=per_cell,
                          sass_imad_per_cell=imad,
                          hand_count=MIN_INSTR_PER_CELL[kernel])
        log(f"sass [{label}]: {loop['loop']} instructions in the loop of "
            f"{loop['total']} / {cells} cells = {per_cell} a cell, {imad} "
            f"of them IMAD (hand count, all and integer pipe only: "
            f"{MIN_INSTR_PER_CELL[kernel]}); loop opcodes "
            f"{loop['loop_opcodes']}")
    return out


def s16x2_forms() -> dict:
    """What each s16x2 operation of sw_banded16.cu compiles to: the opcode
    counts of its one-operation kernel and its instructions beyond the
    `base` kernel's (which holds one LOP3 for its xor)."""
    base = sass_opcodes("alu_probe", "s16x2_form_base")
    n_base = sum(v for k, v in base.items() if k != "NOP")
    out = {}
    for form in S16X2_FORMS:
        ops = sass_opcodes("alu_probe", f"s16x2_form_{form}")
        n = sum(v for k, v in ops.items() if k != "NOP")
        extra = {k: v - base.get(k, 0) for k, v in ops.items()
                 if k != "NOP" and v != base.get(k, 0)}
        out[form] = {"instructions": n - n_base + 1, "beyond_base": extra}
        log(f"s16x2 form {form}: {n - n_base + 1} instructions; opcodes "
            f"beyond base {extra}")
    return out


def s16x2_instr_per_s(device, K: int = 2048) -> tuple:
    """The card's measured rate of the probe's s16x2 chain step (a LOP3
    and a packed add-max, as ptxas emits them): (instructions/s, SASS
    integer instructions a step, ms of the timed run)."""
    n = probe.card_elements(device)
    x = torch.arange(n, dtype=torch.int32, device=device)
    U = probe.UNROLL_TPU
    _, ms = _timed(lambda: probe.alu_probe(x, K, U, "s16x2"), device, 3)
    ops_sass = sass_opcodes("alu_probe", f"alu_probe_kernelILi{U}ELi2EE")
    per_step = sum(v for k, v in ops_sass.items()
                   if k in INT_OPCODES or k.startswith("VI")) / (
        U * probe.CHAINS)
    steps = probe.probe_ops(n, K, U) // 3
    return steps * per_step / (ms * 1e-3), per_step, ms


def step_probe(device) -> dict:
    """The probe on a card-filling grid: both forms bit-exact against
    alu_probe_ref over the whole grid at K_CHECK rounds (timed beside the
    plain version there), then timed at the TPU tool's K with every
    timed output held to the plain version on a sample of elements
    and the two forms held to each other."""
    n = probe.card_elements(device)
    x = torch.arange(n, dtype=torch.int32, device=device)
    U = probe.UNROLL_TPU
    want, plain_ms = _timed(lambda: probe.alu_probe_ref(x, K_CHECK, U),
                            device, 1)
    res = {"probe_elements": n, "probe_unroll": U, "probe_k_check": K_CHECK,
           "probe_k": probe.K_TPU, "alu_probe_plain_ms": plain_ms}
    want16, plain16_ms = _timed(
        lambda: probe.alu_probe_s16x2_ref(x, K_CHECK, U), device, 1)
    res["s16x2_probe_plain_ms"] = plain16_ms
    for form in probe.FORMS:
        got, ms = _timed(lambda: probe.alu_probe(x, K_CHECK, U, form),
                         device, ITERS)
        ref = want16 if form == "s16x2" else want
        err = int((got.long() - ref.long()).abs().max())
        if err:
            raise RuntimeError(f"vpu-probe: the {form} form differs from "
                               f"its plain version at K={K_CHECK} (max "
                               f"abs err {err})")
        res[f"{form}_k_check_ms"] = ms
        res[f"{form}_max_abs_err"] = err
    sample = torch.linspace(0, n - 1, PROBE_SAMPLE).long()
    want_full = {
        form: (probe.alu_probe_s16x2_ref if form == "s16x2"
               else probe.alu_probe_ref)(x[sample].cpu(), probe.K_TPU, U)
        for form in probe.FORMS}
    ops = probe.probe_ops(n, probe.K_TPU, U)
    outs = {}
    for form in probe.FORMS:
        best = float("inf")
        for r in range(4):                 # a warm-up, then 3 timed
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = probe.alu_probe(x, probe.K_TPU, U, form)
            t1.record()
            torch.cuda.synchronize(device)
            if not torch.equal(out[sample].cpu(), want_full[form]):
                raise RuntimeError(f"vpu-probe: the {form} form differs "
                                   f"from its plain version at "
                                   f"K={probe.K_TPU}")
            if r:
                best = min(best, t0.elapsed_time(t1))
        outs[form] = out
        res[f"{form}_ms"] = best
        res[f"{form}_int32_tops"] = ops / (best * 1e-3) / 1e12
    if not torch.equal(outs["alu"], outs["dpx"]):
        raise RuntimeError("vpu-probe: the alu and dpx forms differ at the "
                           "full K")
    res["vpu_int32_tops_measured"] = res["alu_int32_tops"]
    res["dpx_int32_tops_measured"] = res["dpx_int32_tops"]
    props = torch.cuda.get_device_properties(device)
    clock = max_sm_clock_mhz()
    res.update(sm_count=props.multi_processor_count,
               sm_clock_max_mhz=clock,
               int32_ops_per_clock_per_sm=INT32_OPS_PER_CLOCK_PER_SM,
               int32_tops_theoretical=int32_instr_per_s(device) / 1e12)
    # what ptxas made of each form's UNROLL = 32 body: integer
    # instructions per counted chain step (3 ops), and the instruction rate
    for form in probe.FORMS:
        ops_sass = sass_opcodes(
            "alu_probe",
            f"alu_probe_kernelILi{U}ELi{probe.FORMS.index(form)}EE")
        per_step = sum(v for k, v in ops_sass.items()
                       if k in INT_OPCODES or k.startswith("VI")) / (
            U * probe.CHAINS)
        res[f"{form}_sass"] = ops_sass
        res[f"{form}_sass_int_instr_per_step"] = per_step
        res[f"{form}_int32_instr_tera_per_s"] = (
            res[f"{form}_int32_tops"] * per_step / 3)
    res["sw_banded_sass_w128"] = sass_opcodes(     # the 16 x 8 lane form
        "sw_banded", _fn("sw_banded", "Li8ELi16ELi1ELb1"))
    res["s16x2_forms"] = s16x2_forms()
    res["cell_loops"] = cell_loops()
    log(f"vpu-probe s16x2: {res['s16x2_ms']} ms, "
        f"{res['s16x2_sass_int_instr_per_step']} SASS integer instructions "
        f"a step, {res['s16x2_int32_instr_tera_per_s']} T packed "
        f"instructions/s (two int16 lanes each) against the int32 form's "
        f"{res['alu_int32_instr_tera_per_s']}")
    log(f"vpu-probe: {n} elements, K={probe.K_TPU} x {U}: alu "
        f"{res['alu_ms']} ms = {res['alu_int32_tops']} Tops/s, dpx "
        f"{res['dpx_ms']} ms = {res['dpx_int32_tops']} Tops/s (3 ops a "
        f"step; SASS integer instructions a step: alu "
        f"{res['alu_sass_int_instr_per_step']}, dpx "
        f"{res['dpx_sass_int_instr_per_step']}, so "
        f"{res['alu_int32_instr_tera_per_s']} and "
        f"{res['dpx_int32_instr_tera_per_s']} T instructions/s); "
        f"theoretical {res['int32_tops_theoretical']} Tops/s "
        f"({props.multi_processor_count} SMs x {clock} MHz x "
        f"{INT32_OPS_PER_CLOCK_PER_SM}); at K={K_CHECK}: kernel "
        f"{res['alu_k_check_ms']} ms, plain {plain_ms} ms, bit-exact")
    return res


def step_wl_sample(device) -> dict:
    """Per-candidate corridors (wl) of real chaining on the 400 kbp world
    of tools/bench_sw.py:239-244, through the port's Aligner (on the CPU
    with the native scorer: wl comes from chaining, not from scoring)."""
    from ema_tpu_torch import config
    from ema_tpu_torch.index import build_index
    from ema_tpu_torch.ops import chaining
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.core.pipeline import Aligner
    from ema_tpu_torch.tools import simulate as sim

    rng = np.random.default_rng(7)
    genome = sim.rand_genome(rng, 400_000)
    idx = build_index({"chr1": genome})
    ids, _, bcs, s1, q1, s2, q2, _ = sim.simulate_pairs(
        rng, sim.to_str(genome), n_barcodes=33, frags_per_bc=(2, 4),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100, err=0.003)
    samples = []
    orig = chaining.chain_hits

    def spy(*a, **kw):
        cands = orig(*a, **kw)
        if len(samples) < 64:
            samples.append(np.asarray(cands.wl).copy())
        return cands

    chaining.chain_hits = spy
    try:
        aligner = Aligner(idx, config.RunConfig(), device=device,
                          sw_impl="native" if device.type == "cpu" else None)
        aligner.align_batch_to_sam(ReadBatch.from_pairs(
            ids, bcs, s1, q1, s2, q2))
    finally:
        chaining.chain_hits = orig
    allwl = np.concatenate(samples) if samples else np.zeros(0)
    allwl = allwl[allwl > 0]
    W = SHAPE[3]
    res = {"pipeline_wl_mean": float(allwl.mean()),
           "pipeline_wl_p95": float(np.percentile(allwl, 95)),
           "pipeline_wl_samples": int(allwl.size),
           "band_padding_waste_factor": W / float(allwl.mean())}
    log(f"wl-sample: mean {res['pipeline_wl_mean']} p95 "
        f"{res['pipeline_wl_p95']} over {res['pipeline_wl_samples']} "
        f"candidates: a fixed {W}-lane band pads "
        f"{res['band_padding_waste_factor']}x")
    return res


def run(device, B=None, out_json=None) -> dict:
    """Every step on ``device`` at batch ``B`` (SHAPE's on a card,
    CPU_B on the CPU); returns the artifact, also written to ``out_json``
    after each step when given."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    B = B or (SHAPE[0] if on_card else CPU_B)
    _, m, n, W = SHAPE
    art = {"what": "SW kernel micro-benchmark + int32 roofline (port)",
           "shape": {"B": B, "m": m, "n": n, "W": W},
           "device": (torch.cuda.get_device_name(device) if on_card
                      else "cpu"), "variants": {}}
    if on_card:
        from ema_tpu_torch.utils.backend import gpu_info
        art["card"] = gpu_info()

    def flush():
        if out_json:
            with open(out_json, "w") as f:
                json.dump(art, f, indent=1)

    reads, rlens, refs, nlens = make_case(B, m, n, W)
    wl_full = np.full(B, W, np.int32)
    wl_case = _case_wl(B)
    lay = gather_layout(reads, rlens, refs, nlens, wl_full, device)
    lay_wl = dict(lay, wl=lay["wl"].new_tensor(wl_case))
    raw = [torch.from_numpy(a).to(device) for a in (reads, rlens, refs,
                                                    nlens)]
    raw_wl = torch.from_numpy(wl_full).to(device)
    steps = {
        "banded-pallas": lambda: _gather(lay, "banded"),
        "banded-packed": lambda: _gather(lay_wl, "packed"),
        "banded16": lambda: _gather(lay, "banded16"),
        "pallas": lambda: _gather(lay, "scan"),
        "banded-scan": lambda: sw_score_banded_ref(*raw, W, wl=raw_wl,
                                                   **SW_KW),
        "scan": lambda: sw_score_batch_ref(*raw, **SW_KW),
        "banded-packed-ref": lambda: sw_score_banded_ref(
            *raw, W, wl=lay_wl["wl"], **SW_KW),
    }
    outs = {}
    bcells, cells = B * m * W, B * m * n
    for name, fn in steps.items():
        out, ms = _timed(fn, device, ITERS if on_card else 1)
        outs[name] = out.cpu().numpy()
        c = bcells if "banded" in name else cells
        res = {"ms": ms, "gcells_per_s": c / ms / 1e6,
               "full_window_gcells_per_s": cells / ms / 1e6,
               "device": art["device"]}
        if name == "banded-packed":
            # equiv128 compares with banded-pallas; corridor counts only
            # the in-band cells
            res["equiv128_gcells_per_s"] = bcells / ms / 1e6
            res["physical_gcells_per_s"] = B * m * 64 / ms / 1e6
            res["corridor_gcells_per_s"] = float(
                (m * wl_case.astype(np.int64)).sum()) / ms / 1e6
        if name != "banded-packed-ref":
            art["variants"][name] = res
        log(f"{name}: {ms} ms, {res['gcells_per_s']} Gcell/s on "
            f"{art.get('card', art['device'])}")
        flush()

    mism = [[EXACT[0], v, k] for v in EXACT[1:]
            for i, k in enumerate(OUTS)
            if not np.array_equal(outs[EXACT[0]][:, i], outs[v][:, i])]
    art["bit_exact_across_variants"] = not mism
    if mism:
        art["mismatches"] = mism
    pk = [k for i, k in enumerate(OUTS) if not np.array_equal(
        outs["banded-packed"][:, i], outs["banded-packed-ref"][:, i])]
    art["packed_bit_exact_vs_wl_masked_ref"] = not pk
    if pk:
        art["packed_mismatch_keys"] = pk
    flush()

    if on_card:
        art.update(step_probe(device))
        flush()
    art.update(step_wl_sample(device))
    art["banded_ops_per_cell_static"] = BANDED_OPS_PER_CELL
    art["min_instr_per_cell"] = MIN_INSTR_PER_CELL
    if on_card:
        best = art["variants"]["banded-pallas"]["gcells_per_s"]
        ach = best * 1e9 * BANDED_OPS_PER_CELL
        art["banded_int32_tops_achieved"] = ach / 1e12
        art["banded_roofline_pct"] = 100.0 * ach / (
            art["vpu_int32_tops_measured"] * 1e12)
        art["banded_roofline_pct_of_theoretical"] = 100.0 * ach / (
            art["int32_tops_theoretical"] * 1e12)
        log(f"sw_banded: {best} Gcell/s x {BANDED_OPS_PER_CELL} ops = "
            f"{art['banded_int32_tops_achieved']} Tops/s, "
            f"{art['banded_roofline_pct']}% of the probe's "
            f"{art['vpu_int32_tops_measured']} Tops/s, "
            f"{art['banded_roofline_pct_of_theoretical']}% of the "
            f"theoretical {art['int32_tops_theoretical']}; card: "
            f"{art['card']}")
    flush()
    if mism or pk:
        raise RuntimeError(f"bench_sw: variants disagree: {mism or pk}")
    return art


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "cpu" in argv[:1]
    out_json = "BENCH_SW_torch.json"
    if "--json" in argv:
        out_json = argv[argv.index("--json") + 1]
    if not cpu and not torch.cuda.is_available():
        log("bench_sw: no CUDA card (torch.cuda.is_available() is false); "
            "`cpu` runs the plain versions")
        return 1
    env_b = os.environ.get("EMA_TPU_BENCH_SW_B")
    run("cpu" if cpu else "cuda", int(env_b) if env_b else None, out_json)
    log(f"wrote {out_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
