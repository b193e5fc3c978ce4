"""Frozen arithmetic of the benchmark: the card's peaks, the least time
of an SW launch and the union of device intervals.  Later changes to the
program leave these as they are; they are copies, not imports, of the
port's tools.
"""

from __future__ import annotations

# Peaks by the name torch.cuda.get_device_name() gives.  H100 SXM5:
# 132 SMs at up to 1,980 MHz, HBM3 at 3.35 TB/s (NVIDIA's data sheet).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "max_sm_clock_mhz": 1980.0,
                              "hbm_bytes_per_s": 3.35e12},
}
# int32 add, compare/min/max and bitwise results per clock and SM at
# compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
# Instructions"), and warp instructions of any kind issued per clock and
# SM (4 schedulers x 32 threads).  From ema_tpu_torch/tools/bench_sw.py.
INT32_OPS_PER_CLOCK_PER_SM = 64
SCHED_SLOTS_PER_CLOCK_PER_SM = 128
# kernel -> (instructions a DP cell needs at the least, those of them
# only the integer pipe takes): the hand count of
# ema_tpu_torch/tools/bench_sw.MIN_INSTR_PER_CELL.  sw_batch scores the
# whole window (rl x window cells), the banded kernels their corridor
# (rl x wl cells).
MIN_INSTR_PER_CELL = {"sw_banded": (21, 16), "sw_banded16": (10.5, 8),
                      "sw_banded_packed": (21, 16), "sw_batch": (19, 14)}
# kernel -> the __global__ function by which a profiler trace names it
# (ema_tpu_torch/ops/sw.KERNEL_SYMBOL)
KERNEL_SYMBOL = {"sw_banded": "sw_banded_kernel",
                 "sw_banded16": "sw_banded16_kernel",
                 "sw_banded_packed": "sw_banded_packed_kernel",
                 "sw_batch": "sw_batch_kernel"}
# bytes an SW candidate moves at the least besides its read and window:
# owner (4), window start (8), window length (4), corridor (4), and its
# result of four int32 (16)
SW_CANDIDATE_BYTES = 36


def bound_s(kernel: str, cells: float, n_bytes: float, peak: dict) -> float:
    """The least time the card could take for ``cells`` DP cells of
    ``kernel`` moving ``n_bytes``: the larger of all instructions over
    the issue slots, integer-pipe instructions over the int32 rate, and
    the bytes over the memory rate (bench_sw.bound_ms)."""
    int32_per_s = (peak["sms"] * peak["max_sm_clock_mhz"] * 1e6
                   * INT32_OPS_PER_CLOCK_PER_SM)
    slots_per_s = (int32_per_s * SCHED_SLOTS_PER_CLOCK_PER_SM
                   / INT32_OPS_PER_CLOCK_PER_SM)
    instr, int_pipe = MIN_INSTR_PER_CELL[kernel]
    t_ops = max(cells * instr / slots_per_s, cells * int_pipe / int32_per_s)
    return max(t_ops, n_bytes / peak["hbm_bytes_per_s"])


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def span(merged) -> float:
    return sum(e - s for s, e in merged)
