"""The int32 peak-ALU probe: the CUDA kernel's wrapper and its plain
PyTorch version.

The port of the Pallas kernel ``kern`` of tools/bench_sw.py:
child_vpu_probe (:193-206), the denominator of the banded SW kernels'
roofline share.  Each element x runs 8 independent chains
``acc_j = x + j`` through K rounds of ``unroll`` steps
``acc_j = max(acc_j ^ (i + u), acc_j + j)`` (i = 1..K, u = 0..unroll-1),
and the chains are xor-folded into the output.  Counted, as the TPU tool
counts, at 3 int32 ops per chain step (``probe_ops``).

``alu_probe`` launches csrc/alu_probe.cu on a CUDA tensor, in the ``alu``
form (xor, add and max as three instructions), the ``dpx`` form
(``__viaddmax_s32``) or the ``s16x2`` form (the same recurrence on the two
int16 halves of every element, ``__viaddmax_s16x2``: the packed
instructions of the int16 SW kernel); on a CPU tensor it runs
``alu_probe_ref`` or, for ``s16x2``, ``alu_probe_s16x2_ref``.  A failed
build or launch raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ema_tpu_torch.ops.sw import LaunchCounter

CHAINS = 8
K_TPU, UNROLL_TPU = 1 << 14, 32      # the TPU tool's constants (:190)
UNROLLS = (1, 2, 4, 8, 16, 32)       # the unroll counts the kernel takes
FORMS = ("alu", "dpx", "s16x2")      # the kernel's form argument: 0, 1, 2
# launches of csrc/alu_probe.cu by ``alu_probe`` (CUDA tensors only)
LAUNCHES = LaunchCounter()
# the kernel's __global__ function (ops/sw.KERNEL_SYMBOL for the SW kernels)
KERNEL_SYMBOL = "alu_probe_kernel"


def probe_ops(n_elements: int, K: int, unroll: int) -> int:
    """int32 ops of one probe run: elements x K x 8 x unroll x 3."""
    return n_elements * K * CHAINS * unroll * 3


def card_elements(device: torch.device) -> int:
    """Elements that fill the card: every SM at its resident-thread
    limit, one element per thread."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def alu_probe_ref(x: torch.Tensor, K: int, unroll: int) -> torch.Tensor:
    """The recurrence in torch int32 ops, the 8 chains stacked on a new
    leading axis; returns int32 of x's shape."""
    x = x.to(torch.int32)
    j = torch.arange(CHAINS, dtype=torch.int32, device=x.device).view(
        CHAINS, *([1] * x.dim()))
    acc = x.unsqueeze(0) + j
    for i in range(1, K + 1):
        for u in range(unroll):
            acc = torch.maximum(acc ^ (i + u), acc + j)
    tot = acc[0]
    for a in acc[1:]:
        tot = tot ^ a
    return tot


def alu_probe_s16x2_ref(x: torch.Tensor, K: int, unroll: int) -> torch.Tensor:
    """The s16x2 form in torch int16 ops: every int32 element is two int16
    halves, each running the recurrence on its own with the constants j
    and i + u in both halves and every add wrapping at 16 bits; returns
    int32 of x's shape."""
    h = x.to(torch.int32).contiguous().view(torch.int16)
    j = torch.arange(CHAINS, dtype=torch.int16, device=x.device).view(
        CHAINS, *([1] * h.dim()))
    acc = h.unsqueeze(0) + j
    for i in range(1, K + 1):
        for u in range(unroll):
            c = torch.tensor(i + u, dtype=torch.int32).to(torch.int16)
            acc = torch.maximum(acc ^ c.to(x.device), acc + j)
    tot = acc[0]
    for a in acc[1:]:
        tot = tot ^ a
    return tot.contiguous().view(torch.int32).reshape(x.shape)


def alu_probe(x: torch.Tensor, K: int, unroll: int,
              form: str = "alu") -> torch.Tensor:
    """The probe of every element of int32 ``x``.  CUDA: the kernel in
    ``form``; CPU: ``alu_probe_ref`` (which the alu and dpx forms equal)
    or ``alu_probe_s16x2_ref``."""
    if form not in FORMS:
        raise ValueError(f"alu_probe: unknown form {form!r} (one of "
                         f"{', '.join(FORMS)})")
    if unroll not in UNROLLS:
        raise ValueError(f"alu_probe: unroll must be one of {UNROLLS}")
    if K < 0:
        raise ValueError("alu_probe: K must be >= 0")
    if x.dtype != torch.int32:
        raise ValueError(f"alu_probe: x must be int32 (got {x.dtype})")
    if x.device.type == "cpu":
        ref = alu_probe_s16x2_ref if form == "s16x2" else alu_probe_ref
        return ref(x, K, unroll)
    if x.device.type != "cuda":
        raise ValueError(f"alu_probe: unsupported device {x.device}")
    from ema_tpu_torch.ops import _build

    lib = _build.load_library("alu_probe")
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.launch(x.data_ptr(), out.data_ptr(), x.numel(), K, unroll,
                        FORMS.index(form), stream)
    if rc != 0:
        raise RuntimeError(f"alu_probe kernel launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return out
