"""The cloud-EM kernel's wrapper: one upload, one launch of
csrc/em_cloud.cu and one readback for every EM-gated group of a dispatch.

``launch`` takes the flat pack of core/em.pack_states (its arrays in the
order of the kernel's arguments), writes it into a pinned staging buffer,
and queues on ``stream`` one copy to the card, the launch and one copy of
the gammas back into pinned memory, then an event.  Each staging set (the
pinned input, the device buffer and the pinned output) is taken from a
pool for the launch and goes back to it on ``Pending.release``, once the
caller has read the gammas, so that concurrent dispatches on one Aligner
(``align -x --no-coalesce -j N``) never share one.  Sets grow to the
largest dispatch they have served and are reused.

The plain version is core/em.em_run_flat (the pack unflattened, em_run,
flattened).  A CUDA device always launches the kernel; a failed build or
launch raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ema_tpu_torch import config
from ema_tpu_torch.ops.sw import LaunchCounter

# launches of csrc/em_cloud.cu (CUDA only)
LAUNCHES = LaunchCounter()
# the kernel's __global__ function, by which a profiler trace finds it
KERNEL_SYMBOL = "em_cloud_kernel"
# the most dynamic shared memory a launch asks for (kMaxSmem of the
# kernel's source, which refuses more)
SMEM_MAX = 48 * 1024
# the pack's arrays in the order of em_cloud_launch's arguments, with the
# dtype the kernel reads each as
FIELDS = (("e_off", np.int32), ("k_off", np.int32), ("cand_off", np.int32),
          ("mate", np.int32), ("score", np.float64), ("cloud", np.int32),
          ("chrom", np.int32), ("pos", np.int64), ("flags", np.uint8),
          ("comp", np.int32), ("cloud_cand_off", np.int32),
          ("cloud_cands", np.int32), ("comp_cloud_off", np.int32),
          ("comp_clouds", np.int32))
_ALIGN = 16


def smem_plan(n_cand: np.ndarray, n_clouds: np.ndarray
              ) -> Tuple[int, np.ndarray]:
    """(the launch's dynamic shared memory in bytes, which groups keep
    their gammas and cloud planes in it) for groups of ``n_cand``
    candidates and ``n_clouds`` clouds: 8 bytes a candidate and 16 a
    cloud, the largest need up to SMEM_MAX; a larger group works in the
    output and the scratch."""
    need = 8 * (np.asarray(n_cand, np.int64)
                + 2 * np.asarray(n_clouds, np.int64))
    small = need[need <= SMEM_MAX]
    smem = int(small.max()) if small.size else 0
    return smem, need <= smem


def _layout(arrays: Sequence[np.ndarray]) -> Tuple[List[int], int]:
    """Byte offsets of the arrays in the input buffer, and its size."""
    offs, at = [], 0
    for a in arrays:
        offs.append(at)
        at += -(-a.nbytes // _ALIGN) * _ALIGN
    return offs, at


def flat_bytes(arrays: Sequence[np.ndarray]) -> int:
    """Bytes a launch must move: its input once and its gammas once."""
    return sum(a.nbytes for a in arrays) + 8 * arrays[4].size


def _grow(n: int) -> int:
    return max(1 << 16, 1 << (max(n, 1) - 1).bit_length())


class _Staging:
    """One launch's buffers: pinned input, device buffer (input, gammas,
    scratch) and pinned gammas."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host_in = self.dev = self.host_out = None

    def fit(self, in_bytes: int, dev_bytes: int, n_out: int) -> None:
        if self.host_in is None or self.host_in.numel() < in_bytes:
            self.host_in = torch.empty(_grow(in_bytes), dtype=torch.uint8,
                                       pin_memory=True)
        if self.dev is None or self.dev.numel() < dev_bytes:
            self.dev = torch.empty(_grow(dev_bytes), dtype=torch.uint8,
                                   device=self.device)
        if self.host_out is None or self.host_out.numel() < n_out:
            self.host_out = torch.empty(_grow(n_out), dtype=torch.float64,
                                        pin_memory=True)


_pool: Dict[torch.device, List[_Staging]] = {}
_pool_lock = threading.Lock()


class Pending:
    """A queued launch.  ``wait()`` blocks on its event and returns the
    flat gammas, a view of the pinned readback that stays valid until
    ``release()`` hands the staging set back to the pool."""

    def __init__(self, staging: _Staging, done: torch.cuda.Event, n: int):
        self._staging, self._done, self._n = staging, done, n

    def wait(self) -> np.ndarray:
        self._done.synchronize()
        return self._staging.host_out[:self._n].numpy()

    def release(self) -> None:
        with _pool_lock:
            _pool[self._staging.device].append(self._staging)


def launch(arrays: Sequence[np.ndarray], many: bool, device: torch.device,
           stream: torch.cuda.Stream) -> Pending:
    """Queue the EM of the pack ``arrays`` (``FIELDS``' order and dtypes)
    on ``stream``: one copy up, one launch, one copy back, an event."""
    from ema_tpu_torch.ops import _build

    if device.type != "cuda":
        raise ValueError(f"em_cloud.launch: not a CUDA device: {device}")
    for (name, dtype), a in zip(FIELDS, arrays, strict=True):
        if a.dtype != dtype or not a.flags.c_contiguous or a.ndim != 1:
            raise ValueError(f"em_cloud.launch: {name} must be contiguous "
                             f"1-D {np.dtype(dtype).name} (got {a.dtype})")
    e_off, k_off, cand_off = arrays[:3]
    G, N, K = e_off.size - 1, arrays[4].size, arrays[9].size
    if (G < 1 or e_off[-1] != arrays[3].size or cand_off.size != e_off[-1]
            + 1 or cand_off[-1] != N or k_off[-1] != K):
        raise ValueError("em_cloud.launch: the offsets do not match the "
                         "arrays")
    if max(N, K, int(e_off[-1])) >= 1 << 31:
        raise ValueError("em_cloud.launch: more than 2**31 candidates, "
                         "clouds or entries")
    smem, _ = smem_plan(cand_off[e_off[1:]] - cand_off[e_off[:-1]],
                        np.diff(k_off))
    lib = _build.load_library("em_cloud")
    offs, in_bytes = _layout(arrays)
    out_at = in_bytes
    scratch_at = out_at + -(-8 * N // _ALIGN) * _ALIGN
    dev_bytes = scratch_at + 16 * K
    with _pool_lock:
        free = _pool.setdefault(device, [])
        stg = free.pop() if free else _Staging(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        stg.fit(in_bytes, dev_bytes, N)
        host = stg.host_in.numpy()
        for a, off in zip(arrays, offs):
            host[off:off + a.nbytes] = a.view(np.uint8)
        stg.dev[:in_bytes].copy_(stg.host_in[:in_bytes], non_blocking=True)
        base = stg.dev.data_ptr()
        rc = lib.launch(*(base + off for off in offs), base + out_at,
                        base + scratch_at, G, int(many), config.EM_ITERS,
                        config.INSERT_MIN, config.INSERT_MAX,
                        config.UNPAIRED_PENALTY, smem, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"em_cloud kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES.add()
        out = stg.dev[out_at:out_at + 8 * N].view(torch.float64)
        stg.host_out[:N].copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return Pending(stg, done, N)
