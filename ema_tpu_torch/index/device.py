"""The index state the port keeps on the device.

The system has no learned weights: what both packages must share to
compute the same thing is the host index (``ema_tpu.index.build.
ReferenceIndex``, numpy arrays) and ``config.AlignerParams``.  The SW
kernels read the 2-bit forward text from the device, the counterpart of
``text_dev`` at ema_tpu/core/pipeline.py:247; device seeding and locate
read the FM arrays, the counterpart of ``fma`` (pipeline.py:246).  Host
seeding and locate read the numpy arrays directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ema_tpu_torch.index.fm import FMIndexArrays


class DeviceState(NamedTuple):
    text: torch.Tensor              # uint8 [n] 2-bit forward text
    fm: Optional[FMIndexArrays]     # None unless asked for


def to_device_state(index, device: torch.device,
                    fm: bool = False) -> DeviceState:
    """``index.text`` as a tensor on ``device`` and, with ``fm``, the
    FM-index arrays beside it (by their layout, about 3 GB for an index
    at the 2^30-base limit of build_index, so they are uploaded only for
    device seeding or locate)."""
    text = torch.from_numpy(index.text).to(device=device,
                                           dtype=torch.uint8).contiguous()
    return DeviceState(
        text, FMIndexArrays.from_index(index, device) if fm else None)
