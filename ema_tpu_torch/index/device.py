"""The index state the port keeps on the device.

The system has no learned weights: what both packages must share to
compute the same thing is the host index (``ema_tpu.index.build.
ReferenceIndex``, numpy arrays) and ``config.AlignerParams``.  Seeding
and locate stay on the host and read the numpy arrays directly; the SW
kernel reads the 2-bit forward text from the device, the counterpart of
``text_dev`` at ema_tpu/core/pipeline.py:247.
"""

from __future__ import annotations

import torch


def to_device_state(index, device: torch.device) -> torch.Tensor:
    """``index.text`` (uint8 [n] 2-bit codes) as a tensor on ``device``."""
    return torch.from_numpy(index.text).to(device=device,
                                           dtype=torch.uint8).contiguous()
