"""ema_tpu_torch: the single-host workflow of ema_tpu in PyTorch, for one
NVIDIA GPU.

The JAX package ``ema_tpu`` stays the reference, and this package imports
nothing of it.  It keeps its own copies, under the same module names, of
the host layers (the native C++ library, index build, preprocessing,
chaining, traceback, barcode groups and EM on the host, scoring, SAM
emission, config) and replaces what ran on the TPU: every Pallas kernel
is a hand-written CUDA kernel (``ops/csrc/``) with a plain PyTorch
version beside it, and the jitted device programs (the cloud EM, the
FM-index ops) are torch code.  ``cli.py`` carries the ``count``,
``preproc``, ``index``, ``align`` and ``samdiff`` modes.
"""

from ema_tpu_torch.index.build import ReferenceIndex, build_index  # noqa: F401

__version__ = "0.1.0"
