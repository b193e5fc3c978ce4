"""ema_tpu_torch: the align path of ema_tpu in PyTorch, for one NVIDIA GPU.

The JAX package ``ema_tpu`` stays the reference.  This package imports its
jax-free host layers as they are (the native C++ library, index build,
chaining, traceback, barcode groups and EM on the host, scoring, SAM
emission, config) and replaces what ran on the TPU: the banded
Smith-Waterman scorer is a hand-written CUDA kernel
(``ops/csrc/sw_banded.cu``) with a plain PyTorch version beside it.  It
never imports jax.
"""

from ema_tpu.index.build import ReferenceIndex, build_index  # noqa: F401

__version__ = "0.1.0"
