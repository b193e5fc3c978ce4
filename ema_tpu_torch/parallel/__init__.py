"""Multi-device and multi-host parallelism for the port
(ema_tpu/parallel/__init__.py).

The reference scales out at the shell level: GNU parallel over barcode
bucket files plus OpenMP threads inside one process (reference:
README.md:91-155, src/main.c:396-412).  Here the same three levels map to:

  - devices within a host: a ``DeviceMesh`` with a ``data`` axis for
    read batches and a ``cand`` axis for per-read candidate windows
    (``ema_tpu_torch.parallel.step``), and the Aligner's row split
    (``core/pipeline.Aligner(devices=...)``),
  - hosts: barcode buckets hashed to processes
    (``ema_tpu_torch.parallel.distrib``), one process per host joined by
    ``torch.distributed`` over gloo,
  - collectives: summed preproc priors over the processes instead of
    files-on-disk merging.

``distrib``'s collectives import ``torch.distributed`` when called, not
here.
"""

from ema_tpu_torch.parallel.mesh import make_mesh, mesh_axes  # noqa: F401
from ema_tpu_torch.parallel.step import (  # noqa: F401
    candidate_core, make_sharded_candidate_step)
