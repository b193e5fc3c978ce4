"""Multi-host orchestration: buckets -> hosts, collectives, shard merge
(ema_tpu/parallel/distrib.py).

The reference scales across machines with GNU parallel over bucket files
and merges per-bucket BAMs with `sambamba merge` (README.md:94-155: the
filesystem is the interconnect).  The port's equivalents:

  - one process per host, joined by ``torch.distributed`` over gloo
    (``init_distributed``; the JAX package's jax.distributed);
  - whole barcode buckets hashed to hosts (``buckets_for_host``), so no
    barcode's reads ever span hosts and cloud/EM state needs no cross-host
    merge: the same invariant the reference gets from its bucket files;
  - global preprocessing priors summed across the processes
    (``allreduce_counts`` replaces merging .ema-ncnt files on disk,
    SURVEY.md §5.8 (i));
  - per-host sorted SAM shards merged by key (``merge_sorted_shards``,
    the analog of `sambamba merge`).

The counts are host numpy arrays: gloo carries them over TCP, and no
NCCL is needed.
"""

from __future__ import annotations

import heapq
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens at ``coordinator`` (host:port), over gloo; without a
    coordinator and with no group already joined, a no-op.

    Returns (process_id, process_count): (0, 1) for a single process.
    """
    import torch.distributed as dist

    if coordinator is not None and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator needs the "
                             "number of processes and this process's id")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def allreduce_counts(counts: np.ndarray) -> np.ndarray:
    """Sum per-host count vectors across processes (preproc priors).

    Single process: identity.  Several: every process's vector is
    gathered and the stack summed over its first axis in rank order, as
    the JAX package's ``process_allgather(...).sum(axis=0)``, so float64
    priors add up in the same order (a gloo all_reduce promises no order
    past two ranks).  Replaces the reference's on-disk merge of .ema-ncnt
    files (correct.cc:288-337).
    """
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return counts
    local = torch.from_numpy(np.ascontiguousarray(counts))
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return np.stack([p.numpy() for p in parts]).sum(axis=0)


def buckets_for_host(paths: Sequence[str], process_id: int,
                     process_count: int) -> List[str]:
    """Deterministic bucket -> host assignment (round-robin over sorted).

    Whole buckets (i.e. whole barcodes) go to one host, preserving the
    reference's invariant that a barcode group is processed in one place
    (preproc bucketing, correct.cc:374-412).
    """
    return [p for i, p in enumerate(sorted(paths))
            if i % process_count == process_id]


def shard_path(out_path: str, process_id: int, process_count: int) -> str:
    """Per-host SAM shard name: out.sam -> out.shard03of08.sam."""
    base, ext = os.path.splitext(out_path)
    return f"{base}.shard{process_id:02d}of{process_count:02d}{ext}"


def _sam_sort_key(line: str, chrom_order: dict) -> tuple:
    f = line.split("\t", 5)
    chrom = f[2]
    return (chrom_order.get(chrom, len(chrom_order)), int(f[3]), f[0])


def sort_sam_lines(lines: Iterable[str],
                   chrom_names: Sequence[str]) -> List[str]:
    """Coordinate-sort SAM body lines (chrom order, pos, name)."""
    order = {n: i for i, n in enumerate(chrom_names)}
    return sorted(lines, key=lambda ln: _sam_sort_key(ln, order))


def merge_sorted_shards(shard_paths: Sequence[str], out_path: str,
                        chrom_names: Sequence[str],
                        header: Optional[str] = None) -> int:
    """K-way merge of coordinate-sorted per-host SAM shards.

    Header lines (@...) are taken from ``header`` if given, else from the
    first shard; body lines stream through a heap merge.  Returns the
    number of body records written.
    """
    with open(out_path, "w") as out:
        return merge_sorted_streams(out, shard_paths, chrom_names, header)


def merge_sorted_streams(out, shard_paths: Sequence[str],
                         chrom_names: Sequence[str],
                         header: Optional[str] = None) -> int:
    """Stream a k-way merge of sorted SAM shards into an open file object.

    Memory stays O(k): one pending line per shard in the heap.  Shard
    header lines are skipped (the first shard's are used only when no
    ``header`` is given).
    """
    order = {n: i for i, n in enumerate(chrom_names)}
    streams = []
    first_header: List[str] = []
    for k, p in enumerate(shard_paths):
        fh = open(p)
        body = []
        for line in fh:
            if line.startswith("@"):
                if k == 0:
                    first_header.append(line)
            else:
                body.append(line)
                break
        streams.append(_chain_first(body, fh))

    n = 0
    if header is not None:
        out.write(header)
    else:
        out.writelines(first_header)
    for line in heapq.merge(
            *streams, key=lambda ln: _sam_sort_key(ln, order)):
        out.write(line)
        n += 1
    return n


def _chain_first(first: List[str], fh):
    yield from first
    for line in fh:
        if not line.startswith("@"):
            yield line
    fh.close()
