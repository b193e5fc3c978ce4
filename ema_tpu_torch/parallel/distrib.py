"""Bucket-to-host assignment and coordinate-sorted SAM merging.

The jax-free half of ema_tpu/parallel/distrib.py:45-147, copied under its
names: the port cannot import that module, because
ema_tpu/parallel/__init__.py imports step.py, which imports jax.
``init_distributed`` and ``allreduce_counts`` (jax.distributed) wait for
the port's multi-host slice.
"""

from __future__ import annotations

import heapq
import os
from typing import Iterable, List, Optional, Sequence


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
