"""Contig-sharded reference indexes for genomes beyond the int32 limit.

One FM-index shard per contig group of <= MAX_SHARD_BASES (~1 Gbp: both
strands of a shard must fit int32 BWT rows) (SURVEY.md §5.7: the CP-like
analog for genome scale — GRCh38's 3.1 Gbp does not fit int32 positions).  Each shard is a self-contained ReferenceIndex over a slice
of the contig list; contig numbering is global, and the aligner queries
every shard and merges candidates, recomputing cross-shard uniqueness /
second-best statistics (the reference instead relies on BWA's single
64-bit index; reference src/bwabridge.c:77-96).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

from ema_tpu_torch.index.build import (DEFAULT_SA_RATE, ReferenceIndex,
                                       build_index, index_from_arrays,
                                       parse_fasta)

MAX_SHARD_BASES = 2**30 - 2**24   # both strands of a shard fit int32 rows


@dataclasses.dataclass
class ShardedIndex:
    """Facade over contig-sharded ReferenceIndex shards.

    ``contig_base[s]`` is the global index of shard s's first contig.
    Exposes the global ``names``/``lengths`` the pipeline needs.
    """

    shards: List[ReferenceIndex]
    contig_base: List[int]

    @property
    def names(self) -> List[str]:
        return [n for sh in self.shards for n in sh.names]

    @property
    def lengths(self) -> np.ndarray:
        return np.concatenate([sh.lengths for sh in self.shards]) \
            if self.shards else np.zeros(0, np.int64)

    @property
    def n(self) -> int:
        return int(sum(sh.n for sh in self.shards))

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for i, sh in enumerate(self.shards):
            sh.save(os.path.join(path, f"shard{i:03d}.npz"))

    @classmethod
    def load(cls, path: str) -> "ShardedIndex":
        shards = []
        i = 0
        while True:
            p = os.path.join(path, f"shard{i:03d}.npz")
            if not os.path.exists(p):
                break
            shards.append(ReferenceIndex.load(p))
            i += 1
        base, acc = [], 0
        for sh in shards:
            base.append(acc)
            acc += sh.n_contigs
        return cls(shards, base)


def sharded_index_from_arrays(shards: List[dict]) -> ShardedIndex:
    """A ``ShardedIndex`` from one ``index_from_arrays`` dict per shard,
    in shard order."""
    subs = [index_from_arrays(a) for a in shards]
    base, acc = [], 0
    for sh in subs:
        base.append(acc)
        acc += sh.n_contigs
    return ShardedIndex(subs, base)


def _shard_groups(contigs: Dict[str, np.ndarray],
                  max_shard_bases: int) -> List[Dict[str, np.ndarray]]:
    groups: List[Dict[str, np.ndarray]] = []
    cur: Dict[str, np.ndarray] = {}
    cur_bases = 0
    for name, arr in contigs.items():
        if arr.shape[0] > max_shard_bases:
            raise ValueError(
                f"contig {name!r} ({arr.shape[0]} bases) exceeds the "
                f"{max_shard_bases}-base shard limit")
        if cur and cur_bases + arr.shape[0] > max_shard_bases:
            groups.append(cur)
            cur, cur_bases = {}, 0
        cur[name] = arr
        cur_bases += arr.shape[0]
    if cur:
        groups.append(cur)
    return groups


def build_index_sharded(contigs: Dict[str, np.ndarray] | str,
                        sa_rate: int = DEFAULT_SA_RATE,
                        max_shard_bases: int = MAX_SHARD_BASES,
                        seed: int = 11) -> ShardedIndex:
    """Greedily pack contigs into <= max_shard_bases FM-index shards."""
    if isinstance(contigs, str):
        contigs = parse_fasta(contigs)
    groups = _shard_groups(contigs, max_shard_bases)
    shards = [build_index(g, sa_rate=sa_rate, seed=seed) for g in groups]
    base, acc = [], 0
    for sh in shards:
        base.append(acc)
        acc += sh.n_contigs
    return ShardedIndex(shards, base)


# fork-shared state for the parallel shard build: children inherit the
# parsed contig arrays copy-on-write instead of pickling gigabytes
_FORK_STATE: dict = {}


def _build_one_shard(i: int) -> int:
    groups, out_dir, sa_rate, seed = (
        _FORK_STATE["groups"], _FORK_STATE["out_dir"],
        _FORK_STATE["sa_rate"], _FORK_STATE["seed"])
    idx = build_index(groups[i], sa_rate=sa_rate, seed=seed)
    idx.save(os.path.join(out_dir, f"shard{i:03d}.npz"))
    return i


def build_and_save_sharded(contigs: Dict[str, np.ndarray] | str,
                           out_dir: str,
                           sa_rate: int = DEFAULT_SA_RATE,
                           max_shard_bases: int = MAX_SHARD_BASES,
                           seed: int = 11,
                           n_workers: int | None = None) -> "ShardedIndex":
    """Build shards in parallel processes and save them to ``out_dir``.

    Each worker builds + writes one shard (the reference delegates to a
    single `bwa index` run; shards give genome-scale builds linear
    speedup in host cores).  Returns the loaded ShardedIndex.
    """
    import multiprocessing as mp

    if isinstance(contigs, str):
        contigs = parse_fasta(contigs)
    groups = _shard_groups(contigs, max_shard_bases)
    os.makedirs(out_dir, exist_ok=True)
    if n_workers is None:
        n_workers = min(len(groups), os.cpu_count() or 1)
    if n_workers <= 1 or len(groups) <= 1:
        for i, g in enumerate(groups):
            idx = build_index(g, sa_rate=sa_rate, seed=seed)
            idx.save(os.path.join(out_dir, f"shard{i:03d}.npz"))
    else:
        _FORK_STATE.update(groups=groups, out_dir=out_dir,
                           sa_rate=sa_rate, seed=seed)
        try:
            ctx = mp.get_context("fork")
            with ctx.Pool(n_workers) as pool:
                pool.map(_build_one_shard, range(len(groups)))
        finally:
            _FORK_STATE.clear()
    return ShardedIndex.load(out_dir)
