"""Host-side batch containers of the align path.

Copied from ema_tpu/core/pipeline.py:39-41 (``_BASE_LUT``) and :131-188
(``ReadBatch``, ``CandidateSet``): that module imports jax, so the port
keeps its own jax-free copies under the same names.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _BASE_LUT[_b] = _c


@dataclasses.dataclass
class ReadBatch:
    """P read pairs, host-side."""

    ids: List[str]
    bc: np.ndarray               # uint64 [P]
    seqs: List[str]              # [2P], mate-interleaved (2*i + mate)
    quals: List[str]
    codes: np.ndarray            # uint8 [2P, L]
    lens: np.ndarray             # int32 [2P]

    @classmethod
    def from_pairs(cls, ids, bcs, seq1, qual1, seq2, qual2) -> "ReadBatch":
        P = len(ids)
        # mate-interleave via slice assignment (C speed; the per-pair
        # Python loop cost ~0.1 s/pass at bench shapes)
        seqs: List[str] = [None] * (2 * P)
        quals: List[str] = [None] * (2 * P)
        seqs[0::2] = seq1
        seqs[1::2] = seq2
        quals[0::2] = qual1
        quals[1::2] = qual2
        # vectorized code-matrix fill: one blob decode + scatter (the
        # per-read loop dominated host time at bench shapes)
        lens = np.fromiter((len(s) for s in seqs), np.int32, 2 * P)
        L = max(int(lens.max()) if P else 1, 1)
        codes = np.full((2 * P, L), 4, np.uint8)
        if P:
            flat = np.frombuffer("".join(seqs).encode(), np.uint8)
            rows = np.repeat(np.arange(2 * P), lens)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            cols = np.arange(flat.shape[0]) - np.repeat(starts, lens)
            codes[rows, cols] = _BASE_LUT[flat]
        return cls(list(ids), np.asarray(bcs, np.uint64), seqs, quals,
                   codes, lens)


@dataclasses.dataclass
class CandidateSet:
    """Flat candidate arrays over one batch (owner = oriented read index)."""

    owner: np.ndarray            # int64 [N] read index 0..2P-1
    rev: np.ndarray              # int8 [N]
    gpos: np.ndarray             # int64 [N] text pos of alignment start
    chrom: np.ndarray            # int32 [N]
    pos_local: np.ndarray        # int64 [N] 1-based contig-local position
    sw: np.ndarray               # int32 [N]
    qb: np.ndarray               # int32
    qe: np.ndarray               # int32
    clip: np.ndarray             # int32
    nm: np.ndarray               # int32
    cigars: np.ndarray           # uint32 [N, MAX_CIGAR_OPS]
    n_cigar: np.ndarray          # int32
    seedcov: np.ndarray          # int32
    sub: np.ndarray              # int32 per-candidate: best other sw score
    sub_n: np.ndarray            # int32
    frac_rep: np.ndarray         # float32
    unique: np.ndarray           # bool
