"""Candidate alignment record model (array-of-structs -> struct-of-arrays).

The reference's SAMRecord (include/samrecord.h:21-54) is a pointer-linked C
struct; here records are rows of a numpy structured array plus a shared
CIGAR pool, so batch phases (scoring, EM, SAM emission) vectorize.
"""

from __future__ import annotations

import numpy as np

RECORD_DTYPE = np.dtype([
    ("bc", np.uint64),
    ("chrom", np.int32),
    ("pos", np.int64),          # 1-based leftmost mapping position
    ("pair", np.int64),         # global pair index (read name = ids[pair])
    ("mate", np.int8),          # 0 / 1
    ("rev", np.int8),
    ("score", np.float64),      # generative log-prob (align.c:904-907)
    ("mapq", np.int32),         # BWA-shaped mapq
    ("score_mapq", np.int32),
    ("clip", np.int32),
    ("clip_edit_dist", np.int32),
    ("edit_dist", np.int32),
    ("sw_score", np.int32),
    ("unique", np.bool_),
    ("active", np.bool_),
    ("duplicate", np.bool_),
    ("cig_off", np.int64),      # offset into the cigar pool
    ("cig_len", np.int32),
    ("aln_pos0", np.int64),     # 0-based position (TLEN math, samrecord.c:200)
])


def empty_records(n: int) -> np.ndarray:
    r = np.zeros(n, dtype=RECORD_DTYPE)
    r["active"] = True
    return r
