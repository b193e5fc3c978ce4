"""Seed chaining: seed hits -> candidate alignment windows (host, numpy).

The reference gets chains from BWA (`mem_chain` inside mem_align1_core).
Our design: seeds located on device arrive as flat (read, qb, len, pos)
tuples; we group hits of one read by alignment *diagonal* (pos - qb) with a
band-width tolerance, aggregate each cluster, and emit the top-K clusters
per read as candidate windows for the batched SW scorer.  Everything is
vectorized numpy (lexsort + reduceat) — no per-read Python loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Candidates:
    """Top-K candidate windows per oriented read, flat owner-grouped arrays.

    Flat (not dense [B, K]): with reference-scale per-read candidate caps
    (max_occ 3000 repeats can chain into ~1000 windows for one read) a
    dense layout would allocate K slots for every read in the batch.
    """

    owner: np.ndarray       # int64 [N] oriented-read index
    win_lo: np.ndarray      # int64 [N] text coord of window start
    win_len: np.ndarray     # int32 window length
    wl: np.ndarray          # int32 logical SW corridor (diagonal range)
    weight: np.ndarray      # int32 total seed bases in the chain
    seedcov: np.ndarray     # int32 approx read bases covered by seeds
    n_seeds: np.ndarray     # int32 seeds in the chain


def _empty_cands() -> Candidates:
    z32 = np.zeros(0, np.int32)
    return Candidates(owner=np.zeros(0, np.int64),
                      win_lo=np.zeros(0, np.int64), win_len=z32, wl=z32,
                      weight=z32, seedcov=z32, n_seeds=z32)


def chain_hits(owner: np.ndarray, qb: np.ndarray, seed_len: np.ndarray,
               pos: np.ndarray, n_reads: int, read_lens: np.ndarray,
               text_len: int,
               band_width: int = 100, pad: int = 24,
               max_candidates: int = 1024) -> Candidates:
    """Cluster flat seed hits into candidate windows.

    owner/qb/seed_len/pos: int64 [H] flat arrays over all valid hits of the
    batch; ``owner`` is the oriented-read index, ``pos`` the text position
    of the seed start, ``qb`` the seed's read offset.
    """
    K = max_candidates
    if owner.shape[0] == 0:
        return _empty_cands()

    diag = pos - qb
    order = np.lexsort((pos, diag, owner))
    owner = owner[order]
    qb = qb[order]
    seed_len = seed_len[order]
    pos = pos[order]
    diag = diag[order]

    brk = np.ones(owner.shape[0], bool)
    brk[1:] = (owner[1:] != owner[:-1]) | (np.abs(diag[1:] - diag[:-1]) > band_width)
    cid = np.cumsum(brk) - 1
    n_clusters = cid[-1] + 1
    starts = np.nonzero(brk)[0]

    c_owner = owner[starts]
    c_weight = np.add.reduceat(seed_len, starts)
    c_diag_min = np.minimum.reduceat(diag, starts)
    c_diag_max = np.maximum.reduceat(diag, starts)
    c_qb_min = np.minimum.reduceat(qb, starts)
    c_qe_max = np.maximum.reduceat(qb + seed_len, starts)
    c_nseeds = np.diff(np.append(starts, owner.shape[0]))
    c_seedcov = np.minimum(c_weight, c_qe_max - c_qb_min).astype(np.int32)

    # anchor diagonal = the chain's longest seed (extension is banded
    # around the best seed, as in BWA).  Adjacent hits may each be within
    # band_width yet drift thousands of bases cumulatively (periodic/
    # low-complexity text); without the anchor cap below, such a chain
    # would emit a window as wide as its whole diagonal range.
    H = owner.shape[0]
    c_maxlen = np.maximum.reduceat(seed_len, starts)
    is_max = seed_len == c_maxlen[cid]
    first_max = np.minimum.reduceat(np.where(is_max, np.arange(H), H),
                                    starts)
    c_anchor = diag[first_max]

    # drop duplicate chains on the same diagonal span (cap-sampled repeats
    # collapse because identical (owner, diag) sort adjacently)

    # rank clusters per read by weight (desc), keep top K
    order2 = np.lexsort((-c_weight, c_owner))
    c_owner = c_owner[order2]
    c_weight = c_weight[order2]
    c_diag_min = c_diag_min[order2]
    c_diag_max = c_diag_max[order2]
    c_seedcov = c_seedcov[order2]
    c_nseeds = c_nseeds[order2]

    c_anchor = c_anchor[order2]

    first = np.ones(n_clusters, bool)
    first[1:] = c_owner[1:] != c_owner[:-1]
    # rank within read
    idx_all = np.arange(n_clusters)
    first_idx = np.maximum.accumulate(np.where(first, idx_all, 0))
    rank_in_read = idx_all - first_idx
    keep = rank_in_read < K

    o = c_owner[keep].astype(np.int64)
    rl = read_lens[o]
    # window spans the chain's diagonal range — diag_min covers
    # insertions, diag_max deletions — clamped to anchor +- band_width
    # (a single banded alignment cannot drift further than the band from
    # its best seed; this bounds the SW window width even for chains
    # through periodic text)
    anchor = c_anchor[keep]
    d_lo = np.maximum(c_diag_min[keep], anchor - band_width)
    d_hi = np.minimum(c_diag_max[keep], anchor + band_width)
    # lo may go NEGATIVE at the text start: window gathers mask
    # out-of-text columns to a sentinel, which keeps every chained
    # alignment's window diagonal j - i >= pad >= 0 — the invariant the
    # banded row-sweep SW kernel needs (ops/sw.sw_score_banded)
    lo = d_lo - pad
    hi = np.minimum(d_hi + rl + pad, text_len)
    # logical SW corridor: the chain's guaranteed diagonal range
    # (d_lo - pad .. d_hi + pad), independent of end-of-text window
    # truncation; the kernels exclude diagonals k >= wl so a
    # candidate's score never depends on kernel lane padding
    wl = np.minimum((d_hi - d_lo) + 2 * pad + 2, hi - lo)

    return Candidates(
        owner=o,
        win_lo=lo.astype(np.int64),
        win_len=(hi - lo).astype(np.int32),
        wl=np.maximum(wl, 1).astype(np.int32),
        weight=c_weight[keep].astype(np.int32),
        seedcov=c_seedcov[keep].astype(np.int32),
        n_seeds=c_nseeds[keep].astype(np.int32))


def flatten_seed_hits(hit_pos: np.ndarray, hit_valid: np.ndarray,
                      seed_qb: np.ndarray, seed_len: np.ndarray,
                      n_seeds: np.ndarray):
    """Device seeding outputs -> flat hit arrays for chain_hits.

    hit_pos/hit_valid: [B, S, H]; seed_qb/seed_len: [B, S]; n_seeds: [B].
    """
    B, S, H = hit_pos.shape
    seed_live = (np.arange(S)[None, :] < n_seeds[:, None])
    live = hit_valid & seed_live[:, :, None]
    b_idx, s_idx, _ = np.nonzero(live)
    return (b_idx.astype(np.int64),
            seed_qb[b_idx, s_idx].astype(np.int64),
            seed_len[b_idx, s_idx].astype(np.int64),
            hit_pos[live].astype(np.int64))
