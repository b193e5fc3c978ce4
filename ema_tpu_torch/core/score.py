"""Alignment scoring: generative log-prob model and mapq formulas.

Vectorized ports of the reference semantics:
  - score_alignments: CIGAR+NM -> log-prob generative score and score_mapq
    (reference: src/align.c:846-913).
  - approx_mapq: BWA's single-end mapq shape over our chain/extension
    statistics (reference: src/align.c:958-984, itself adapted from BWA).
    ``sub``/``seedcov``/``frac_rep`` come from our own chaining, so values
    are analogs, not bit-copies of BWA internals; the final SAM mapq is
    min(gamma_mapq, score_mapq, bwa_mapq) either way
    (reference: src/samrecord.c:142-148).
"""

from __future__ import annotations

import numpy as np

from ema_tpu_torch import config


def cigar_stats(cigars: np.ndarray, n_cigar: np.ndarray):
    """Decode [B, max_ops] BAM-encoded cigars -> per-item op tallies.

    Returns (match_bases, indel_bases, indel_runs, clip_bases) — 'M' bases
    include mismatches (split later using NM).  One native pass over the
    op pool (the numpy mask/where/sum stack built several [B, max_ops]
    temporaries per emit batch).
    """
    from ema_tpu_torch import native

    B, max_ops = cigars.shape
    off = np.arange(B, dtype=np.int64) * max_ops
    # Clamp lane counts to the pool width: the native kernel reads ln[b]
    # ops unconditionally, so an oversized n_cigar would read out of bounds.
    n_cigar = np.minimum(n_cigar, max_ops)
    m_b, i_b, i_r, c_b, _ = native.cigar_stats_pool(cigars, off, n_cigar)
    return m_b, i_b, i_r, c_b


def score_alignments(cigars: np.ndarray, n_cigar: np.ndarray,
                     edit_dist: np.ndarray, error_rate: float):
    """Generative alignment log-prob + score_mapq (align.c:904-912)."""
    m_bases, indel_bases, indel_runs, clip_bases = cigar_stats(cigars, n_cigar)
    mismatches = edit_dist - indel_bases
    matches = m_bases - mismatches

    log_match = np.log(1.0 - error_rate)
    log_mm = np.log(error_rate)
    log_indel = np.log(config.INDEL_RATE)
    log_clip = np.log(config.CLIP_RATE)

    score = (matches * log_match + mismatches * log_mm
             + indel_runs * log_indel + clip_bases * log_clip)
    score_mapq = (60.0 + mismatches * np.log10(error_rate)
                  + indel_runs * np.log10(config.INDEL_RATE)
                  + clip_bases * np.log10(config.CLIP_RATE)).astype(np.int64)
    return score, score_mapq


def approx_mapq(sw_score: np.ndarray, sub: np.ndarray, qspan: np.ndarray,
                seedcov: np.ndarray, sub_n: np.ndarray,
                frac_rep: np.ndarray,
                params: config.AlignerParams = config.DEFAULT_ALIGNER_PARAMS,
                rspan: np.ndarray | None = None) -> np.ndarray:
    """BWA-shaped approximate single-end mapq (align.c:958-984)."""
    a, b = params.match, params.mismatch
    # the min_seed_len*a floor applies only when sub == 0 (align.c:961)
    sub = np.where(sub == 0, params.min_seed_len * a, sub)

    ok = sub < sw_score
    span = qspan if rspan is None else np.maximum(qspan, rspan)
    l = np.maximum(span, 1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        identity = 1.0 - (l * a - sw_score) / (a + b) / l
        tmp = np.where(l < params.mapq_coef_len, 1.0,
                       params.mapq_coef_fac / np.log(np.maximum(l, 2.0)))
        tmp = tmp * identity * identity
        mapq = (6.02 * (sw_score - sub) / a * tmp * tmp + 0.499).astype(np.int64)
    mapq = np.where(sw_score == 0, 0, mapq)
    with np.errstate(divide="ignore", invalid="ignore"):
        mapq = np.where(sub_n > 0,
                        mapq - (4.343 * np.log(sub_n + 1) + 0.499).astype(np.int64),
                        mapq)
    mapq = np.clip(mapq, 0, 254)
    mapq = (mapq * (1.0 - frac_rep) + 0.499).astype(np.int64)
    return np.where(ok, mapq, 0)


def gamma_mapq(gamma: np.ndarray) -> np.ndarray:
    """Posterior-probability mapq (samrecord.c:142)."""
    g = np.asarray(gamma, np.float64)
    with np.errstate(divide="ignore"):
        q = np.where(g <= 0.999999,
                     (-10.0 * np.log10(np.maximum(1.0 - g, 1e-300))).astype(np.int64),
                     60)
    return q


def final_mapq(gamma: np.ndarray, score_mapq: np.ndarray,
               bwa_mapq: np.ndarray) -> np.ndarray:
    """min of the three mapqs, clamped to [0, 60] (samrecord.c:142-148)."""
    m = np.minimum(gamma_mapq(gamma), score_mapq)
    m = np.minimum(m, bwa_mapq)
    return np.clip(m, 0, 60)
