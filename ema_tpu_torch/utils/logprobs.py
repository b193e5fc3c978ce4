"""Log-probability normalization — the numeric core of the EM model.

Reference semantics (src/util.c:129-163):
  - n == 1  ->  p[0] = 1.0 exactly.
  - otherwise: subtract the max, zero out entries below the floor
    log(1e-50) - log(n), exponentiate the rest, and divide by the total.

The batched variant applies the same semantics over a padded [B, C] matrix
with a validity mask, in float64, so device and host paths agree bit-for-bit
on the same inputs.
"""

from __future__ import annotations

import numpy as np

_EPSILON = 1e-50
_LOG_EPSILON = float(np.log(_EPSILON))


def normalize_log_probs(p: np.ndarray) -> np.ndarray:
    """Normalize a 1-D array of log-probs in place-equivalent fashion."""
    p = np.asarray(p, dtype=np.float64).copy()
    n = p.shape[0]
    if n == 1:
        p[0] = 1.0
        return p

    thresh = _LOG_EPSILON - np.log(n)
    p -= p.max()
    out = np.where(p < thresh, 0.0, np.exp(p))
    # match the reference's exact exp(0)=1 for the max element
    return out / out.sum()


def normalize_log_probs_batch(p: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Batched normalize over rows of a padded [B, C] matrix.

    ``mask`` marks valid entries; invalid entries come out as 0.  Rows with a
    single valid entry get exactly 1.0 there; rows with no valid entries come
    out all-zero.
    """
    p = np.asarray(p, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    counts = mask.sum(axis=1)

    neg_inf = -np.inf
    pm = np.where(mask, p, neg_inf)
    pmax = np.max(pm, axis=1, keepdims=True)
    pmax = np.where(np.isfinite(pmax), pmax, 0.0)

    with np.errstate(invalid="ignore"):
        shifted = pm - pmax
    thresh = _LOG_EPSILON - np.log(np.maximum(counts, 1))[:, None]
    vals = np.where(mask & (shifted >= thresh), np.exp(np.where(mask, shifted, 0.0)), 0.0)
    totals = vals.sum(axis=1, keepdims=True)
    out = np.where(totals > 0, vals / np.where(totals > 0, totals, 1.0), 0.0)

    # single-candidate rows: exactly 1.0 (reference short-circuit)
    single = counts == 1
    if single.any():
        out[single] = np.where(mask[single], 1.0, 0.0)
    return out
