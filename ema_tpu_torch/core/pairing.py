"""The proper-pair predicate (reference align.c:27-40), shared by the SAM
flag emitter and the SA density optimizer.

FR orientation on one chrom with the forward-to-reverse distance inside
[INSERT_MIN, INSERT_MAX].  The vectorized restatements in
core/groups.py:_recompute_gammas (numpy) and core/em_jax.py:_recompute
(jnp EM inner loop) must stay in sync with this rule.
"""

from __future__ import annotations

from ema_tpu_torch import config


def is_proper_pair(chrom1, pos1, rev1, chrom2, pos2, rev2) -> bool:
    if bool(rev1) == bool(rev2) or chrom1 != chrom2:
        return False
    d = int(pos2) - int(pos1) if rev2 else int(pos1) - int(pos2)
    return config.INSERT_MIN <= d <= config.INSERT_MAX
