"""Typed configuration: platform profiles and model constants.

Platform profiles mirror the reference's table (reference: src/techs.c:71-127,
include/techs.h:10-23); model constants mirror include/align.h:52-78,
include/samdict.h:9-12, include/split.h:8-17 and cpp/common.h:56-62.  Unlike
the reference (getopt flags + compile-time #defines), everything lives in one
typed config that can be serialized into run metadata.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlatformProfile:
    """Sequencing-platform profile (reference: include/techs.h:10-23)."""

    name: str
    bc_len: int                 # barcode length in bases (0 = integer barcodes)
    many_clouds: bool           # per-read cloud-weight normalization mode
    dist_thresh: int            # max gap between reads within one cloud
    error_rate: float           # per-base sequencing error rate
    density_probs: Tuple[float, ...]  # read-density prior (per-1000bp bin)

    @property
    def log_density_probs(self) -> Tuple[float, ...]:
        return tuple(math.log(p) for p in self.density_probs)


_DEFAULT_DENSITY = (0.6, 0.05, 0.2, 0.01)

PLATFORM_PROFILES = {
    # reference: src/techs.c:71-127
    "haplotag": PlatformProfile("haplotag", 12, False, 50_000, 0.001, _DEFAULT_DENSITY),
    "10x": PlatformProfile("10x", 16, False, 50_000, 0.001, _DEFAULT_DENSITY),
    "tru": PlatformProfile("tru", 0, True, 15_000, 0.001, _DEFAULT_DENSITY),
    "cpt": PlatformProfile(
        "cpt", 0, True, 3_500, 0.01,
        (0.6, 0.01, 0.15, 0.001, 0.05, 0.001, 0.02, 0.001, 0.01)),
    "dbs": PlatformProfile("dbs", 20, False, 50_000, 0.001, _DEFAULT_DENSITY),
    "tellseq": PlatformProfile("tellseq", 18, False, 50_000, 0.001, _DEFAULT_DENSITY),
}


def get_platform_profile(name: str) -> PlatformProfile:
    """Look up a platform profile (reference: src/techs.c:129-137)."""
    try:
        return PLATFORM_PROFILES[name]
    except KeyError:
        raise ValueError(
            f"invalid platform name: {name!r} "
            f"(one of {sorted(PLATFORM_PROFILES)})") from None


# ---------------------------------------------------------------------------
# EM / alignment-model constants (reference: include/align.h:52-78)
# ---------------------------------------------------------------------------

EM_ITERS = 5
MIN_PAIRS_FOR_EM = 30          # EM only runs for groups >= this many pairs
MAX_CLOUDS_PER_BC_SMALL = 1_000_000
MAX_CLOUDS_PER_BC_LARGE = 10_000_000

MAX_READ_LEN = 200
MAX_ID_LEN = 100

INSERT_AVG = 250
INSERT_MIN = -35
INSERT_MAX = 750
UNPAIRED_PENALTY = -15.0

INDEL_RATE = 0.0001
CLIP_RATE = 0.03

EXTRA_SEARCH_DEPTH = 12
SPLIT_EXTRA_SEARCH_DEPTH = 5
SPLIT_CLIP_THRESH = 15

SECONDARY_ALIGN_THRESH = 0.9
MAX_ALTS = 3

# reference: include/samdict.h:9-12
MAX_CANDIDATES = 5000

# reference: include/split.h:8-17
SIM_ANNEAL_ITERS = 50_000
SIM_ANNEAL_TMAX_LOG = 0.0
SIM_ANNEAL_TMIN_LOG = -12.0
SIM_ANNEAL_MAX_NO_MOVE = 500
# ours (no reference analog): seeded SA restart chains per bad cloud; the
# best-energy final assignment wins (reference runs ONE time-seeded chain)
SPLIT_RESTARTS = int(os.environ.get("EMA_TPU_SPLIT_RESTARTS", "3"))
# extra chains only for clouds with at least this many multimapped reads
# (small clouds converge to the same optimum every chain)
SPLIT_RESTART_MIN_MMAPS = 8
BIN_SIZE = 1000
MAX_FRAG = 1_000_000
MAX_BINS = MAX_FRAG // BIN_SIZE
SCORE_SCALE = 20

# ---------------------------------------------------------------------------
# Preprocessing constants (reference: cpp/common.h:56-62, cpp/correct.cc:24)
# ---------------------------------------------------------------------------

MATE1_TRIM = 7
PREPROC_BC_LEN = 16            # the C++ preprocessor is 10x-only (16bp)
ILLUMINA_QUAL_OFFSET = 33
QUAL_BASE = ILLUMINA_QUAL_OFFSET + 1   # 34
MIN_READ_SIZE = 32
BC_CONF_THRESH = 0.975
DEFAULT_N_BUCKETS = 500


# ---------------------------------------------------------------------------
# Aligner scoring parameters (BWA-MEM-compatible defaults; the reference gets
# these from mem_opt_init() in lh3/bwa and overrides max_occ
# (src/align.c:184-185)).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlignerParams:
    match: int = 1              # opt->a
    mismatch: int = 4           # opt->b (penalty, positive)
    gap_open: int = 6           # opt->o_del / o_ins
    gap_extend: int = 1         # opt->e_del / e_ins
    clip_penalty: int = 5       # opt->pen_clip5/3
    band_width: int = 100       # opt->w
    min_seed_len: int = 19      # opt->min_seed_len
    max_occ: int = 3000         # reference override, src/align.c:185
    mapq_coef_len: int = 50     # opt->mapQ_coef_len
    mapq_coef_fac: float = math.log(50)  # opt->mapQ_coef_fac
    mem_mapq_coef: float = 30.0  # MEM_MAPQ_COEF
    # seeding strategy:
    #   "greedy" — batched maximal-suffix backward search, on the host
    #              or fused with locate on the device (index/fm.py).
    #   "smem"   — full SMEM enumeration + BWA re-seeding rounds in
    #              threaded host C++ (bwt_smem1 semantics; the seeding
    #              mem_align1_core uses, reference bwabridge.c:236-237).
    #              Exact reference seeding parity.
    #   None     — smem (greedy is opt-in).
    seeding: Optional[str] = None
    seed_len: int = 19
    seed_stride: int = 7
    split_width: int = 10       # BWA opt->split_width (re-seed occ gate)
    max_mem_intv: int = 20      # BWA opt->max_mem_intv (3rd round gate)
    # per-seed hit cap = the reference's max_occ semantics: SA intervals
    # wider than this are evenly sampled down to it (src/align.c:185 —
    # EMA raises BWA's 500 to 3000 so deep repeat families keep enough
    # candidates for the cloud EM to arbitrate)
    max_hits_per_seed: int = 3000
    max_candidates_per_read: int = 1024
    # mate rescue (reference: src/bwabridge.c:213-231: pes = {-35, 500, 200, 100})
    rescue_score_delta: int = 25
    rescue_max_per_side: int = 50
    pes_low: int = -35
    pes_high: int = 500
    pes_avg: float = 200.0
    pes_std: float = 100.0


DEFAULT_ALIGNER_PARAMS = AlignerParams()


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level run configuration serialized into run metadata."""

    platform: PlatformProfile = PLATFORM_PROFILES["10x"]
    aligner: AlignerParams = DEFAULT_ALIGNER_PARAMS
    apply_density_opt: bool = False     # reference -d flag
    read_group: Optional[str] = "@RG\tID:rg1\tSM:sample1"
    bx_index: str = "1"
    seed: int = 0                       # RNG seed (reference -d uses time())
    batch_size: Optional[int] = None    # read pairs per device batch
                                        # (None: 4096)
    inflight_chunks: Optional[int] = None   # device chunks in flight
                                        # (CLI -t; None: 4)
    device_em: Optional[bool] = None    # run EM on the Aligner's device
                                        # (None: on a card yes, on the
                                        # CPU the host EM)
    data_parallel_chips: bool = True    # shard device calls over all local
                                        # chips (auto-off with one device)
    nobc: bool = False                  # no-barcode mode: each pair is its
                                        # own group, no linked-read tags
                                        # (replaces `bwa mem` on ema-nobc,
                                        # reference README.md:132-137)
