"""Import an existing `bwa index` (.pac/.ann/.amb) as contig code arrays.

The reference consumes BWA's on-disk index directly (`bwa_idx_load`,
bwabridge.c:79; SURVEY.md §2.5), so a user with an already-indexed
reference can run it without re-indexing.  This module gives our stack
the same drop-in property: ``ema_tpu index -r ref.fa --from-bwa`` reads
the BWA files next to the FASTA and builds our `.emaidx` from them — no
FASTA parse, and align output is identical to a FASTA-built index
(tests/test_bwa_import.py).

Only the forward-genome files are needed:
  - ``.ann``: text — header ``l_pac n_seqs seed``; per contig a name
    line (``gi name [comment]``) and a ``offset len n_ambs`` line.
  - ``.amb``: text — header ``l_pac n_seqs n_holes``; per hole
    ``offset len char`` (runs of ambiguous bases that BWA randomized
    when packing).
  - ``.pac``: binary 2-bit codes, base ``i`` at byte ``i>>2`` bits
    ``(~i & 3) << 1`` (A/C/G/T = 0..3), with a 1-2 byte length trailer.

Two import paths exist:
  - ``import_bwa_index`` (used by the CLI when ``.bwt``/``.sa`` are
    present): consumes the prebuilt FM-index directly — BWA's interleaved
    occ is repacked into our occ-block layout and the rank-sampled SA is
    converted to our value-sampled locate structure with one O(n)
    segmented LF walk.  No suffix-array construction.
  - ``load_bwa_contigs`` (fallback when only ``.pac/.ann/.amb`` exist):
    hole runs are restored to code 255 (= N) and build_index rebuilds
    occ+SA via SA-IS, re-randomizing holes exactly as for FASTA input.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _read_ann(path: str) -> Tuple[int, List[Tuple[str, int, int]]]:
    """Parse `.ann`: returns (l_pac, [(name, offset, length), ...])."""
    with open(path, "r") as f:
        toks = f.read().split("\n")
    head = toks[0].split()
    l_pac, n_seqs = int(head[0]), int(head[1])
    seqs: List[Tuple[str, int, int]] = []
    li = 1
    for _ in range(n_seqs):
        parts = toks[li].split()
        name = parts[1]
        off_len = toks[li + 1].split()
        seqs.append((name, int(off_len[0]), int(off_len[1])))
        li += 2
    return l_pac, seqs


def _read_amb(path: str) -> np.ndarray:
    """Parse `.amb`: returns int64 [k, 2] (offset, length) hole runs in
    global pac coordinates."""
    with open(path, "r") as f:
        toks = f.read().split()
    n_holes = int(toks[2])
    holes = np.zeros((n_holes, 2), np.int64)
    # each record is "offset len char" = 3 tokens after the 3-token header
    for i in range(n_holes):
        holes[i, 0] = int(toks[3 + 3 * i])
        holes[i, 1] = int(toks[4 + 3 * i])
    return holes


def _read_pac(path: str, l_pac: int) -> np.ndarray:
    """Unpack `.pac` into uint8 codes [l_pac] (0..3)."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    need = (l_pac + 3) // 4
    if data.shape[0] < need:
        raise ValueError(
            f"{path}: {data.shape[0]} bytes < {need} needed for "
            f"l_pac={l_pac}")
    b = data[:need]
    codes = np.empty((need, 4), np.uint8)
    codes[:, 0] = (b >> 6) & 3
    codes[:, 1] = (b >> 4) & 3
    codes[:, 2] = (b >> 2) & 3
    codes[:, 3] = b & 3
    return codes.reshape(-1)[:l_pac]


def load_bwa_contigs(prefix: str) -> Dict[str, np.ndarray]:
    """Read `<prefix>.ann/.amb/.pac` (the files `bwa index ref.fa` leaves
    next to the FASTA) into {name: uint8 codes}, with ambiguous runs
    restored to 255 — the same representation parse_fasta produces, so
    build_index output is identical to indexing the FASTA."""
    l_pac, seqs = _read_ann(prefix + ".ann")
    holes = _read_amb(prefix + ".amb")
    text = _read_pac(prefix + ".pac", l_pac)
    if holes.shape[0]:
        text = text.copy()
        for off, ln in holes:
            text[off:off + ln] = 255
    out: Dict[str, np.ndarray] = {}
    for name, off, ln in seqs:
        out[name] = np.ascontiguousarray(text[off:off + ln])
    return out


# ---------------------------------------------------------------------------
# Direct .bwt/.sa consumption (no SA-IS rebuild).
#
# `bwa index` leaves five files; the reference's bwa_idx_load(path,
# BWA_IDX_ALL) (reference src/bwabridge.c:79) memory-maps the prebuilt
# FM-index from `.bwt` (interleaved occ + 2-bit BWT) and `.sa`
# (rank-sampled suffix array) in seconds.  import_bwa_index gives our
# stack the same property: the `.bwt` interleaved occ blocks are repacked
# straight into our occ_blocks layout (both use 128-base checkpoints, and
# BWA's row space — row 0 = $, `primary` marking the full-string row, $
# skipped in char space — is exactly ours, index/build.py), and the
# rank-sampled `.sa` is converted to our value-sampled locate structure
# with one O(n) segmented LF walk (native.bwa_sa_to_value_samples).
#
# BWA file formats (bwa 0.7.x, bwt.c bwt_dump_bwt/bwt_dump_sa,
# bwt_bwtupdate_core, OCC_INTERVAL = 128):
#   .bwt: u64 primary; u64 L2[1..4] (cumulative A/C/G/T counts);
#         then per 128-base chunk: 4 x u64 occ counts before the chunk +
#         8 x u32 packed BWT words (16 bases/word, base k of a word at
#         bits (15-k)*2 — big-endian base order); a final 4 x u64 totals.
#         The BWT is over forward + reverse-complement (seq_len = 2*l_pac)
#         with the $ row REMOVED and `primary` recording where it was.
#   .sa:  u64 primary; u64[4] L2[1..4]; u64 sa_intv; u64 seq_len;
#         u64 SA[k*sa_intv] for k = 1..n_sa-1 (SA[0] = seq_len implied).

_REV2 = np.empty(256, np.uint8)
for _b in range(256):
    _REV2[_b] = (((_b & 3) << 6) | ((_b >> 2 & 3) << 4)
                 | ((_b >> 4 & 3) << 2) | (_b >> 6 & 3))


def _repack_words(words_bwa: np.ndarray) -> np.ndarray:
    """BWA packs base k of a u32 word at bits (15-k)*2; our rank kernel
    expects base k at bits 2k (index/build.py:_pack_occ_blocks).  The
    transform is a byte reversal + 2-bit-field reversal within each byte."""
    b = words_bwa.view(np.uint8).reshape(-1, 4)[:, ::-1]
    return np.ascontiguousarray(_REV2[b]).view(np.uint32).reshape(
        words_bwa.shape)


def decode_bwt_file(path: str):
    """Parse `.bwt` -> (primary, counts[5], occ_blocks, seq_len)."""
    raw = np.fromfile(path, np.uint8)
    if raw.shape[0] < 40 or raw.shape[0] % 4:
        raise ValueError(f"{path}: truncated .bwt")
    primary = int(raw[:8].view(np.uint64)[0])
    l2 = raw[8:40].view(np.uint64).astype(np.int64)   # A, AC, ACG, ACGT
    seq_len = int(l2[3])
    data = raw[40:].view(np.uint32)
    n_chunks = (seq_len + 127) // 128
    n_bwt_words = (seq_len + 15) // 16
    expect = n_chunks * 8 + n_bwt_words + 8
    if data.shape[0] != expect:
        raise ValueError(
            f"{path}: {data.shape[0]} payload words, expected {expect} "
            f"for seq_len={seq_len} (OCC_INTERVAL=128 layout)")

    body, final_cnt = data[:-8], data[-8:]
    full = np.zeros((n_chunks, 16), np.uint32)
    if seq_len % 128 == 0:
        full[:] = body.reshape(n_chunks, 16)
    else:
        k = n_chunks - 1
        full[:k] = body[:k * 16].reshape(k, 16)
        tail = body[k * 16:]
        full[k, :tail.shape[0]] = tail

    chunk_counts = np.ascontiguousarray(
        full[:, :8]).view(np.uint64).reshape(n_chunks, 4).astype(np.int64)
    words = _repack_words(np.ascontiguousarray(full[:, 8:]))

    n_blocks = seq_len // 128 + 1
    occ = np.zeros((n_blocks, 12), np.int32)
    if seq_len % 128 == 0:
        occ[:n_chunks, :4] = chunk_counts
        occ[n_chunks, :4] = final_cnt.view(np.uint64).astype(np.int64)
        occ[:n_chunks, 4:] = words.view(np.int32)
    else:
        occ[:, :4] = chunk_counts
        occ[:, 4:] = words.view(np.int32)

    counts = np.zeros(5, np.int64)
    counts[0] = 1                       # the $ row
    counts[1:] = l2 + 1
    return primary, counts, occ, seq_len


def decode_sa_file(path: str, primary: int, seq_len: int):
    """Parse `.sa` -> (sa_intv, start_vals[n_sa]) with SA[0]=seq_len
    restored (bwt_restore_sa skips it on disk)."""
    raw = np.fromfile(path, np.uint64)
    if raw.shape[0] < 7:
        raise ValueError(f"{path}: truncated .sa")
    if int(raw[0]) != primary:
        raise ValueError(f"{path}: primary {int(raw[0])} != .bwt {primary}")
    if int(raw[6]) != seq_len:
        raise ValueError(f"{path}: seq_len {int(raw[6])} != .bwt {seq_len}")
    sa_intv = int(raw[5])
    n_sa = (seq_len + sa_intv) // sa_intv
    body = raw[7:].astype(np.int64)
    if body.shape[0] != n_sa - 1:
        raise ValueError(
            f"{path}: {body.shape[0]} samples, expected {n_sa - 1}")
    start_vals = np.empty(n_sa, np.int64)
    start_vals[0] = seq_len
    start_vals[1:] = body
    return sa_intv, start_vals


def import_bwa_index(prefix: str, sa_rate: int | None = None):
    """Build a ReferenceIndex directly from a complete BWA index
    (`.bwt/.sa/.pac/.ann/.amb`) — no suffix-array construction.

    The imported index inherits BWA's ambiguous-base randomization (it is
    baked into `.pac` and the BWT); alignment output matches an index
    built from the same randomized text.  Returns a ReferenceIndex.
    """
    from ema_tpu_torch import native
    from ema_tpu_torch.index.build import ReferenceIndex

    l_pac, seqs = _read_ann(prefix + ".ann")
    holes = _read_amb(prefix + ".amb")
    text = _read_pac(prefix + ".pac", l_pac)   # BWA randomization kept

    primary, counts, occ_blocks, seq_len = decode_bwt_file(prefix + ".bwt")
    if seq_len != 2 * l_pac:
        raise ValueError(
            f"{prefix}.bwt seq_len={seq_len} != 2*l_pac={2 * l_pac} "
            "(not a both-strand BWA index?)")
    if 2 * l_pac >= 2**31 - 1:
        raise ValueError("genome too large for int32 index (>2^30 bases)")
    sa_intv, start_vals = decode_sa_file(prefix + ".sa", primary, seq_len)

    if sa_rate is None:
        sa_rate = 2 if seq_len < (1 << 27) else 4

    words, mark_rank, sa_values = native.bwa_sa_import_locate(
        occ_blocks, counts, primary, seq_len, start_vals, sa_intv, sa_rate)

    names = [s[0] for s in seqs]
    offsets = np.array([s[1] for s in seqs], np.int64)
    lengths = np.array([s[2] for s in seqs], np.int64)
    return ReferenceIndex(
        names=names, offsets=offsets, lengths=lengths, text=text,
        n_mask_intervals=holes_to_intervals(holes),
        primary=primary, counts=counts, occ_blocks=occ_blocks,
        sa_rate=sa_rate, sa_mark_words=words, sa_mark_rank=mark_rank,
        sa_values=sa_values, fm_n=seq_len)


def holes_to_intervals(holes: np.ndarray) -> np.ndarray:
    """.amb hole runs (offset, len) -> [k, 2] (start, end) intervals."""
    if not holes.shape[0]:
        return np.zeros((0, 2), np.int64)
    out = np.empty((holes.shape[0], 2), np.int64)
    out[:, 0] = holes[:, 0]
    out[:, 1] = holes[:, 0] + holes[:, 1]
    return out
