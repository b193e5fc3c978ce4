"""Reference index construction (host-side, C++ SA-IS + numpy).

The reference consumes a prebuilt BWA index (`bwa index`, loaded through
bwa_idx_load — reference: src/bwabridge.c:77-96).  Here we build our own:

  - 2-bit text of the concatenated contigs (N bases randomized with a fixed
    seed, as BWA does during pac construction),
  - suffix array via the native SA-IS,
  - BWT with the $-row removed and its position kept as ``primary``
    (the classic FM-index layout),
  - occ checkpoint *blocks* laid out for batched rank queries: one int32 row of
    12 words per 128 BWT chars — 4 cumulative counts followed by 8 packed
    2-bit words — so a rank query is a single row gather plus popcounts,
  - a *value-sampled* suffix array for locate: rows whose SA value is
    divisible by ``sa_rate`` are marked in a bitmap (with per-word prefix
    counts) and their values stored compactly.  Because each LF step
    decrements the SA value by exactly one, a batched locate is a *fixed*
    ``sa_rate``-step loop — no data-dependent iteration count on device.

Both strands are packed into the FM text (forward then reverse
complement), matching the reference's BWA index (bwabridge.c:319-332):
each read is seeded in one orientation only and reverse-strand hits map
back as text_pos = 2n - hit - seed_len.  ``text`` holds the forward
strand only (SW windows and traceback read it directly).

Positions use int32 throughout; genome length per index is
limited to < 2^30 bases so both strands fit int32 rows (GRCh38-scale
genomes use contig-sharded indexes, index/sharded.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence

import numpy as np

from ema_tpu_torch import native

OCC_BLOCK = 128          # BWT chars per checkpoint block
OCC_ROW_WORDS = 12       # 4 counts + 8 packed words
# locate walks sa_rate-1 LF steps worst-case; rate 4 halves the walk vs 8
# for 2 bytes/base of sampled-SA memory (measured 2.2x faster locate)
DEFAULT_SA_RATE = 4


@dataclasses.dataclass
class ReferenceIndex:
    names: List[str]
    offsets: np.ndarray       # int64 [n_contigs] start offset in text
    lengths: np.ndarray       # int64 [n_contigs]
    text: np.ndarray          # uint8 [n] FORWARD 2-bit codes (N randomized)
    n_mask_intervals: np.ndarray  # int64 [k, 2] original-N intervals (global coords)
    primary: int              # row of the $ in the full BWT
    counts: np.ndarray        # int64 [5] C array: C[c] = 1 + #chars < c
    occ_blocks: np.ndarray    # int32 [n_blocks, 12]
    sa_rate: int
    sa_mark_words: np.ndarray  # uint32 [ceil((fm_n+1)/32)] sampled-row bitmap
    sa_mark_rank: np.ndarray   # int32 same len: marked count before each word
    sa_values: np.ndarray      # int32 [n_marked] SA values of marked rows
    fm_n: int = 0             # FM text length (2n: both strands packed)

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    def contig_of(self, pos: np.ndarray) -> np.ndarray:
        """Map global text positions -> contig indices."""
        return np.searchsorted(self.offsets, np.asarray(pos), side="right") - 1

    def save(self, path: str) -> None:
        # uncompressed: zlib on GB-scale occ/SA arrays dominates build
        # time at genome scale, and the arrays are high-entropy anyway
        np.savez(
            path,
            names=np.array(self.names, dtype=object),
            offsets=self.offsets, lengths=self.lengths, text=self.text,
            n_mask_intervals=self.n_mask_intervals,
            primary=np.int64(self.primary), counts=self.counts,
            occ_blocks=self.occ_blocks, sa_rate=np.int64(self.sa_rate),
            sa_mark_words=self.sa_mark_words, sa_mark_rank=self.sa_mark_rank,
            sa_values=self.sa_values, fm_n=np.int64(self.fm_n))

    @classmethod
    def load(cls, path: str) -> "ReferenceIndex":
        z = np.load(path, allow_pickle=True)
        return cls(
            names=[str(s) for s in z["names"]],
            offsets=z["offsets"], lengths=z["lengths"], text=z["text"],
            n_mask_intervals=z["n_mask_intervals"],
            primary=int(z["primary"]), counts=z["counts"],
            occ_blocks=z["occ_blocks"], sa_rate=int(z["sa_rate"]),
            sa_mark_words=z["sa_mark_words"], sa_mark_rank=z["sa_mark_rank"],
            sa_values=z["sa_values"], fm_n=int(z["fm_n"]))


def index_from_arrays(arrays: dict) -> ReferenceIndex:
    """A ``ReferenceIndex`` from its fields as plain numpy arrays, a list
    of names and Python scalars, keyed by field name: the form in which
    an index built elsewhere (the JAX package's, in the tests) is handed
    over without passing a foreign object.  A missing or unknown key
    raises."""
    want = {f.name for f in dataclasses.fields(ReferenceIndex)}
    if set(arrays) != want:
        raise ValueError(f"index arrays: missing {sorted(want - set(arrays))}"
                         f", unknown {sorted(set(arrays) - want)}")
    a = arrays
    return ReferenceIndex(
        names=[str(s) for s in a["names"]],
        offsets=np.asarray(a["offsets"], np.int64),
        lengths=np.asarray(a["lengths"], np.int64),
        text=np.asarray(a["text"], np.uint8),
        n_mask_intervals=np.asarray(a["n_mask_intervals"], np.int64),
        primary=int(a["primary"]), counts=np.asarray(a["counts"], np.int64),
        occ_blocks=np.asarray(a["occ_blocks"], np.int32),
        sa_rate=int(a["sa_rate"]),
        sa_mark_words=np.asarray(a["sa_mark_words"], np.uint32),
        sa_mark_rank=np.asarray(a["sa_mark_rank"], np.int32),
        sa_values=np.asarray(a["sa_values"], np.int32),
        fm_n=int(a["fm_n"]))


_LUT = np.full(256, 255, dtype=np.uint8)
for b, c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _LUT[b] = c


def parse_fasta(path: str) -> Dict[str, np.ndarray]:
    """Parse FASTA into {name: uint8 codes (0-3, 255 = N/other)}."""
    seqs: Dict[str, np.ndarray] = {}
    name = None
    chunks: List[bytes] = []

    def flush():
        if name is not None:
            raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
            seqs[name] = _LUT[raw]

    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(b">"):
                flush()
                name = line[1:].split()[0].decode()
                chunks = []
            elif line:
                chunks.append(line)
    flush()
    return seqs


def build_index(contigs: Dict[str, np.ndarray] | str,
                sa_rate: int | None = None,
                seed: int = 11) -> ReferenceIndex:
    """Build the FM-index from a FASTA path or {name: uint8 code array}.

    ``sa_rate`` defaults adaptively: small genomes afford a denser sampled
    SA (rate 2 = a single LF step worst-case in locate); large ones use
    DEFAULT_SA_RATE to bound memory (sa_values = 4B * fm_n / rate).
    """
    if isinstance(contigs, str):
        contigs = parse_fasta(contigs)
    if sa_rate is None:
        total = sum(a.shape[0] for a in contigs.values())
        sa_rate = 2 if 2 * total < (1 << 27) else DEFAULT_SA_RATE

    names = list(contigs.keys())
    arrs = [np.ascontiguousarray(contigs[k], dtype=np.uint8) for k in names]
    lengths = np.array([a.shape[0] for a in arrs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    text = np.concatenate(arrs) if arrs else np.zeros(0, np.uint8)
    n = text.shape[0]
    if 2 * n >= 2**31 - 1:      # both strands must fit int32 rows
        raise ValueError("genome too large for int32 index (>2^30 bases)")

    # randomize ambiguous bases deterministically (BWA does the same when
    # packing; keeps DP/scoring honest via the recorded N intervals)
    bad = text > 3
    n_mask = _intervals_from_mask(bad)
    if bad.any():
        rng = np.random.default_rng(seed)
        text = text.copy()
        text[bad] = rng.integers(0, 4, size=int(bad.sum()), dtype=np.uint8)

    # FM text packs BOTH strands (forward then reverse complement), as the
    # reference's BWA index does (bwabridge.c:319-332): each read is then
    # seeded in ONE orientation and reverse-strand hits land in the upper
    # half of the coordinate space
    text2 = np.concatenate([text, (3 - text)[::-1]]) if n \
        else np.zeros(0, np.uint8)
    n2 = text2.shape[0]

    sa = native.suffix_array(text2, 4) if n2 else np.zeros(0, np.int64)

    # full BWT rows are [$, sa[0], sa[1], ...]; BWT char of row i>0 is
    # text2[sa[i-1]-1], with the $ appearing where sa[i-1] == 0.
    # Assembled with two slice copies (np.delete would copy + fancy-index
    # the whole array again — measurable at GRCh38 scale).
    bwt = np.empty(n2, dtype=np.uint8)
    primary = 0
    if n2:
        zero_row = int(np.nonzero(sa == 0)[0][0]) + 1
        primary = zero_row
        tail = text2[np.maximum(sa - 1, 0)]   # char for rows 1..n2
        bwt[0] = text2[n2 - 1]                # row 0 ($ suffix)
        bwt[1:primary] = tail[:primary - 1]
        bwt[primary:] = tail[primary:]

    counts = np.zeros(5, dtype=np.int64)
    cnt = np.bincount(text2, minlength=4)[:4] if n2 else np.zeros(4, np.int64)
    counts[0] = 1                      # the $ row
    for c in range(4):
        counts[c + 1] = counts[c] + cnt[c]

    occ_blocks = _pack_occ_blocks(bwt)

    # value-sampled SA over full rows 0..n2 (row 0 is $, SA value n2)
    full_sa = np.empty(n2 + 1, dtype=sa.dtype)
    full_sa[0] = n2
    full_sa[1:] = sa
    if sa_rate & (sa_rate - 1) == 0:
        marked = (full_sa & (sa_rate - 1)) == 0
    else:
        marked = (full_sa % sa_rate) == 0
    words, mark_rank, sa_values = pack_value_samples(
        marked, full_sa[marked], n2)

    return ReferenceIndex(
        names=names, offsets=offsets, lengths=lengths, text=text,
        n_mask_intervals=n_mask, primary=primary, counts=counts,
        occ_blocks=occ_blocks, sa_rate=sa_rate,
        sa_mark_words=words, sa_mark_rank=mark_rank.astype(np.int32),
        sa_values=sa_values, fm_n=n2)


def pack_value_samples(marked: np.ndarray, values: np.ndarray, n2: int):
    """Pack the sampled-row bitmap structure for locate.

    ``marked``: dense bool [n2+1] over the full row space; ``values`` the
    SA values of the marked rows in ROW order.  Returns (sa_mark_words
    uint32, sa_mark_rank int32, sa_values int32).  packbits(little) packs
    element 32k+i into bit i of word k — exactly the _is_marked layout.
    """
    n_rows = n2 + 1
    n_words = (n_rows + 31) // 32
    pad = np.zeros(n_words * 32, dtype=bool)
    pad[:n_rows] = marked[:n_rows]
    words = np.packbits(pad, bitorder="little").view(np.uint32)
    per_word = pad.reshape(n_words, 32).sum(axis=1, dtype=np.int64)
    mark_rank = np.zeros(n_words, dtype=np.int64)
    mark_rank[1:] = np.cumsum(per_word)[:-1]
    return words, mark_rank.astype(np.int32), values.astype(np.int32)


def _intervals_from_mask(mask: np.ndarray) -> np.ndarray:
    if not mask.any():
        return np.zeros((0, 2), dtype=np.int64)
    d = np.diff(mask.astype(np.int8))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0] + 1
    if mask[0]:
        starts = np.concatenate([[0], starts])
    if mask[-1]:
        ends = np.concatenate([ends, [mask.shape[0]]])
    return np.stack([starts, ends], axis=1).astype(np.int64)


def _pack_occ_blocks(bwt: np.ndarray) -> np.ndarray:
    """Pack the BWT into rank blocks of one int32 row each.

    Row layout (int32 x 12): [cntA, cntC, cntG, cntT, w0..w7] where cnt* are
    cumulative counts before the block and w* hold 128 bases at 2 bits each
    (base k of the block lives in word k//16, bits 2*(k%16) ..).
    One extra final block carries the totals so rank(k=n) needs no special
    case.
    """
    n = bwt.shape[0]
    n_blocks = n // OCC_BLOCK + 1
    padded = np.zeros(n_blocks * OCC_BLOCK, dtype=np.uint8)
    padded[:n] = bwt
    if n:   # padding must not count as base 0
        padded[n:] = 4

    blocks2d = padded.reshape(n_blocks, OCC_BLOCK)
    per_block = np.empty((n_blocks, 4), dtype=np.int32)
    for c in range(4):
        # bool sum per block: 4 light passes instead of an int64 onehot
        per_block[:, c] = (blocks2d == c).sum(axis=1, dtype=np.int32)
    cum = np.zeros((n_blocks, 4), dtype=np.int64)
    cum[1:] = np.cumsum(per_block[:-1], axis=0, dtype=np.int64)
    padded[padded == 4] = 0          # packing below needs 2-bit codes

    # pack 2-bit codes, 16 per uint32 (base k of a block at bits 2k):
    # 4 codes -> 1 byte in uint8 arithmetic, then view LE bytes as uint32
    # — same layout, ~8x less memory traffic than a uint32 shift-sum
    by = (padded[0::4] | (padded[1::4] << 2) | (padded[2::4] << 4)
          | (padded[3::4] << 6))
    words = np.ascontiguousarray(by).view(np.uint32).reshape(n_blocks, 8)

    out = np.empty((n_blocks, OCC_ROW_WORDS), dtype=np.int32)
    out[:, :4] = cum.astype(np.int32)
    out[:, 4:] = words.view(np.int32)
    return out
