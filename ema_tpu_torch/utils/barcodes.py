"""Barcode codecs.

Semantics match the reference exactly so that encoded barcode values (and
therefore sort orders, bucket assignments and BX tags) are interchangeable:

  - default 2-bit codec: the *first* base of the barcode lands in the lowest
    two bits (reference: src/util.c:41-61 encodes from the last base down,
    shifting left; src/util.c:78-84 decodes low bits first).
  - haplotag codec: AxxCxxBxxDxx packed as A<<24 | C<<16 | B<<8 | D
    (reference: src/util.c:63-70, 86-89).

Batched variants operate on numpy uint8 base arrays for the vectorized
preprocessing path.
"""

from __future__ import annotations

import numpy as np

_BASE_TO_CODE = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2, "T": 3, "t": 3}
_CODE_TO_BASE = "ACGT"

# uint8 lookup: ACGT/acgt -> 0..3, N -> 4, everything else -> 255
BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in _BASE_TO_CODE.items():
    BASE_LUT[ord(_b)] = _c
BASE_LUT[ord("N")] = 4
BASE_LUT[ord("n")] = 4


def encode_bc_default(bc: str) -> int:
    """2-bit encode a barcode string; first base in the low bits."""
    v = 0
    for base in reversed(bc):
        v = (v << 2) | _BASE_TO_CODE[base]
    return v


def decode_bc_default(bc: int, bc_len: int) -> str:
    out = []
    for _ in range(bc_len):
        out.append(_CODE_TO_BASE[bc & 0x3])
        bc >>= 2
    return "".join(out)


def encode_bc_haplotag(bc: str) -> int:
    """Pack 'AxxCxxBxxDxx' as A<<24 | C<<16 | B<<8 | D."""
    a = int(bc[1:3])
    c = int(bc[4:6])
    b = int(bc[7:9])
    d = int(bc[10:12])
    return (a << 24) | (c << 16) | (b << 8) | d


def decode_bc_haplotag(bc: int) -> str:
    return "A%02dC%02dB%02dD%02d" % (
        (bc >> 24) & 127, (bc >> 16) & 127, (bc >> 8) & 127, bc & 127)


def encode_bc(bc: str, is_haplotag: bool = False) -> int:
    return encode_bc_haplotag(bc) if is_haplotag else encode_bc_default(bc)


def decode_bc(bc: int, bc_len: int, is_haplotag: bool = False) -> str:
    return decode_bc_haplotag(bc) if is_haplotag else decode_bc_default(bc, bc_len)


# ---------------------------------------------------------------------------
# Batched codecs (vectorized over many barcodes)
# ---------------------------------------------------------------------------

def encode_bc_batch(bases: np.ndarray) -> np.ndarray:
    """Encode [N, bc_len] uint8 base codes (0..3) -> [N] uint64.

    First base (column 0) lands in the low bits, matching encode_bc_default.
    """
    n, bc_len = bases.shape
    shifts = (2 * np.arange(bc_len, dtype=np.uint64))[None, :]
    return np.sum(bases.astype(np.uint64) << shifts, axis=1, dtype=np.uint64)


def decode_bc_batch(codes: np.ndarray, bc_len: int) -> np.ndarray:
    """Decode [N] uint64 -> [N, bc_len] uint8 base codes (0..3)."""
    shifts = (2 * np.arange(bc_len, dtype=np.uint64))[None, :]
    return ((codes[:, None].astype(np.uint64) >> shifts) & np.uint64(3)).astype(np.uint8)


def bases_to_str(codes: np.ndarray) -> str:
    return "".join(_CODE_TO_BASE[c] for c in codes)


# ---------------------------------------------------------------------------
# Platform-specific extraction of barcodes from read IDs
# (reference: src/techs.c:5-69)
# ---------------------------------------------------------------------------

def extract_bc_from_id(read_id: str, platform: str) -> tuple[str, int]:
    """Extract the barcode from a read ID; returns (trimmed_id, encoded_bc).

    The reference mutates the ID in place, truncating at the barcode
    separator (and at the first space for Long Ranger-format IDs); we return
    the trimmed ID alongside the encoded barcode.
    """
    rid = read_id[1:] if read_id.startswith("@") else read_id

    if platform in ("10x", "dbs"):
        head, _, bc_str = rid.rpartition(":")
        sp = head.find(" ")
        if sp >= 0:
            head = head[:sp]
        return head, encode_bc_default(bc_str)

    if platform == "haplotag":
        head, _, bc_str = rid.rpartition(":")
        sp = head.find(" ")
        if sp >= 0:
            head = head[:sp]
        return head, encode_bc_haplotag(bc_str)

    if platform == "tellseq":
        sp = rid.find(" ")
        if sp >= 0:
            tail = rid[sp:]
            if tail.startswith(" BX:Z:"):
                head = rid[:sp]
                bc_str = tail.rpartition(":")[2]
                return head, encode_bc_default(bc_str)
            rid = rid[:sp]
        head, _, bc_str = rid.rpartition(":")
        return head, encode_bc_default(bc_str)

    if platform == "tru":
        # the whole (leading-numeric) ID is the barcode (src/techs.c:57-61)
        num = ""
        for ch in rid:
            if ch.isdigit() or (ch == "-" and not num):
                num += ch
            else:
                break
        return rid, int(num) if num else 0

    if platform == "cpt":
        head, _, tail = rid.rpartition(":")
        num = ""
        for ch in tail[2:]:
            if ch.isdigit() or (ch == "-" and not num):
                num += ch
            else:
                break
        return head, int(num) if num else 0

    raise ValueError(f"unknown platform: {platform!r}")
