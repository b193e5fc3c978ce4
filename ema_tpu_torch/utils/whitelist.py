"""Barcode whitelist dictionary.

The reference builds a 2^24-entry "jumpgate" index over the high 24 bits of
each 32-bit barcode plus bsearch within a bucket (src/barcodes.c:21-109).
Here the whitelist is a sorted numpy array and lookups are vectorized
``searchsorted`` — same O(log n) contract, but batched over millions of
queries at once.  The on-disk serialized form is byte-compatible with the
reference (src/barcodes.c:144-182: 2^24 u32 jumpgate, u64 size, then
{u32 bc, u32 count} entries, little-endian).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ema_tpu_torch.utils.barcodes import encode_bc_default

_POW_2_24 = 1 << 24


def _hi24(bc: np.ndarray) -> np.ndarray:
    return (bc & np.uint64(0xFFFFFF00)) >> np.uint64(8)


@dataclasses.dataclass
class BarcodeDict:
    barcodes: np.ndarray           # sorted uint64 (10x barcodes fit in u32)
    counts: np.ndarray             # int64 per-barcode counts
    priors: np.ndarray | None = None
    unfound: int = 0

    @property
    def size(self) -> int:
        return int(self.barcodes.shape[0])

    # -- construction -------------------------------------------------------

    @classmethod
    def from_whitelist_file(cls, path: str) -> "BarcodeDict":
        """Load a text whitelist, one barcode per line ('#' lines skipped).

        Reference: src/barcodes.c:21-77.
        """
        bcs = []
        with open(path, "r") as f:
            for line in f:
                if "#" in line:
                    continue
                line = line.strip()
                if line:
                    bcs.append(encode_bc_default(line))
        arr = np.sort(np.asarray(bcs, dtype=np.uint64))
        return cls(arr, np.zeros(arr.shape[0], dtype=np.int64))

    @classmethod
    def from_barcodes(cls, barcodes: np.ndarray) -> "BarcodeDict":
        arr = np.sort(np.asarray(barcodes, dtype=np.uint64))
        return cls(arr, np.zeros(arr.shape[0], dtype=np.int64))

    # -- lookups ------------------------------------------------------------

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized lookup; returns index into the dict, or -1 if absent."""
        keys = np.asarray(keys, dtype=np.uint64)
        idx = np.searchsorted(self.barcodes, keys)
        idx_c = np.clip(idx, 0, self.size - 1)
        found = (idx < self.size) & (self.barcodes[idx_c] == keys)
        return np.where(found, idx_c, -1).astype(np.int64)

    def increment(self, keys: np.ndarray) -> np.ndarray:
        """Count observed barcodes (reference: wl_increment, barcodes.c:111-122)."""
        idx = self.lookup(keys)
        found = idx >= 0
        np.add.at(self.counts, idx[found], 1)
        self.unfound += int((~found).sum())
        return found

    def compute_priors(self) -> None:
        """+1-pseudocount priors (reference: wl_compute_priors, barcodes.c:124-137)."""
        total = float((self.counts + 1).sum())
        self.priors = (self.counts + 1.0) / total

    def get_bucket(self, idx: np.ndarray, n_buckets: int) -> np.ndarray:
        """Proportional bucket assignment (reference: wl_get_bucket, barcodes.c:139-142)."""
        return (np.asarray(idx, dtype=np.int64) * n_buckets) // self.size

    # -- serialization (byte-compatible with the reference) -----------------

    def serialize(self, path: str) -> None:
        hi = _hi24(self.barcodes).astype(np.int64)
        # jumpgate[h] = index of first entry with hi24 >= h (reference fills
        # ranges between successive hi values, barcodes.c:51-71)
        jumpgate = np.searchsorted(hi, np.arange(_POW_2_24, dtype=np.int64)).astype(np.uint32)
        with open(path, "wb") as f:
            f.write(jumpgate.astype("<u4").tobytes())
            f.write(np.uint64(self.size).astype("<u8").tobytes())
            inter = np.empty((self.size, 2), dtype="<u4")
            inter[:, 0] = self.barcodes.astype(np.uint32)
            inter[:, 1] = self.counts.astype(np.uint32)
            f.write(inter.tobytes())

    @classmethod
    def deserialize(cls, path: str) -> "BarcodeDict":
        with open(path, "rb") as f:
            f.seek(_POW_2_24 * 4)  # jumpgate is derivable; skip it
            size = int(np.frombuffer(f.read(8), dtype="<u8")[0])
            inter = np.frombuffer(f.read(size * 8), dtype="<u4").reshape(size, 2)
        return cls(inter[:, 0].astype(np.uint64), inter[:, 1].astype(np.int64))
