"""`count` stage: preliminary barcode counting (reference: cpp/count.cc).

Streams interleaved FASTQ, and for each pair's read-1 prefix builds
  (a) the 2-bit barcode (first base in the HIGH bits — the preprocessor's
      own convention, count.cc:130; distinct from the aligner codec), and
  (b) the 16-byte fused base*34+qual key (count.cc:129),
counting exact-whitelist hits into `.ema-ncnt` and all observed fused keys
into `.ema-fcnt` (spilled in blocks).  Output files are byte-compatible
with the reference (layouts: SURVEY.md §2.5).

The per-pair work is vectorized: reads stream in chunks and barcode/key
construction happens on [N, 16] uint8 arrays.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from ema_tpu_torch import config

BC_LEN = config.PREPROC_BC_LEN
QUAL_BASE = config.QUAL_BASE
QO = config.ILLUMINA_QUAL_OFFSET

# hash_dna: ACGT->0..3, everything else 0 (common.h:76-89)
HASH_DNA = np.zeros(256, np.uint8)
HASH_DNA_N = np.zeros(256, np.uint8)
for _b, _c in zip(b"ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    HASH_DNA[_b] = _c
    HASH_DNA_N[_b] = _c
HASH_DNA_N[ord("N")] = 4
HASH_DNA_N[ord("n")] = 4


def encode_bc_preproc(bases: np.ndarray) -> np.ndarray:
    """[N, 16] uint8 base codes -> uint32, first base in the high bits.

    Column-wise accumulation: no [N, 16] widened temporary (a 4M-row
    whitelist would materialize 512MB as uint64)."""
    out = np.zeros(bases.shape[0], np.uint32)
    for i in range(BC_LEN):
        out <<= np.uint32(2)
        out |= bases[:, i].astype(np.uint32)
    return out


def decode_bc_preproc_str(bc: int) -> str:
    out = []
    for i in range(BC_LEN - 1, -1, -1):
        out.append("ACGT"[(bc >> (2 * i)) & 3])
    return "".join(out)


def lookup_sorted(wl: np.ndarray, keys: np.ndarray):
    """(indices, found) of keys in a sorted whitelist array."""
    idx = np.searchsorted(wl, keys)
    idxc = np.clip(idx, 0, max(wl.shape[0] - 1, 0))
    found = (idx < wl.shape[0]) & (wl[idxc] == keys) if wl.shape[0] \
        else np.zeros(np.shape(keys), bool)
    return idxc, found


def load_whitelist_file_order(path: str) -> np.ndarray:
    """Whitelist barcodes in preproc encoding, in FILE order with
    duplicates dropped (first occurrence wins, like the reference's
    ``counts[barcode] = 0`` inserts, count.cc:58-63).  File order matters:
    it determines the reference-compatible .ema-ncnt emission and bucket
    assignment order (see native.umap_order_u32)."""
    from ema_tpu_torch import native

    with open(path, "rb") as f:
        data = f.read()
    arr = np.frombuffer(data, np.uint8)
    # fast path: uniform "<16 bases>\n" lines (every real 10x whitelist) —
    # encoded straight off the strided file bytes in native C++
    if (arr.shape[0] % (BC_LEN + 1) == 0 and arr.shape[0]
            and (arr.reshape(-1, BC_LEN + 1)[:, BC_LEN] == ord("\n")).all()
            and b"#" not in data):
        bcs = native.bc_encode_block(arr, BC_LEN + 1)
    else:
        rows = []
        for line in data.splitlines():
            line = line.strip()
            if not line or b"#" in line:
                continue
            rows.append(line[:BC_LEN])
        if not rows:
            return np.zeros(0, np.uint32)
        block = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, BC_LEN)
        bcs = native.bc_encode_block(np.ascontiguousarray(block).reshape(-1),
                                     BC_LEN)
    if (bcs == 0).any():
        raise ValueError("Invalid barcode AAA...AA whitelisted")
    srt = np.sort(bcs)
    if not (srt[1:] == srt[:-1]).any():
        return bcs          # no duplicates (every real whitelist)
    _, first = np.unique(bcs, return_index=True)
    return bcs[np.sort(first)]


def load_whitelist_preproc(path: str) -> np.ndarray:
    """Whitelist barcodes in preproc encoding, sorted uint32 (vectorized:
    10x-scale whitelists hold millions of lines)."""
    return np.sort(load_whitelist_file_order(path))


def umap_order_cached(keys: np.ndarray) -> np.ndarray:
    """native.umap_order_u32 with a content-keyed disk cache.

    Callers must pass pre-deduplicated keys (both call sites pass
    load_whitelist_file_order output, which dedups): the distinct=True
    fast path skips the hashtable duplicate probe.

    The libstdc++ map-order replay costs ~3s for a 4M-barcode whitelist
    and runs once per count AND once per preproc invocation on the same
    whitelist; the cache (u32, ~16MB per whitelist) makes every run after
    the first pay ~30ms.  Keyed by CRC + length of the key bytes;
    EMA_TPU_NO_DISK_CACHE=1 disables."""
    import os
    import tempfile
    import zlib

    from ema_tpu_torch import native

    no_disk = os.environ.get("EMA_TPU_NO_DISK_CACHE", "").lower() \
        in ("1", "true", "yes")
    if no_disk or keys.shape[0] < 500_000:
        return native.umap_order_u32(keys, distinct=True)
    kb = np.ascontiguousarray(keys, np.uint32).tobytes()
    # keyed by key content AND the native .so fingerprint: the replayed
    # iteration order depends on the libstdc++/native build that produced
    # it, so a toolchain change must invalidate the cache (ADVICE r3)
    tag = f"{zlib.crc32(kb):08x}_{len(kb)}_{native.lib_fingerprint()}"
    cache_dir = os.environ.get("EMA_TPU_CACHE_DIR") or os.path.join(
        tempfile.gettempdir(), "ema_tpu_torch_cache")
    path = os.path.join(cache_dir, f"wl_order_v1_{tag}.npy")
    try:
        got = np.load(path)
        if got.dtype == np.uint32 and got.shape[0] <= keys.shape[0]:
            return got.astype(np.int64)
    except Exception:
        pass
    order = native.umap_order_u32(keys, distinct=True)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, order.astype(np.uint32))
        os.replace(tmp, path)
    except Exception:
        pass
    return order


def iter_fastq_line_blocks(stream) -> Iterator[List[bytes]]:
    """Yield flat line lists (length a multiple of 8; one read pair per
    8 lines) from an interleaved FASTQ.

    Block reads + one bulk split per ~4MB instead of 8 readline() calls
    per pair (~5x on the preproc streaming paths).  A truncated trailing
    pair is padded with empty strings, like a readline-based reader."""
    pend = b""
    lines: List[bytes] = []
    while True:
        block = stream.read(1 << 22)
        if not block:
            break
        parts = (pend + block).split(b"\n")
        pend = parts.pop()
        lines.extend(parts)
        n8 = (len(lines) // 8) * 8
        if n8:
            yield lines[:n8]
            lines = lines[n8:]
    if pend:
        lines.append(pend)
    if lines:
        yield lines + [b""] * ((-len(lines)) % 8)


def iter_fastq_pairs(stream) -> Iterator[List[bytes]]:
    """Yield 8-line chunks (one read pair) from an interleaved FASTQ."""
    for lines in iter_fastq_line_blocks(stream):
        for s in range(0, len(lines), 8):
            yield lines[s:s + 8]


def fused_keys_and_barcodes(seqs: np.ndarray, quals: np.ndarray):
    """[N, 16] raw seq/qual bytes -> (ok, has_n, barcode u32, key [N,16] u8).

    Implements count.cc:113-133: reject pairs with qual < '!'; cap quals at
    QUAL_BASE-1; key byte = hash_dna_n(s)*QUAL_BASE + min(QUAL_BASE-1, q-33).
    """
    ok = (quals >= QO).all(axis=1)
    q = np.minimum(quals.astype(np.int32) - QO, QUAL_BASE - 1)
    n_codes = HASH_DNA_N[seqs]
    key = (n_codes.astype(np.uint8) * QUAL_BASE
           + np.maximum(q, 0).astype(np.uint8))
    if seqs.flags.c_contiguous and seqs.shape[1] == BC_LEN:
        from ema_tpu_torch import native
        bc = native.bc_encode_block(seqs.reshape(-1), BC_LEN)
    else:
        bc = encode_bc_preproc(HASH_DNA[seqs])
    has_n = (n_codes == 4).any(axis=1)
    return ok, has_n, bc, key


class FullCountMap:
    """fused-key -> count map with block spill (count.cc:16-34).

    Vectorized: batches buffer raw [N, 16] key arrays; consolidation
    merges them into one sorted (key -> count) table.  The 16 key bytes
    are held as two native u64 columns (decoded big-endian, so the
    numeric (a, b) lexsort order IS the lexicographic byte order) and
    sorted with np.lexsort — much faster than a structured-dtype sort.
    Spill blocks are written sorted by the 16 key bytes — the reference's
    std::map iteration order.  Block BOUNDARIES vs the reference are
    implementation-defined either way (the reference spills on an
    estimated memory threshold, count.cc:144-146); inputs that fit one
    block — the byte-parity contract — are identical.
    """

    CONSOLIDATE_ROWS = 2_000_000

    def __init__(self, out_path: str | None, max_entries: int = 8_000_000):
        self.out = open(out_path, "wb") if out_path else None
        self.max_entries = max_entries
        self.ka = np.empty(0, np.uint64)
        self.kb = np.empty(0, np.uint64)
        self.counts = np.empty(0, np.int64)
        self.pend: List[np.ndarray] = []
        self.pend_rows = 0

    def add_batch(self, keys: np.ndarray):
        if keys.shape[0]:
            self.pend.append(np.ascontiguousarray(keys))
            self.pend_rows += keys.shape[0]
        if self.pend_rows >= self.CONSOLIDATE_ROWS:
            self._consolidate()
            if self.out is not None and self.ka.shape[0] >= self.max_entries:
                self.spill()

    def _consolidate(self):
        if not self.pend:
            return
        raw = np.concatenate(self.pend).view(">u8").reshape(-1, 2)
        self.pend = []
        self.pend_rows = 0
        a = np.concatenate([self.ka, raw[:, 0].astype(np.uint64)])
        b = np.concatenate([self.kb, raw[:, 1].astype(np.uint64)])
        c = np.concatenate(
            [self.counts, np.ones(raw.shape[0], np.int64)])
        order = np.lexsort((b, a))
        a, b, c = a[order], b[order], c[order]
        new = np.empty(a.shape[0], bool)
        new[0] = True
        new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
        idx = np.cumsum(new) - 1
        self.ka, self.kb = a[new], b[new]
        self.counts = np.bincount(
            idx, weights=c, minlength=int(idx[-1]) + 1).astype(np.int64)

    def spill(self):
        self._consolidate()
        n = self.ka.shape[0]
        rec = np.empty(n, np.dtype([("a", ">u8"), ("b", ">u8"),
                                    ("cnt", "<i8")]))
        rec["a"] = self.ka
        rec["b"] = self.kb
        rec["cnt"] = self.counts
        self.out.write(struct.pack("<q", n))
        self.out.write(rec.tobytes())
        self.out.flush()
        self.ka = np.empty(0, np.uint64)
        self.kb = np.empty(0, np.uint64)
        self.counts = np.empty(0, np.int64)

    def close(self):
        if self.out is not None:
            self.spill()   # final block is written even when empty
            self.out.close()


def count(whitelist_path: str, output_prefix: str, stream,
          is_haplotag: bool = False, chunk_pairs: int = 10_000,
          max_map_entries: int = 8_000_000) -> dict:
    """Run the count stage; returns stats.

    ``stream`` is a binary file object with interleaved FASTQ.
    ``chunk_pairs`` applies to haplotag mode only (the sorted-run batch
    size in ``_count_haplotag``); the whitelist path streams ~4 MB line
    blocks regardless.
    """
    if is_haplotag:
        return _count_haplotag(output_prefix, stream, chunk_pairs)

    wl_file = load_whitelist_file_order(whitelist_path)
    sort_idx = np.argsort(wl_file, kind="stable")
    wl = wl_file[sort_idx]                  # sorted view for lookups
    counts = np.zeros(wl.shape[0], dtype=np.int64)
    fc = FullCountMap(f"{output_prefix}.ema-fcnt", max_map_entries)

    total = nice = ignored = 0
    min_len = config.MIN_READ_SIZE

    # bulk path: one ~4MB line block at a time, column slices for
    # seq1/qual1, one array build per block (no per-pair batching)
    for lines in iter_fastq_line_blocks(stream):
        seqs1 = lines[1::8]
        quals1 = lines[3::8]
        sel_s: List[bytes] = []
        sel_q: List[bytes] = []
        for s, q in zip(seqs1, quals1):
            if len(s) >= min_len:
                sel_s.append(s[:BC_LEN])
                sel_q.append(q[:BC_LEN])
            else:
                ignored += 1
        if not sel_s:
            continue
        seqs = np.frombuffer(b"".join(sel_s), np.uint8).reshape(-1, BC_LEN)
        quals = np.frombuffer(b"".join(sel_q), np.uint8).reshape(-1, BC_LEN)
        ok, has_n, bc, key = fused_keys_and_barcodes(seqs, quals)
        good = ok
        total += int(good.sum())
        ignored += int((~good).sum())
        exact = good & ~has_n
        idxc, hit = lookup_sorted(wl, bc[exact])
        np.add.at(counts, idxc[hit], 1)
        nice += int(hit.sum())
        fc.add_batch(key[good])
    fc.close()

    # map sorted-order counts back to file order for reference-compatible
    # emission (count.cc:160-170 iterates the unordered_map)
    counts_file = np.empty_like(counts)   # sort_idx is a permutation
    counts_file[sort_idx] = counts
    _write_ncnt(f"{output_prefix}.ema-ncnt", wl_file, counts_file)
    return {"total": total, "nice": nice, "ignored": ignored}


def _write_ncnt(path: str, barcodes_file_order: np.ndarray,
                counts: np.ndarray):
    """Emit nonzero (barcode, count) pairs in the reference's map-iteration
    order over the insertion (file-order) sequence."""
    order = umap_order_cached(barcodes_file_order)
    bcs = barcodes_file_order[order]
    cnts = counts[order]
    nz = cnts > 0
    with open(path, "wb") as f:
        f.write(struct.pack("<q", int(nz.sum())))
        inter = np.empty(int(nz.sum()), dtype=np.dtype(
            [("bc", "<u4"), ("cnt", "<i8")]))
        inter["bc"] = bcs[nz]
        inter["cnt"] = cnts[nz]
        f.write(inter.tobytes())


def read_ncnt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        n = struct.unpack("<q", f.read(8))[0]
        data = np.frombuffer(f.read(n * 12),
                             dtype=np.dtype([("bc", "<u4"), ("cnt", "<i8")]))
    return data["bc"].copy(), data["cnt"].copy()


def read_fcnt_blocks(path: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (keys [N, 16] uint8, counts [N]) per spill block."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            n = struct.unpack("<q", head)[0]
            rec = np.frombuffer(f.read(n * 24), dtype=np.dtype(
                [("key", "u1", 16), ("cnt", "<i8")]))
            yield rec["key"].copy(), rec["cnt"].copy()


_HAPLOTAG_CACHE: dict = {}


def haplotag_all_codes() -> np.ndarray:
    """The full 96^4 haplotag code space in the reference's generation
    order (common.h:72 GenerateAllHaplotagBC: nested a, b, c, d loops over
    1..96 inserting a<<24 | c<<16 | b<<8 | d)."""
    if "codes" not in _HAPLOTAG_CACHE:
        r = np.arange(1, 97, dtype=np.uint32)
        keys = ((r[:, None, None, None] << 24)
                | (r[None, None, :, None] << 16)    # axis 2 = c field
                | (r[None, :, None, None] << 8)     # axis 1 = b field
                | r[None, None, None, :])           # axis 3 = d field
        _HAPLOTAG_CACHE["codes"] = keys.ravel()
    return _HAPLOTAG_CACHE["codes"]


def haplotag_emission_order() -> np.ndarray:
    """Reference map-iteration order over the generated haplotag space.

    The 85M-key libstdc++ replay costs ~a minute; cached per process and
    (as u32, ~340MB) on disk so repeated CLI invocations skip it.  Set
    EMA_TPU_CACHE_DIR to move the cache, EMA_TPU_NO_DISK_CACHE=1 to
    disable the disk layer.
    """
    if "order" in _HAPLOTAG_CACHE:
        return _HAPLOTAG_CACHE["order"]
    import os
    import tempfile

    from ema_tpu_torch import native

    n = 96 ** 4
    no_disk = os.environ.get("EMA_TPU_NO_DISK_CACHE", "").lower() \
        in ("1", "true", "yes")
    cache_dir = os.environ.get("EMA_TPU_CACHE_DIR") or os.path.join(
        tempfile.gettempdir(), "ema_tpu_torch_cache")
    # the replayed order depends on the libstdc++/native build, so the
    # .so fingerprint is part of the key (auto-invalidates on toolchain
    # or source changes; ADVICE r3)
    path = os.path.join(
        cache_dir, f"haplotag_order_v1_{n}_{native.lib_fingerprint()}.npy")
    order = None
    if not no_disk:
        try:
            got = np.load(path)
            if got.shape == (n,) and got.dtype == np.uint32:
                order = got.astype(np.int64)
        except Exception:
            pass
    if order is None:
        order = native.umap_order_u32(haplotag_all_codes(), distinct=True)
        if not no_disk:
            try:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:  # file obj: no .npy suffixing
                    np.save(f, order.astype(np.uint32))
                os.replace(tmp, path)       # atomic vs concurrent runs
            except Exception:
                pass
    _HAPLOTAG_CACHE["order"] = order
    return order


def parse_haplotag_bx(name: bytes, len_check: int | None = None):
    """BX:Z: haplotag code from a read name, reference-style: search only
    after the first whitespace and require 12 code chars (count.cc:89-102).

    ``len_check`` overrides the length the 'room for the tag' test is made
    against (correct.cc phase 4 checks against a stale variable,
    correct.cc:441-444 — callers replicate that bug for byte parity).
    Returns (packed code or None, 12-char code bytes).  Packing follows
    the reference's TwoCharToInt arithmetic exactly, including the
    garbage-in-garbage-out behavior on non-digit characters and uint32
    shift wraparound (common.h:68-71)."""
    ws = -1
    for i, ch in enumerate(name):
        if ch in (0x20, 0x09):
            ws = i
            break
    if ws < 0:
        return None, b""
    bx = name.find(b"BX:Z:", ws)
    if bx < 0:
        return None, b""
    limit = len(name) if len_check is None else len_check
    if not (bx + 16 < limit):
        return None, b""
    # a truncated tag can pass the stale-length check; NUL padding mirrors
    # std::string's terminator reads in TwoCharToInt
    code = name[bx + 5:bx + 17].ljust(12, b"\x00")

    def two(i):
        return 10 * (code[i] - 48) + (code[i + 1] - 48)
    M = 0xFFFFFFFF
    a, cf, b, d = two(1), two(4), two(7), two(10)
    packed = ((((a & M) << 24) & M) | (((cf & M) << 16) & M)
              | (((b & M) << 8) & M) | (d & M))
    return packed, code


def _count_haplotag(output_prefix: str, stream, chunk_pairs: int) -> dict:
    """Haplotag mode: count BX:Z:AxxCxxBxxDxx tags against the full 96^4
    generated code space (count.cc:68, 89-103); codes outside the space
    are streamed through uncounted, like the reference's counts.find miss."""
    counts: Dict[int, int] = {}
    total = nice = ignored = 0
    for pair in iter_fastq_pairs(stream):
        seq1 = pair[1]
        bc, _ = parse_haplotag_bx(pair[0])
        if bc is None or len(seq1) < config.MIN_READ_SIZE:
            ignored += 1
            continue
        total += 1
        if all(1 <= ((bc >> s) & 0xFF) <= 96 for s in (24, 16, 8, 0)):
            counts[bc] = counts.get(bc, 0) + 1
            nice += 1
    # reference-order emission over the whole generated code space
    ordered = haplotag_all_codes()[haplotag_emission_order()]
    if counts:
        obs = np.fromiter(counts.keys(), np.uint32, len(counts))
        cnt = np.fromiter(counts.values(), np.int64, len(counts))
        si = np.argsort(obs)
        obs, cnt = obs[si], cnt[si]
        idxc, hit = lookup_sorted(obs, ordered)
        ocnt = np.where(hit, cnt[idxc], 0)
    else:
        ocnt = np.zeros(ordered.shape[0], np.int64)
    nz = ocnt > 0
    with open(f"{output_prefix}.ema-ncnt", "wb") as f:
        f.write(struct.pack("<q", int(nz.sum())))
        inter = np.empty(int(nz.sum()), dtype=np.dtype(
            [("bc", "<u4"), ("cnt", "<i8")]))
        inter["bc"] = ordered[nz]
        inter["cnt"] = ocnt[nz]
        f.write(inter.tobytes())
    return {"total": total, "nice": nice, "ignored": ignored}
