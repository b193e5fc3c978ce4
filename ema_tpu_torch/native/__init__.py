"""ctypes bindings for the ema_native C++ library (the port's own copy of
ema_tpu/native: the same source, entry points and Python wrappers).

Nothing compiles at import.  The first call of ``get_lib()`` builds
``ema_native.cpp`` with g++ into ``build/ema_tpu_torch/`` at the checkout
root, named by a hash of the source and the flags, through a temporary
file that carries the pid and an ``os.replace``: processes that build at
once each write their own file and the last rename wins with identical
bytes.  It is built with ``-march=native``, so a library is never carried
from one machine to another.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ema_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ema_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
             "-funroll-loops")

_lock = threading.Lock()
_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libema_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))

        lib.sais_u8.restype = None
        lib.sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
        ]

        lib.sais_u8_i32.restype = None
        lib.sais_u8_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
        ]

        lib.format_sam_batch.restype = ctypes.c_int64
        lib.format_sam_batch.argtypes = [
            ctypes.c_int64,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ]

        lib.sw_banded_native.restype = None
        lib.sw_banded_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sw_banded_native_scalar.restype = None
        lib.sw_banded_native_scalar.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]

        lib.bc_hash_build.restype = None
        lib.bc_hash_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.bc_hash_probe.restype = None
        lib.bc_hash_probe.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ]
        _scan_args = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
        ]
        lib.bc_h1_scan.restype = None
        lib.bc_h1_scan.argtypes = _scan_args[:2] + [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ] + _scan_args[2:]
        lib.bc_h2_scan.restype = None
        lib.bc_h2_scan.argtypes = _scan_args

        lib.umap_order_u32.restype = ctypes.c_int64
        lib.umap_order_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.umap_order_u32_sim.restype = ctypes.c_int64
        lib.umap_order_u32_sim.argtypes = \
            lib.umap_order_u32.argtypes + [ctypes.c_int32]
        lib.bwa_sa_import_locate.restype = ctypes.c_int64
        lib.bwa_sa_import_locate.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bc_encode_block.restype = None
        lib.bc_encode_block.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.cigar_stats_pool.restype = None
        lib.cigar_stats_pool.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ] + [ctypes.POINTER(ctypes.c_int64)] * 5

        lib.bucket_assign_pq.restype = None
        lib.bucket_assign_pq.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]

        lib.em_run_flat.restype = None
        lib.em_run_flat.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ]

        lib.smem_seed_batch.restype = None
        lib.smem_seed_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]

        lib.smem_kmer_table.restype = None
        lib.smem_kmer_table.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]

        lib.greedy_seed_batch.restype = None
        lib.greedy_seed_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]

        lib.locate_batch.restype = None
        lib.locate_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]

        lib.sa_optimize.restype = None
        lib.sa_optimize.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ]

        lib.sa_optimize_best.restype = None
        lib.sa_optimize_best.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
        ]

        lib.align_batch.restype = None
        lib.align_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]

        lib.traceback_batch.restype = None
        lib.traceback_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


_fingerprint = None


def lib_fingerprint() -> str:
    """CRC32 of the built .so, for keying disk caches whose contents
    depend on the native library (e.g. libstdc++ map-iteration-order
    replays).  A toolchain or source change produces a new .so and hence
    a new key, so stale cached orders can't be silently reused."""
    global _fingerprint
    if _fingerprint is None:
        import zlib
        get_lib()  # ensure the .so exists and is current
        with open(_so_path(), "rb") as f:  # the file get_lib() loaded
            _fingerprint = f"{zlib.crc32(f.read()):08x}"
    return _fingerprint


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def suffix_array(text: np.ndarray, alphabet_size: int) -> np.ndarray:
    """Suffix array of a uint8 text (values in [0, alphabet_size)).

    Texts under 2^31 use the int32 SA-IS variant (half the index-array
    bandwidth) and return int32; larger texts return int64.
    """
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    if n < 2**31 - 1:
        sa32 = np.empty(n, dtype=np.int32)
        get_lib().sais_u8_i32(
            _ptr(text, ctypes.c_uint8), _ptr(sa32, ctypes.c_int32),
            ctypes.c_int64(n), ctypes.c_int64(alphabet_size))
        return sa32
    sa = np.empty(n, dtype=np.int64)
    get_lib().sais_u8(_ptr(text, ctypes.c_uint8), _ptr(sa, ctypes.c_int64),
                      ctypes.c_int64(n), ctypes.c_int64(alphabet_size))
    return sa


def format_sam_batch(names_blob: bytes, name_off: np.ndarray,
                     seqs_blob: bytes, seq_off: np.ndarray,
                     quals_blob: bytes, qual_off: np.ndarray,
                     chroms_blob: bytes, chrom_off: np.ndarray,
                     flag, chrom_idx, pos, mapq, rnext_idx, pnext, tlen,
                     rev, cig_off, cig_len, cig_pool, nm, gamma, mi, xf,
                     alt_chrom, alt_pos, alt_rev, alt_cig_off, alt_cig_len,
                     alt_nm, lr, bx, rg: bytes) -> bytes:
    """Batched SAM line assembly (reference print_sam_record,
    samrecord.c:104-284).  Returns the concatenated lines as bytes.

    ``bx``: either one bytes value applied to every record, or a
    ``(blob: bytes, offsets: int64[M+1])`` pair for per-record BX
    (cross-group batched emission)."""
    M = int(flag.shape[0])
    if isinstance(bx, tuple):
        bx_blob, bx_off = bx
        bx_off = np.ascontiguousarray(bx_off, np.int64)
    else:
        bx_blob = bx * M
        bx_off = np.arange(M + 1, dtype=np.int64) * len(bx)
    lib = get_lib()
    # materialize every array up front and keep references alive for the
    # duration of the call (ctypes pointers do not own their numpy arrays)
    keep = [
        np.ascontiguousarray(name_off, np.int64),
        np.ascontiguousarray(seq_off, np.int64),
        np.ascontiguousarray(qual_off, np.int64),
        np.ascontiguousarray(chrom_off, np.int64),
        np.ascontiguousarray(flag, np.int32),
        np.ascontiguousarray(chrom_idx, np.int32),
        np.ascontiguousarray(pos, np.int64),
        np.ascontiguousarray(mapq, np.int32),
        np.ascontiguousarray(rnext_idx, np.int32),
        np.ascontiguousarray(pnext, np.int64),
        np.ascontiguousarray(tlen, np.int64),
        np.ascontiguousarray(rev, np.int32),
        np.ascontiguousarray(cig_off, np.int64),
        np.ascontiguousarray(cig_len, np.int32),
        np.ascontiguousarray(cig_pool, np.uint32),
        np.ascontiguousarray(nm, np.int32),
        np.ascontiguousarray(gamma, np.float64),
        np.ascontiguousarray(mi, np.int64),
        np.ascontiguousarray(xf, np.int32),
        np.ascontiguousarray(alt_chrom, np.int32),
        np.ascontiguousarray(alt_pos, np.int64),
        np.ascontiguousarray(alt_rev, np.int32),
        np.ascontiguousarray(alt_cig_off, np.int64),
        np.ascontiguousarray(alt_cig_len, np.int32),
        np.ascontiguousarray(alt_nm, np.int32),
        np.ascontiguousarray(lr, np.int32),
    ]
    (name_off, seq_off, qual_off, chrom_off, flag, chrom_idx, pos, mapq,
     rnext_idx, pnext, tlen, rev, cig_off, cig_len, cig_pool, nm, gamma,
     mi, xf, alt_chrom, alt_pos, alt_rev, alt_cig_off, alt_cig_len,
     alt_nm, lr) = keep
    cap = (len(names_blob) + 2 * len(seqs_blob) + 512 * M + 4096)
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.format_sam_batch(
            ctypes.c_int64(M),
            names_blob, _ptr(name_off, ctypes.c_int64),
            seqs_blob, _ptr(seq_off, ctypes.c_int64),
            quals_blob, _ptr(qual_off, ctypes.c_int64),
            chroms_blob, _ptr(chrom_off, ctypes.c_int64),
            ctypes.c_int32(chrom_off.shape[0] - 1),
            _ptr(flag, ctypes.c_int32), _ptr(chrom_idx, ctypes.c_int32),
            _ptr(pos, ctypes.c_int64), _ptr(mapq, ctypes.c_int32),
            _ptr(rnext_idx, ctypes.c_int32), _ptr(pnext, ctypes.c_int64),
            _ptr(tlen, ctypes.c_int64), _ptr(rev, ctypes.c_int32),
            _ptr(cig_off, ctypes.c_int64), _ptr(cig_len, ctypes.c_int32),
            _ptr(cig_pool, ctypes.c_uint32),
            _ptr(nm, ctypes.c_int32), _ptr(gamma, ctypes.c_double),
            _ptr(mi, ctypes.c_int64), _ptr(xf, ctypes.c_int32),
            _ptr(alt_chrom, ctypes.c_int32), _ptr(alt_pos, ctypes.c_int64),
            _ptr(alt_rev, ctypes.c_int32),
            _ptr(alt_cig_off, ctypes.c_int64),
            _ptr(alt_cig_len, ctypes.c_int32), _ptr(alt_nm, ctypes.c_int32),
            _ptr(lr, ctypes.c_int32), bx_blob,
            _ptr(bx_off, ctypes.c_int64), rg,
            ctypes.c_int32(len(rg)), buf, ctypes.c_int64(cap))
        if n >= 0:
            return buf.raw[:n]
        cap *= 2


def align_batch(reads: np.ndarray, read_lens: np.ndarray,
                refs: np.ndarray, ref_lens: np.ndarray,
                match: int = 1, mismatch: int = 4,
                gap_open: int = 6, gap_extend: int = 1,
                clip_penalty: int = 5, max_cigar: int = 64):
    """Batched affine-gap alignment with traceback.

    reads: [B, m_max] uint8 codes (0-3, 4=N); refs: [B, n_max].
    Returns dict of per-item arrays: score, pos, qb, qe, nm, n_cigar,
    cigars [B, max_cigar] (BAM encoding: len<<4|op, op 0=M 1=I 2=D 4=S).
    """
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    refs = np.ascontiguousarray(refs, dtype=np.uint8)
    read_lens = np.ascontiguousarray(read_lens, dtype=np.int32)
    ref_lens = np.ascontiguousarray(ref_lens, dtype=np.int32)
    B, m_max = reads.shape
    _, n_max = refs.shape
    score = np.empty(B, dtype=np.int32)
    pos = np.empty(B, dtype=np.int32)
    qb = np.empty(B, dtype=np.int32)
    qe = np.empty(B, dtype=np.int32)
    nm = np.empty(B, dtype=np.int32)
    n_cigar = np.empty(B, dtype=np.int32)
    cigars = np.zeros((B, max_cigar), dtype=np.uint32)
    get_lib().align_batch(
        _ptr(reads, ctypes.c_uint8), _ptr(read_lens, ctypes.c_int32),
        ctypes.c_int32(m_max),
        _ptr(refs, ctypes.c_uint8), _ptr(ref_lens, ctypes.c_int32),
        ctypes.c_int32(n_max),
        ctypes.c_int32(B),
        ctypes.c_int32(match), ctypes.c_int32(mismatch),
        ctypes.c_int32(gap_open), ctypes.c_int32(gap_extend),
        ctypes.c_int32(clip_penalty),
        _ptr(score, ctypes.c_int32), _ptr(pos, ctypes.c_int32),
        _ptr(qb, ctypes.c_int32), _ptr(qe, ctypes.c_int32),
        _ptr(nm, ctypes.c_int32), _ptr(cigars, ctypes.c_uint32),
        _ptr(n_cigar, ctypes.c_int32),
        ctypes.c_int32(max_cigar),
    )
    return {
        "score": score, "pos": pos, "qb": qb, "qe": qe, "nm": nm,
        "n_cigar": n_cigar, "cigars": cigars,
    }


def traceback_batch(oriented: np.ndarray, olens: np.ndarray,
                    rows: np.ndarray, text: np.ndarray,
                    win_lo: np.ndarray, win_len: np.ndarray,
                    sw: dict, match=1, mismatch=4, gap_open=6,
                    gap_extend=1, clip_penalty=5, max_cigar=24,
                    n_threads=0) -> dict:
    """Gapless-shortcut + DP traceback for scored candidates; windows
    are read directly from the packed genome ``text`` (sentinel 5 out of
    range) — no [N, W] host gather.  See ema_native.cpp traceback_batch.

    oriented: [R, m_max] uint8 read matrix; rows[b] selects candidate
    b's read row; olens[b] its length.  sw: dict with per-candidate
    int32 arrays score/qb/qe/ref_end.
    """
    oriented = np.ascontiguousarray(oriented, np.uint8)
    rows = np.ascontiguousarray(rows, np.int64)
    olens = np.ascontiguousarray(
        np.asarray(olens, np.int32)[rows], np.int32)  # per candidate
    text = np.ascontiguousarray(text, np.uint8)
    win_lo = np.ascontiguousarray(win_lo, np.int64)
    win_len = np.ascontiguousarray(win_len, np.int32)
    s_sc = np.ascontiguousarray(sw["score"], np.int32)
    s_qb = np.ascontiguousarray(sw["qb"], np.int32)
    s_qe = np.ascontiguousarray(sw["qe"], np.int32)
    s_re = np.ascontiguousarray(sw["ref_end"], np.int32)
    B = rows.shape[0]
    m_max = oriented.shape[1]
    score = np.empty(B, np.int32)
    pos = np.empty(B, np.int32)
    qb = np.empty(B, np.int32)
    qe = np.empty(B, np.int32)
    nm = np.empty(B, np.int32)
    n_cigar = np.zeros(B, np.int32)
    cigars = np.zeros((B, max_cigar), np.uint32)
    if B == 0:
        return {"score": score, "pos": pos, "qb": qb, "qe": qe, "nm": nm,
                "n_cigar": n_cigar, "cigars": cigars}
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    get_lib().traceback_batch(
        _ptr(oriented, ctypes.c_uint8), ctypes.c_int32(m_max),
        _ptr(olens, ctypes.c_int32),
        _ptr(rows, ctypes.c_int64), ctypes.c_int32(B),
        _ptr(text, ctypes.c_uint8), ctypes.c_int64(text.shape[0]),
        _ptr(win_lo, ctypes.c_int64), _ptr(win_len, ctypes.c_int32),
        _ptr(s_sc, ctypes.c_int32), _ptr(s_qb, ctypes.c_int32),
        _ptr(s_qe, ctypes.c_int32), _ptr(s_re, ctypes.c_int32),
        ctypes.c_int32(match), ctypes.c_int32(mismatch),
        ctypes.c_int32(gap_open), ctypes.c_int32(gap_extend),
        ctypes.c_int32(clip_penalty),
        ctypes.c_int32(n_threads),
        _ptr(score, ctypes.c_int32), _ptr(pos, ctypes.c_int32),
        _ptr(qb, ctypes.c_int32), _ptr(qe, ctypes.c_int32),
        _ptr(nm, ctypes.c_int32), _ptr(cigars, ctypes.c_uint32),
        _ptr(n_cigar, ctypes.c_int32), ctypes.c_int32(max_cigar))
    return {"score": score, "pos": pos, "qb": qb, "qe": qe, "nm": nm,
            "n_cigar": n_cigar, "cigars": cigars}


def sa_optimize(pos, chrom, rev, score, umap_local, mm_start, mm_n,
                mm_mate_umap, mm_mate_mmap, mm_active, bins, lo, bin_size,
                log_probs, iters, tmax_log, tmin_log, max_no_move,
                score_scale, insert_min, insert_max, seed) -> np.ndarray:
    """Simulated-annealing density resolver (reference split.c:223-325).

    Mutates and returns ``mm_active`` (the chosen alignment per
    multimapped read); ``bins`` is updated in place too.
    """
    pos = np.ascontiguousarray(pos, np.int64)
    chrom = np.ascontiguousarray(chrom, np.int32)
    rev = np.ascontiguousarray(rev, np.int8)
    score = np.ascontiguousarray(score, np.float64)
    umap_local = np.ascontiguousarray(umap_local, np.int64)
    mm_start = np.ascontiguousarray(mm_start, np.int64)
    mm_n = np.ascontiguousarray(mm_n, np.int64)
    mm_mate_umap = np.ascontiguousarray(mm_mate_umap, np.int64)
    mm_mate_mmap = np.ascontiguousarray(mm_mate_mmap, np.int64)
    mm_active = np.ascontiguousarray(mm_active, np.int64)
    bins = np.ascontiguousarray(bins, np.int64)
    log_probs = np.ascontiguousarray(log_probs, np.float64)
    get_lib().sa_optimize(
        _ptr(pos, ctypes.c_int64), _ptr(chrom, ctypes.c_int32),
        _ptr(rev, ctypes.c_int8), _ptr(score, ctypes.c_double),
        _ptr(umap_local, ctypes.c_int64), ctypes.c_int64(umap_local.shape[0]),
        _ptr(mm_start, ctypes.c_int64), _ptr(mm_n, ctypes.c_int64),
        _ptr(mm_mate_umap, ctypes.c_int64), _ptr(mm_mate_mmap, ctypes.c_int64),
        _ptr(mm_active, ctypes.c_int64), ctypes.c_int64(mm_active.shape[0]),
        _ptr(bins, ctypes.c_int64), ctypes.c_int64(lo),
        ctypes.c_int64(bin_size),
        _ptr(log_probs, ctypes.c_double), ctypes.c_int64(log_probs.shape[0]),
        ctypes.c_int64(iters), ctypes.c_double(tmax_log),
        ctypes.c_double(tmin_log), ctypes.c_int64(max_no_move),
        ctypes.c_double(score_scale),
        ctypes.c_int64(insert_min), ctypes.c_int64(insert_max),
        ctypes.c_uint64(seed))
    return mm_active


def sa_optimize_best(pos, chrom, rev, score, umap_local, mm_start, mm_n,
                     mm_mate_umap, mm_mate_mmap, mm_active, bins, lo,
                     bin_size, log_probs, iters, tmax_log, tmin_log,
                     max_no_move, score_scale, insert_min, insert_max,
                     seeds, n_threads=0) -> np.ndarray:
    """Best-of-N seeded annealing chains (parallel threads); see
    ema_native.cpp sa_optimize_best.  Mutates/returns ``mm_active`` and
    ``bins`` with the winning chain's final state."""
    pos = np.ascontiguousarray(pos, np.int64)
    chrom = np.ascontiguousarray(chrom, np.int32)
    rev = np.ascontiguousarray(rev, np.int8)
    score = np.ascontiguousarray(score, np.float64)
    umap_local = np.ascontiguousarray(umap_local, np.int64)
    mm_start = np.ascontiguousarray(mm_start, np.int64)
    mm_n = np.ascontiguousarray(mm_n, np.int64)
    mm_mate_umap = np.ascontiguousarray(mm_mate_umap, np.int64)
    mm_mate_mmap = np.ascontiguousarray(mm_mate_mmap, np.int64)
    mm_active = np.ascontiguousarray(mm_active, np.int64)
    bins = np.ascontiguousarray(bins, np.int64)
    log_probs = np.ascontiguousarray(log_probs, np.float64)
    seeds = np.ascontiguousarray(seeds, np.uint64)
    get_lib().sa_optimize_best(
        _ptr(pos, ctypes.c_int64), _ptr(chrom, ctypes.c_int32),
        _ptr(rev, ctypes.c_int8), _ptr(score, ctypes.c_double),
        _ptr(umap_local, ctypes.c_int64), ctypes.c_int64(umap_local.shape[0]),
        _ptr(mm_start, ctypes.c_int64), _ptr(mm_n, ctypes.c_int64),
        _ptr(mm_mate_umap, ctypes.c_int64), _ptr(mm_mate_mmap, ctypes.c_int64),
        _ptr(mm_active, ctypes.c_int64), ctypes.c_int64(mm_active.shape[0]),
        _ptr(bins, ctypes.c_int64), ctypes.c_int64(bins.shape[0]),
        ctypes.c_int64(lo), ctypes.c_int64(bin_size),
        _ptr(log_probs, ctypes.c_double), ctypes.c_int64(log_probs.shape[0]),
        ctypes.c_int64(iters), ctypes.c_double(tmax_log),
        ctypes.c_double(tmin_log), ctypes.c_int64(max_no_move),
        ctypes.c_double(score_scale),
        ctypes.c_int64(insert_min), ctypes.c_int64(insert_max),
        _ptr(seeds, ctypes.c_uint64), ctypes.c_int64(seeds.shape[0]),
        ctypes.c_int64(n_threads))
    return mm_active, bins


def smem_kmer_table(occ_blocks, counts, primary, fm_n, k=10):
    """Bi-intervals of every k-mer: int64 [4^k, 3] of (k, l, s).

    Built once per index (BFS backward extension, (4^k-4)/3 rank ops,
    ~20 ms and 24 MB at k=10) and passed to smem_seed_batch, whose
    round-3 restarts then jump their first k extensions in one lookup.
    """
    if k < 1:
        # the BFS starts from the 4 single bases, so it always writes
        # at least 4 rows: k = 0 would overrun a 4**0-row buffer
        raise ValueError(f"smem_kmer_table needs k >= 1, got {k}")
    occ_blocks = np.ascontiguousarray(occ_blocks, np.int32)
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((4 ** k, 3), np.int64)
    get_lib().smem_kmer_table(
        _ptr(occ_blocks, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        ctypes.c_int64(int(primary)), ctypes.c_int64(int(fm_n)),
        ctypes.c_int32(k), _ptr(out, ctypes.c_int64))
    return out


def smem_seed_batch(occ_blocks, counts, primary, fm_n, reads, lens,
                    min_seed_len=19, split_len=28, split_width=10,
                    max_mem_intv=20, max_seeds=64, n_threads=0,
                    kmer_tab=None):
    """SMEM seeding on host (BWA bwt_smem1 semantics; see ema_native.cpp).

    reads: uint8 [B, L] base codes; returns (s_lo, s_hi, s_qb, s_len,
    n_seeds) with per-read seed arrays [B, max_seeds] — the same layout
    as the device greedy seeder (index/fmindex.seed_reads).  kmer_tab
    (from smem_kmer_table) accelerates round 3; output is identical
    with or without it.
    """
    occ_blocks = np.ascontiguousarray(occ_blocks, np.int32)
    counts = np.ascontiguousarray(counts, np.int64)
    reads = np.ascontiguousarray(reads, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, L = reads.shape
    s_lo = np.zeros((B, max_seeds), np.int32)
    s_hi = np.zeros((B, max_seeds), np.int32)
    s_qb = np.zeros((B, max_seeds), np.int32)
    s_len = np.zeros((B, max_seeds), np.int32)
    n_seeds = np.zeros(B, np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    ktab_k = 0
    ktab_ptr = None
    if kmer_tab is not None:
        kmer_tab = np.ascontiguousarray(kmer_tab, np.int64)
        ktab_k = int(round(math.log(kmer_tab.shape[0], 4)))
        if 4 ** ktab_k != kmer_tab.shape[0]:
            raise ValueError("kmer_tab rows must be a power of 4")
        # the jump skips the emit checks of the first k extensions,
        # which is exact only while k <= min_seed_len (see ema_native)
        if ktab_k <= min_seed_len:
            ktab_ptr = _ptr(kmer_tab, ctypes.c_int64)
        else:
            ktab_k = 0
    get_lib().smem_seed_batch(
        _ptr(occ_blocks, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        ctypes.c_int64(int(primary)), ctypes.c_int64(int(fm_n)),
        _ptr(reads, ctypes.c_uint8), _ptr(lens, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int32(L),
        ctypes.c_int32(min_seed_len), ctypes.c_int32(split_len),
        ctypes.c_int32(split_width), ctypes.c_int32(max_mem_intv),
        ctypes.c_int32(max_seeds), ctypes.c_int32(n_threads),
        ktab_ptr, ctypes.c_int32(ktab_k),
        _ptr(s_lo, ctypes.c_int32), _ptr(s_hi, ctypes.c_int32),
        _ptr(s_qb, ctypes.c_int32), _ptr(s_len, ctypes.c_int32),
        _ptr(n_seeds, ctypes.c_int32))
    return s_lo, s_hi, s_qb, s_len, n_seeds


def greedy_seed_batch(occ_blocks, counts, primary, fm_n, reads, lens,
                      min_seed_len=19, max_seeds=16, n_threads=0):
    """Greedy maximal-suffix seeding on host (CPU-backend FM path).

    Value-identical to the device seeder (index/fmindex.seed_reads):
    same chop/restart/min-length/cap semantics, same output layout
    (s_lo, s_hi, s_qb, s_len [B, max_seeds] + n_seeds [B]).
    """
    occ_blocks = np.ascontiguousarray(occ_blocks, np.int32)
    counts = np.ascontiguousarray(counts, np.int64)
    reads = np.ascontiguousarray(reads, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, L = reads.shape
    s_lo = np.zeros((B, max_seeds), np.int32)
    s_hi = np.zeros((B, max_seeds), np.int32)
    s_qb = np.zeros((B, max_seeds), np.int32)
    s_len = np.zeros((B, max_seeds), np.int32)
    n_seeds = np.zeros(B, np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    get_lib().greedy_seed_batch(
        _ptr(occ_blocks, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        ctypes.c_int64(int(primary)), ctypes.c_int64(int(fm_n)),
        _ptr(reads, ctypes.c_uint8), _ptr(lens, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int32(L),
        ctypes.c_int32(min_seed_len), ctypes.c_int32(max_seeds),
        ctypes.c_int32(n_threads),
        _ptr(s_lo, ctypes.c_int32), _ptr(s_hi, ctypes.c_int32),
        _ptr(s_qb, ctypes.c_int32), _ptr(s_len, ctypes.c_int32),
        _ptr(n_seeds, ctypes.c_int32))
    return s_lo, s_hi, s_qb, s_len, n_seeds


def locate_batch(idx, rows, n_threads=0) -> np.ndarray:
    """Batched SA lookup on host: BWT rows -> text positions.

    ``idx``: a ReferenceIndex (or any object with occ_blocks/counts/
    primary/fm_n/sa_mark_words/sa_mark_rank/sa_values/sa_rate).  Matches
    index/fmindex.locate value-for-value (sampled-SA LF walk).
    """
    occ_blocks = np.ascontiguousarray(idx.occ_blocks, np.int32)
    counts = np.ascontiguousarray(idx.counts, np.int64)
    mark_words = np.ascontiguousarray(idx.sa_mark_words, np.uint32)
    mark_rank = np.ascontiguousarray(idx.sa_mark_rank, np.int32)
    sa_values = np.ascontiguousarray(idx.sa_values, np.int32)
    rows = np.ascontiguousarray(rows, np.int64)
    out = np.zeros(rows.shape[0], np.int64)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    get_lib().locate_batch(
        _ptr(occ_blocks, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        ctypes.c_int64(int(idx.primary)), ctypes.c_int64(int(idx.fm_n)),
        _ptr(mark_words, ctypes.c_uint32), _ptr(mark_rank, ctypes.c_int32),
        _ptr(sa_values, ctypes.c_int32), ctypes.c_int32(int(idx.sa_rate)),
        _ptr(rows, ctypes.c_int64), ctypes.c_int64(rows.shape[0]),
        ctypes.c_int32(n_threads), _ptr(out, ctypes.c_int64))
    return out


def sw_banded_native(oriented: np.ndarray, olens: np.ndarray,
                     text: np.ndarray, owners: np.ndarray,
                     win_lo: np.ndarray, win_len: np.ndarray,
                     w_band: int, match=1, mismatch=4, gap_open=6,
                     gap_extend=1, clip=5, n_threads=0,
                     force_scalar=False, wl=None):
    """Threaded host banded-SW scorer (see ema_native.cpp); same outputs
    and tie rules as ops/sw.sw_score_banded.  Windows are gathered from
    ``text`` directly (win_lo may be negative; out-of-text columns read
    as sentinel), so nothing crosses a device boundary."""
    oriented = np.ascontiguousarray(oriented, np.uint8)
    olens = np.ascontiguousarray(olens, np.int32)
    text = np.ascontiguousarray(text, np.uint8)
    owners = np.ascontiguousarray(owners, np.int64)
    win_lo = np.ascontiguousarray(win_lo, np.int64)
    win_len = np.ascontiguousarray(win_len, np.int32)
    N = owners.shape[0]
    score = np.empty(N, np.int32)
    qb = np.empty(N, np.int32)
    qe = np.empty(N, np.int32)
    ref_end = np.empty(N, np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    fn = (get_lib().sw_banded_native_scalar if force_scalar
          else get_lib().sw_banded_native)
    fn(
        _ptr(oriented, ctypes.c_uint8), ctypes.c_int64(oriented.shape[1]),
        _ptr(olens, ctypes.c_int32),
        _ptr(text, ctypes.c_uint8), ctypes.c_int64(text.shape[0]),
        _ptr(owners, ctypes.c_int64), _ptr(win_lo, ctypes.c_int64),
        _ptr(win_len, ctypes.c_int32),
        ctypes.c_int64(N), ctypes.c_int32(int(w_band)),
        ctypes.c_int32(match), ctypes.c_int32(mismatch),
        ctypes.c_int32(gap_open), ctypes.c_int32(gap_extend),
        ctypes.c_int32(clip),
        _ptr(score, ctypes.c_int32), _ptr(qb, ctypes.c_int32),
        _ptr(qe, ctypes.c_int32), _ptr(ref_end, ctypes.c_int32),
        ctypes.c_int32(n_threads),
        (None if wl is None
         else _ptr(np.ascontiguousarray(wl, np.int32), ctypes.c_int32)))
    return {"score": score, "qb": qb, "qe": qe, "ref_end": ref_end}


class BarcodeHash:
    """Open-addressing u32 -> f64 prior table (see ema_native.cpp
    bc_hash_build): one expected cache miss per probe vs ~22 for a
    binary search over a 4M-entry whitelist."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        n = int(keys.shape[0])
        S = 1
        while S < max(2 * n, 16):
            S *= 2
        self.S = S
        self.slots = np.zeros(S, np.uint32)
        self.svals = np.zeros(S, np.float64)
        keys = np.ascontiguousarray(keys, np.uint32)
        vals = np.ascontiguousarray(vals, np.float64)
        get_lib().bc_hash_build(
            _ptr(keys, ctypes.c_uint32), _ptr(vals, ctypes.c_double),
            ctypes.c_int64(n),
            _ptr(self.slots, ctypes.c_uint32),
            _ptr(self.svals, ctypes.c_double), ctypes.c_int64(S))

    def probe(self, bcs: np.ndarray, n_threads: int = 0) -> np.ndarray:
        """Per-key prior, or -1.0 for keys not in the table."""
        bcs = np.ascontiguousarray(bcs, np.uint32)
        out = np.empty(bcs.shape[0], np.float64)
        get_lib().bc_hash_probe(
            _ptr(bcs, ctypes.c_uint32), ctypes.c_int64(bcs.shape[0]),
            _ptr(self.slots, ctypes.c_uint32),
            _ptr(self.svals, ctypes.c_double), ctypes.c_int64(self.S),
            _ptr(out, ctypes.c_double),
            ctypes.c_int32(n_threads or _auto_threads()))
        return out

    def h1_scan(self, codes, quals, pos_ok, has_n, phred, n_threads=0):
        M = codes.shape[0]
        codes = np.ascontiguousarray(codes, np.uint8)
        quals = np.ascontiguousarray(quals, np.uint8)
        pos_ok = np.ascontiguousarray(pos_ok, np.uint8)
        has_n = np.ascontiguousarray(has_n, np.uint8)
        phred = np.ascontiguousarray(phred, np.float64)
        total = np.empty(M, np.float64)
        best_p = np.empty(M, np.float64)
        best_bc = np.empty(M, np.uint32)
        get_lib().bc_h1_scan(
            _ptr(codes, ctypes.c_uint8), _ptr(quals, ctypes.c_uint8),
            _ptr(pos_ok, ctypes.c_uint8), _ptr(has_n, ctypes.c_uint8),
            ctypes.c_int64(M),
            _ptr(self.slots, ctypes.c_uint32),
            _ptr(self.svals, ctypes.c_double), ctypes.c_int64(self.S),
            _ptr(phred, ctypes.c_double),
            _ptr(total, ctypes.c_double), _ptr(best_p, ctypes.c_double),
            _ptr(best_bc, ctypes.c_uint32),
            ctypes.c_int32(n_threads or _auto_threads()))
        return total, best_p, best_bc

    def h2_scan(self, codes, quals, phred, n_threads=0):
        M = codes.shape[0]
        codes = np.ascontiguousarray(codes, np.uint8)
        quals = np.ascontiguousarray(quals, np.uint8)
        phred = np.ascontiguousarray(phred, np.float64)
        total = np.empty(M, np.float64)
        best_p = np.empty(M, np.float64)
        best_bc = np.empty(M, np.uint32)
        get_lib().bc_h2_scan(
            _ptr(codes, ctypes.c_uint8), _ptr(quals, ctypes.c_uint8),
            ctypes.c_int64(M),
            _ptr(self.slots, ctypes.c_uint32),
            _ptr(self.svals, ctypes.c_double), ctypes.c_int64(self.S),
            _ptr(phred, ctypes.c_double),
            _ptr(total, ctypes.c_double), _ptr(best_p, ctypes.c_double),
            _ptr(best_bc, ctypes.c_uint32),
            ctypes.c_int32(n_threads or _auto_threads()))
        return total, best_p, best_bc


def _auto_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def cigar_stats_pool(pool: np.ndarray, off: np.ndarray, ln: np.ndarray):
    """One-pass CIGAR tallies (see ema_native.cpp): returns
    (m_bases, indel_bases, indel_runs, clip_bases, ref_len) int64 [B]."""
    pool = np.ascontiguousarray(pool.reshape(-1), np.uint32)
    off = np.ascontiguousarray(off, np.int64)
    ln = np.ascontiguousarray(ln, np.int32)
    B = off.shape[0]
    outs = [np.empty(B, np.int64) for _ in range(5)]
    get_lib().cigar_stats_pool(
        _ptr(pool, ctypes.c_uint32), _ptr(off, ctypes.c_int64),
        _ptr(ln, ctypes.c_int32), ctypes.c_int64(B),
        *[_ptr(o, ctypes.c_int64) for o in outs])
    return tuple(outs)


def bc_encode_block(data: np.ndarray, stride: int) -> np.ndarray:
    """Strided raw bytes -> preproc-encoded uint32 barcodes (first base in
    the high bits, hash_dna codes; count.cc:130).  ``data`` is a flat
    uint8 buffer of n rows of ``stride`` bytes, the first 16 of each row
    being the barcode bases."""
    data = np.ascontiguousarray(data, np.uint8)
    n = data.shape[0] // stride
    out = np.empty(n, np.uint32)
    get_lib().bc_encode_block(
        _ptr(data, ctypes.c_uint8), ctypes.c_int64(n),
        ctypes.c_int64(stride), _ptr(out, ctypes.c_uint32))
    return out


def umap_order_u32(keys: np.ndarray, sim: bool | None = None,
                   distinct: bool = False) -> np.ndarray:
    """Reference-compatible emission order (see ema_native.cpp).

    Replays the key insertion sequence through libstdc++'s hashtable
    mechanics and returns, in map-iteration order, the index of each
    distinct key's first occurrence — the order the reference uses for
    .ema-ncnt emission and bucket assignment (count.cc:160-170,
    correct.cc:407-412).  Default is the flat-array simulation
    (umap_order_u32_sim, several x faster, equality-tested vs the real
    map); EMA_TPU_UMAP_SIM=0 or sim=False forces the real
    std::unordered_map replay.  ``distinct=True`` (sim only) skips the
    duplicate probe when the caller pre-deduplicated keys.
    """
    if sim is None:
        sim = os.environ.get("EMA_TPU_UMAP_SIM", "1") != "0"
    keys = np.ascontiguousarray(keys, np.uint32)
    out = np.empty(keys.shape[0], np.int64)
    if sim:
        n = get_lib().umap_order_u32_sim(
            _ptr(keys, ctypes.c_uint32), ctypes.c_int64(keys.shape[0]),
            _ptr(out, ctypes.c_int64), ctypes.c_int32(int(distinct)))
        if n < 0:
            # Overflow guard in the sim (node indices are int32): fall back
            # to the real std::unordered_map replay rather than silently
            # truncating the output.
            n = get_lib().umap_order_u32(
                _ptr(keys, ctypes.c_uint32), ctypes.c_int64(keys.shape[0]),
                _ptr(out, ctypes.c_int64))
    else:
        n = get_lib().umap_order_u32(
            _ptr(keys, ctypes.c_uint32), ctypes.c_int64(keys.shape[0]),
            _ptr(out, ctypes.c_int64))
    if n < 0:
        raise ValueError(f"umap_order_u32: native call failed (n={n})")
    return out[:n]


def bwa_sa_import_locate(occ_blocks: np.ndarray, counts: np.ndarray,
                         primary: int, n2: int,
                         sa_start_vals: np.ndarray, sa_intv: int,
                         sa_rate: int):
    """Convert BWA's rank-sampled SA into our value-sampled locate
    structure: (sa_mark_words, sa_mark_rank, sa_values).

    ``sa_start_vals[k]`` is SA[k * sa_intv] over the full n2+1 row space
    (row 0 = $, value n2).  One segmented LF-cycle walk (n2+1 steps total;
    see ema_native.cpp) marks every row whose SA value is divisible by
    ``sa_rate`` and compacts the values in row order.
    """
    occ_blocks = np.ascontiguousarray(occ_blocks, np.int32)
    counts = np.ascontiguousarray(counts, np.int64)
    sa_start_vals = np.ascontiguousarray(sa_start_vals, np.int64)
    n_words = (n2 + 1 + 31) // 32
    words = np.empty(n_words, np.uint32)
    rank = np.empty(n_words, np.int32)
    values = np.empty(n2 // sa_rate + 2, np.int32)
    w = get_lib().bwa_sa_import_locate(
        _ptr(occ_blocks, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        ctypes.c_int32(primary), ctypes.c_int64(n2),
        _ptr(sa_start_vals, ctypes.c_int64),
        ctypes.c_int64(sa_start_vals.shape[0]),
        ctypes.c_int64(sa_intv), ctypes.c_int64(sa_rate),
        _ptr(words, ctypes.c_uint32), _ptr(rank, ctypes.c_int32),
        _ptr(values, ctypes.c_int32))
    if w != n2 // sa_rate + 1:
        raise ValueError(
            f"bwa_sa_import_locate: walked {w} sampled rows, expected "
            f"{n2 // sa_rate + 1} — corrupt .bwt/.sa?")
    return words, rank, values[:w]


def bucket_assign_pq(sizes: np.ndarray, n_buckets: int) -> np.ndarray:
    """Greedy (size, file-index) min-heap bucket assignment over sizes in
    emission order (reference correct.cc:389-412); returns file indices
    1..n_buckets per entry."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    out = np.empty(sizes.shape[0], np.int32)
    get_lib().bucket_assign_pq(
        _ptr(sizes, ctypes.c_int64), ctypes.c_int64(sizes.shape[0]),
        ctypes.c_int32(int(n_buckets)), _ptr(out, ctypes.c_int32))
    return out


def em_run_flat(cand_off, cloud, chrom, pos, rev, score, active,
                gammas, weights, mate_entry, comp, many, iters,
                insert_min, insert_max, unpaired_penalty):
    """Cloud-EM over flat candidate arrays (see ema_native.cpp em_run_flat).

    Mutates ``gammas`` (flat f64 [N]) and ``weights`` (f64 [n_clouds]) in
    place; returns gammas.
    """
    cand_off = np.ascontiguousarray(cand_off, np.int64)
    cloud = np.ascontiguousarray(cloud, np.int32)
    chrom = np.ascontiguousarray(chrom, np.int32)
    pos = np.ascontiguousarray(pos, np.int64)
    rev = np.ascontiguousarray(rev, np.int8)
    score = np.ascontiguousarray(score, np.float64)
    active = np.ascontiguousarray(active, np.uint8)
    gammas = np.ascontiguousarray(gammas, np.float64)
    weights = np.ascontiguousarray(weights, np.float64)
    mate_entry = np.ascontiguousarray(mate_entry, np.int64)
    comp = np.ascontiguousarray(comp, np.int64)
    get_lib().em_run_flat(
        ctypes.c_int64(cand_off.shape[0] - 1),
        _ptr(cand_off, ctypes.c_int64),
        _ptr(cloud, ctypes.c_int32), _ptr(chrom, ctypes.c_int32),
        _ptr(pos, ctypes.c_int64), _ptr(rev, ctypes.c_int8),
        _ptr(score, ctypes.c_double), _ptr(active, ctypes.c_uint8),
        _ptr(gammas, ctypes.c_double), _ptr(weights, ctypes.c_double),
        _ptr(mate_entry, ctypes.c_int64),
        ctypes.c_int64(weights.shape[0]), _ptr(comp, ctypes.c_int64),
        ctypes.c_int32(1 if many else 0), ctypes.c_int32(iters),
        ctypes.c_int64(insert_min), ctypes.c_int64(insert_max),
        ctypes.c_double(unpaired_penalty))
    return gammas, weights
