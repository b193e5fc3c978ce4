"""ThreadSanitizer pass over the thread pools of the port's native library
(ema_tpu_torch/native/ema_native.cpp), the port's counterpart of
tests/test_native_tsan.py.

``EMA_TPU_NATIVE_SANITIZE=thread`` builds the library with
-fsanitize=thread into a file of its own; the drive script runs in a
subprocess with libtsan preloaded and calls every entry point that starts
threads, with 4 threads and inputs past each one's threading threshold:
traceback_batch, sa_optimize_best, smem_seed_batch, greedy_seed_batch,
locate_batch, sw_banded_native_scalar, sw_banded_native_simd (the AVX-512
form, where the host has it), bc_hash_probe, bc_h1_scan and bc_h2_scan;
then seeding, locate and SW from two Python threads at once, as the
Aligner's chunk workers call them.  A data race makes TSan print
"WARNING: ThreadSanitizer" and, with halt_on_error, exit 66.  The script
imports only ema_tpu_torch.native and ema_tpu_torch.index.build and
asserts that neither torch nor jax is loaded: TSan would drown in their
runtime threads, and the subject here is the library's own pools.

Skips only where libtsan is not installed.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from ema_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = r"""
import os, sys, threading
sys.path.insert(0, "@REPO@")
import numpy as np
from ema_tpu_torch import native
from ema_tpu_torch.index import build

NT = 4
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "ema_tpu"))
assert not loaded, loaded
assert "-fsanitize=thread" in native.gxx_flags()

rng = np.random.default_rng(0)
text = rng.integers(0, 4, 60_000).astype(np.uint8)
idx = build.build_index({"c1": text}, sa_rate=4)
assert native._lib_path == native._so_path(), native._lib_path

# reads of 60..100 bases from the text, 1% substituted, some N
B, m = 512, 100
starts = rng.integers(0, text.shape[0] - m, B)
reads = np.stack([text[s:s + m] for s in starts]).astype(np.uint8)
mut = rng.random((B, m)) < 0.01
reads = np.where(mut, rng.integers(0, 5, reads.shape), reads).astype(np.uint8)
lens = rng.integers(60, m + 1, B).astype(np.int32)
fm = (idx.occ_blocks, idx.counts, idx.primary, idx.fm_n)


def seed_locate_sw(rows_of, n_threads):
    # greedy seeding (B >= 64), locate of 1,024+ rows, SW (N >= 128)
    r, ln, st = reads[rows_of], lens[rows_of], starts[rows_of]
    g = native.greedy_seed_batch(*fm, r, ln, n_threads=n_threads)
    rows = np.asarray(g[0][:64], np.int64).reshape(-1) % idx.fm_n
    loc = native.locate_batch(idx, rows, n_threads=n_threads)
    owners = np.arange(r.shape[0], dtype=np.int64)
    win_lo = (st - 16).astype(np.int64)
    win_len = np.full(r.shape[0], m + 48, np.int32)
    sw = native.sw_banded_native(r, ln, idx.text, owners, win_lo, win_len,
                                 64, n_threads=n_threads)
    return [*g, loc, *sw.values()]


# 1-5: seeding (both seeders), locate, the SIMD and the scalar SW
out = seed_locate_sw(slice(None), NT)
s = native.smem_seed_batch(*fm, reads, lens, n_threads=NT)
assert (s[4] > 0).mean() > 0.9 and (out[4] > 0).mean() > 0.9
owners = np.arange(B, dtype=np.int64)
win_lo = (starts - 16).astype(np.int64)
win_len = np.full(B, m + 48, np.int32)
simd = native.sw_banded_native(reads, lens, idx.text, owners, win_lo,
                               win_len, 64, n_threads=NT)
scalar = native.sw_banded_native(reads, lens, idx.text, owners, win_lo,
                                 win_len, 64, n_threads=NT,
                                 force_scalar=True)
for k in simd:
    assert np.array_equal(simd[k], scalar[k]), k
assert (simd["score"] > 0).mean() > 0.9

# 6: traceback (B >= 2)
tb = native.traceback_batch(reads, lens, owners, idx.text, win_lo,
                            win_len, simd, n_threads=NT)
assert (tb["n_cigar"] > 0).mean() > 0.9

# 7: annealing chains (4 chains on 4 threads): 3 multimapped reads of 3
# candidates each, one with a unique mate, two mates of each other
pos = np.array([1000, 5000, 9000, 1200, 5200, 9300, 1400, 5100, 9100,
                1300, 20000], np.int64)
rev = np.array([0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0], np.int8)
lo, bin_size = 0, 1000
bins = np.bincount((pos - lo) // bin_size, minlength=21).astype(np.int64)
active, bins_out = native.sa_optimize_best(
    pos=pos, chrom=np.zeros(11, np.int32), rev=rev,
    score=rng.random(11) * 10, umap_local=np.array([9, 10], np.int64),
    mm_start=np.array([0, 3, 6], np.int64),
    mm_n=np.array([3, 3, 3], np.int64),
    mm_mate_umap=np.array([0, -1, -1], np.int64),
    mm_mate_mmap=np.array([-1, 2, 1], np.int64),
    mm_active=np.array([1, 2, 0], np.int64), bins=bins, lo=lo,
    bin_size=bin_size, log_probs=np.log(np.linspace(0.6, 0.01, 16)),
    iters=2000, tmax_log=2.0, tmin_log=-2.0, max_no_move=500,
    score_scale=1.0, insert_min=0, insert_max=1000,
    seeds=np.arange(1, 5, dtype=np.uint64), n_threads=NT)
assert active.min() >= 0 and active.max() < 3
assert bins_out.sum() == pos.shape[0]

# 8-10: the barcode hash: probe (m >= 65,536), H1 and H2 scans (M >= 256)
keys = np.unique(rng.integers(1, 1 << 32, 5000, dtype=np.uint64))
keys = keys.astype(np.uint32)
vals = rng.random(keys.shape[0]) + 0.1
bh = native.BarcodeHash(keys, vals)
bcs = np.concatenate([keys, rng.integers(1, 1 << 32, 70_000 - keys.shape[0],
                                         dtype=np.uint64).astype(np.uint32)])
pv = bh.probe(bcs, n_threads=NT)
assert np.array_equal(pv[:keys.shape[0]], vals)
shifts = 2 * np.arange(15, -1, -1, dtype=np.uint32)
codes = ((keys[:, None] >> shifts[None, :]) & 3).astype(np.uint8)
phred = 10.0 ** (-np.arange(128) / 10.0)
M1 = 512
c1 = codes[:M1].copy()
c1[np.arange(M1), rng.integers(0, 16, M1)] += 1
c1 %= 4
q1 = rng.integers(2, 41, c1.shape).astype(np.uint8)
tot, best_p, best_bc = bh.h1_scan(c1, q1, np.ones_like(c1),
                                  np.zeros(M1, np.uint8), phred, n_threads=NT)
assert (best_bc == keys[:M1]).mean() > 0.9
M2 = 300
tot2, best_p2, _ = bh.h2_scan(codes[:M2], q1[:M2], phred, n_threads=NT)
assert np.isfinite(tot2).all()

# seeding, locate and SW from two Python threads at once, each with its
# own pool: the chunk workers' pattern; each must give the serial result
halves = (slice(0, B // 2), slice(B // 2, B))
want = [seed_locate_sw(h, 1) for h in halves]
got = [None, None]


def work(k):
    got[k] = seed_locate_sw(halves[k], NT)


threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
for t in threads:
    t.start()
for t in threads:
    t.join()
for w, o in zip(want, got):
    assert o is not None and len(o) == len(w)
    for a, b in zip(w, o):
        assert np.array_equal(a, b)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax"))
assert not loaded, loaded
print("TSAN-DRIVE-OK")
"""


def _libtsan():
    for p in ("/usr/lib/x86_64-linux-gnu/libtsan.so.2",
              "/usr/lib/x86_64-linux-gnu/libtsan.so.0",
              "/usr/lib/gcc/x86_64-linux-gnu/12/libtsan.so"):
        if os.path.exists(p):
            return p
    import ctypes.util
    return ctypes.util.find_library("tsan")


def _build_sanitized(monkeypatch, mode="thread"):
    """The instrumented library's path, built here (without the
    sanitizer's runtime: g++ need not run under it) and never loaded."""
    monkeypatch.setenv("EMA_TPU_NATIVE_SANITIZE", mode)
    so = native._so_path()
    if not so.exists():
        native._build(so)
    monkeypatch.delenv("EMA_TPU_NATIVE_SANITIZE")
    return so


def test_sanitize_mode_builds_its_own_library(monkeypatch):
    """Each mode names its own file under build/ema_tpu_torch/, building
    one leaves the fast library as it was, and an unknown mode raises."""
    monkeypatch.delenv("EMA_TPU_NATIVE_SANITIZE", raising=False)
    native.get_lib()
    fast = native._so_path()
    assert native.gxx_flags() == native.GXX_FLAGS
    before = fast.read_bytes()
    paths = {}
    for mode in native.SANITIZE_MODES:
        monkeypatch.setenv("EMA_TPU_NATIVE_SANITIZE", mode)
        flags = native.gxx_flags()
        assert flags[:len(native.GXX_FLAGS)] == native.GXX_FLAGS
        assert flags[len(native.GXX_FLAGS):] == (
            f"-fsanitize={mode}", "-g", "-fno-omit-frame-pointer")
        paths[mode] = native._so_path()
    assert len({fast, *paths.values()}) == 1 + len(native.SANITIZE_MODES)
    assert all(p.parent == native.BUILD_DIR for p in paths.values())
    so = _build_sanitized(monkeypatch)
    assert so == paths["thread"] and so.exists()
    assert fast.read_bytes() == before
    assert native._lib_path == fast
    monkeypatch.setenv("EMA_TPU_NATIVE_SANITIZE", "")
    assert native._so_path() == fast
    for bad in ("memory", "undefined", "Thread", "1"):
        monkeypatch.setenv("EMA_TPU_NATIVE_SANITIZE", bad)
        with pytest.raises(ValueError, match="EMA_TPU_NATIVE_SANITIZE"):
            native._so_path()


def test_thread_pools_race_free(tmp_path, monkeypatch):
    tsan = _libtsan()
    if tsan is None:
        pytest.skip("libtsan not installed")
    _build_sanitized(monkeypatch)
    drv = tmp_path / "drive.py"
    drv.write_text(DRIVER.replace("@REPO@", REPO))
    env = dict(os.environ,
               LD_PRELOAD=tsan,
               TSAN_OPTIONS="halt_on_error=1 exitcode=66",
               EMA_TPU_NATIVE_SANITIZE="thread")
    env.pop("EMA_TPU_SW_NATIVE_SCALAR", None)
    r = subprocess.run([sys.executable, str(drv)], env=env,
                       capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert "WARNING: ThreadSanitizer" not in out, out[-6000:]
    assert r.returncode == 0, out[-6000:]
    assert "TSAN-DRIVE-OK" in out
