"""`preproc` stage: barcode correction + bucketing (reference: cpp/correct.cc).

Four phases, mirroring correct.cc:271-633:
  1. load the whitelist and all `.ema-ncnt` priors (+1 pseudocount),
  2. stream `.ema-fcnt` blocks and correct each distinct fused key —
     exact hit (optionally refined by Hamming-2 search) or Hamming-1 /
     N-position search, accepting when the posterior share clears
     BC_CONF_THRESH = 0.975,
  3. greedy min-heap assignment of barcodes to buckets,
  4. re-stream the FASTQ, route each pair to its barcode's bucket in the
     special EMA-FASTQ one-line format (or BX-tagged FASTQ), barcode+7bp
     trimmed from read 1; uncorrectable pairs go to `ema-nobc`.

The reference fans the per-key correction across std::threads
(correct.cc:244-261); here the whole block is *vectorized*: all H1
neighborhoods are materialized as one [K, 48] array of barcode candidates
and resolved with a single searchsorted — no threads needed.
"""

from __future__ import annotations

import heapq
import os
import re
import struct
from typing import Dict, List

import numpy as np

from ema_tpu_torch import config
from ema_tpu_torch.preproc.count import (
    BC_LEN, QUAL_BASE, HASH_DNA, decode_bc_preproc_str,
    iter_fastq_pairs, load_whitelist_preproc, lookup_sorted, read_ncnt,
    read_fcnt_blocks, fused_keys_and_barcodes)

QO = config.ILLUMINA_QUAL_OFFSET

_PHRED = 10.0 ** (-np.minimum(np.arange(128), QUAL_BASE - 1) / 10.0)


_SHORT_RE = re.compile(rb"[^ \t\n\x0b\x0c\r]*")


def _short(name: bytes) -> bytes:
    """Name truncated at the first whitespace char, like the reference's
    per-char isspace break (correct.cc:517-520) — unlike bytes.split(),
    a leading-whitespace name truncates to empty."""
    return _SHORT_RE.match(name).group()


def _keys_decompose(keys: np.ndarray):
    """[K, 16] fused keys -> (base codes [K,16] with 4=N, quals [K,16])."""
    n = keys // QUAL_BASE
    q = keys % QUAL_BASE
    return n.astype(np.int64), q.astype(np.int64)


def _encode_from_codes(codes: np.ndarray) -> np.ndarray:
    """[..., 16] base codes (N->0) -> uint32 preproc encoding."""
    c = np.where(codes == 4, 0, codes).astype(np.uint64)
    shifts = (2 * np.arange(BC_LEN - 1, -1, -1, dtype=np.uint64))
    return np.sum(c << shifts, axis=-1, dtype=np.uint64).astype(np.uint32)


class Corrector:
    """Vectorized fused-key barcode correction (correct.cc:66-188)."""

    def __init__(self, wl: np.ndarray, priors: np.ndarray, do_h2: bool):
        import os
        import threading
        self.wl = wl
        self.priors = priors
        self.do_h2 = do_h2
        self.stats = {"nochange": 0, "h1": 0, "h2": 0, "nobucket": 0}
        self._stats_lock = threading.Lock()
        # native hash-probe neighbor scans (ema_native.cpp bc_h1_scan/
        # bc_h2_scan): same enumeration order and tie rules as the numpy
        # path below, ~2 orders of magnitude faster on big whitelists;
        # tests cross-check both paths (EMA_TPU_NO_NATIVE_CORRECT=1
        # forces numpy)
        self._hash = None
        if os.environ.get("EMA_TPU_NO_NATIVE_CORRECT", "").lower() \
                not in ("1", "true", "yes"):
            try:
                from ema_tpu_torch import native
                self._hash = native.BarcodeHash(wl, priors)
            except Exception:       # pragma: no cover - build failure
                self._hash = None

    def _lookup(self, bcs: np.ndarray):
        return lookup_sorted(self.wl, bcs)

    def correct_block(self, keys: np.ndarray, counts: np.ndarray):
        """Returns per-key corrected barcode (0 = uncorrectable) and type."""
        K = keys.shape[0]
        codes, quals = _keys_decompose(keys)
        n_ns = (codes == 4).sum(axis=1)
        bc = _encode_from_codes(codes)

        out_bc = np.zeros(K, np.uint32)
        out_type = np.full(K, 3, np.int8)   # NOBUCKET

        if self._hash is not None:
            pv = self._hash.probe(bc.astype(np.uint32))
            exact_hit = pv >= 0
            exact_prior = np.where(exact_hit, pv, 0.0)
        else:
            exact_idx, exact_hit = self._lookup(bc)
            exact_prior = self.priors[exact_idx]
        is_exact = exact_hit & (n_ns == 0)

        max_p = np.where(is_exact, exact_prior, -1.0)
        max_bc = np.where(is_exact, bc, 0).astype(np.uint32)
        total = np.where(is_exact, np.maximum(max_p, 0.0), 0.0)
        out_type[is_exact] = 0              # NOCHANGE so far

        # --- H1 / N-position search for misses (ns <= 1) ----------------
        miss = ~is_exact & (n_ns <= 1)
        if miss.any():
            mi = np.nonzero(miss)[0]
            m_codes = codes[mi]
            m_quals = quals[mi]
            has_n = n_ns[mi] == 1
            # candidate positions: all 16 when ns==0; only the N when ns==1
            pos_ok = np.where(has_n[:, None], m_codes == 4,
                              np.ones_like(m_codes, bool))
            # for each position i and substitute j in 0..3
            if self._hash is not None:
                tot_m, best_p, best_bc = self._hash.h1_scan(
                    m_codes, m_quals, pos_ok, has_n, _PHRED)
                best_valid = best_p > 0
            else:
                nb_bc, nb_p, nb_valid = self._h1_neighbors(
                    m_codes, m_quals, pos_ok, has_n)
                tot_m, best_p, best_bc, best_valid = _reduce_neighbors(
                    nb_bc, nb_p, nb_valid)
            total[mi] += tot_m
            better = best_valid & (best_p > max_p[mi])
            max_p[mi] = np.where(better, best_p, max_p[mi])
            max_bc[mi] = np.where(better, best_bc, max_bc[mi])
            t = out_type[mi]
            t[better] = 1                   # H1CHANGE
            out_type[mi] = t

        # --- H2 refinement for exact hits --------------------------------
        if self.do_h2 and is_exact.any():
            ei = np.nonzero(is_exact)[0]
            if self._hash is not None:
                tot_m, best_p, best_bc = self._hash.h2_scan(
                    codes[ei], quals[ei], _PHRED)
                best_valid = best_p > 0
                total[ei] += tot_m
                better = best_valid & (best_p > max_p[ei])
                max_p[ei] = np.where(better, best_p, max_p[ei])
                max_bc[ei] = np.where(better, best_bc, max_bc[ei])
                t = out_type[ei]
                t[better] = 2               # H2CHANGE
                out_type[ei] = t
            else:
                # chunk to bound the [E, 1080] neighbor blowup
                for s in range(0, ei.shape[0], 4096):
                    sub = ei[s:s + 4096]
                    nb_bc, nb_p, nb_valid = self._h2_neighbors(
                        codes[sub], quals[sub])
                    tot_m, best_p, best_bc, best_valid = _reduce_neighbors(
                        nb_bc, nb_p, nb_valid)
                    total[sub] += tot_m
                    better = best_valid & (best_p > max_p[sub])
                    max_p[sub] = np.where(better, best_p, max_p[sub])
                    max_bc[sub] = np.where(better, best_bc, max_bc[sub])
                    t = out_type[sub]
                    t[better] = 2               # H2CHANGE
                    out_type[sub] = t

        # --- acceptance (correct.cc:157-164) -----------------------------
        with np.errstate(divide="ignore", invalid="ignore"):
            share = np.where(total > 0, max_p / np.where(total > 0, total, 1.0), 0.0)
        accept = (share > config.BC_CONF_THRESH) & (max_p > 0)
        out_bc = np.where(accept, max_bc, 0).astype(np.uint32)
        out_type = np.where(accept, out_type, 3).astype(np.int8)

        with self._stats_lock:
            for t, name in ((0, "nochange"), (1, "h1"), (2, "h2"),
                            (3, "nobucket")):
                self.stats[name] += int(counts[out_type == t].sum())
        return out_bc, out_type

    def _h1_neighbors(self, codes, quals, pos_ok, has_n):
        """All Hamming-1 (or N-substitution) neighbors: [M, 16*4] arrays."""
        M = codes.shape[0]
        # u32 throughout: codes pack into 32 bits, and u64 intermediates
        # would double the [M, 64] broadcast traffic
        base = _encode_from_codes(codes)
        i = np.arange(BC_LEN)
        shift = (2 * (BC_LEN - 1 - i)).astype(np.uint32)
        cleared = (base[:, None] & ~(np.uint32(3) << shift)[None, :])
        j = np.arange(4, dtype=np.uint32)
        nb = (cleared[:, :, None] | (j[None, None, :] << shift[None, :, None]))
        nb = np.ascontiguousarray(nb.reshape(M, BC_LEN * 4))

        same = (codes[:, :, None] == j[None, None, :].astype(codes.dtype))
        # ns==0: skip j == current base; ns==1: only the N position, all j
        valid = pos_ok[:, :, None] & (has_n[:, None, None] | ~same)
        valid = valid.reshape(M, BC_LEN * 4)

        idx, found = self._lookup(nb.reshape(-1))
        p = np.where(found, self.priors[idx], 0.0).reshape(M, BC_LEN * 4)
        qq = np.repeat(quals[:, :, None], 4, axis=2).reshape(M, BC_LEN * 4)
        p = p * _PHRED[np.clip(qq, 0, 127)]
        return nb, p, valid & (p > 0)

    def _h2_neighbors(self, codes, quals):
        """All Hamming-2 neighbors for exact hits (correct.cc:107-132)."""
        M = codes.shape[0]
        pairs = [(i1, i2) for i1 in range(BC_LEN) for i2 in range(i1 + 1, BC_LEN)]
        P = len(pairs)
        i1 = np.array([p[0] for p in pairs])
        i2 = np.array([p[1] for p in pairs])
        base = _encode_from_codes(codes)
        sh1 = (2 * (BC_LEN - 1 - i1)).astype(np.uint32)
        sh2 = (2 * (BC_LEN - 1 - i2)).astype(np.uint32)
        cleared = (base[:, None]
                   & ~(np.uint32(3) << sh1)[None, :]
                   & ~(np.uint32(3) << sh2)[None, :])
        j1 = np.arange(4, dtype=np.uint32)[None, None, :, None]
        j2 = np.arange(4, dtype=np.uint32)[None, None, None, :]
        nb = (cleared[:, :, None, None]
              | (j1 << sh1[None, :, None, None])
              | (j2 << sh2[None, :, None, None]))
        nb = np.ascontiguousarray(nb.reshape(M, P * 16))

        c1 = codes[:, i1]
        c2 = codes[:, i2]
        valid = ((c1[:, :, None, None] != j1.astype(c1.dtype))
                 & (c2[:, :, None, None] != j2.astype(c2.dtype)))
        valid = np.broadcast_to(valid, (M, P, 4, 4)).reshape(M, P * 16)

        idx, found = self._lookup(nb.reshape(-1))
        p = np.where(found, self.priors[idx], 0.0).reshape(M, P * 16)
        # quality weighting with the reference's odd clamp:
        # p_i = phred(max(3, q_i - 1))  (correct.cc:121-122)
        q1 = np.maximum(quals[:, i1] - 1, 3)
        q2 = np.maximum(quals[:, i2] - 1, 3)
        w = (_PHRED[np.clip(q1, 0, 127)] * _PHRED[np.clip(q2, 0, 127)])
        w = np.repeat(w[:, :, None], 16, axis=2).reshape(M, P * 16)
        p = p * w
        return nb, p, valid & (p > 0)


def _reduce_neighbors(nb_bc, nb_p, nb_valid):
    p = np.where(nb_valid, nb_p, 0.0)
    tot = p.sum(axis=1)
    best = np.argmax(p, axis=1)
    rows = np.arange(p.shape[0])
    best_p = p[rows, best]
    best_bc = nb_bc[rows, best]
    return tot, best_p, best_bc, best_p > 0


def correct(whitelist_path: str, input_prefixes: List[str], output_dir: str,
            stream, do_h2: bool = False, do_bx_format: bool = False,
            n_buckets: int = config.DEFAULT_N_BUCKETS,
            is_haplotag: bool = False, n_threads: int = 1,
            distributed: bool = False) -> dict:
    """Run the full preproc stage; returns stats.

    ``n_threads`` > 1 corrects fcnt blocks in a thread pool (the numpy
    neighbor math releases the GIL) — the analog of the reference's
    std::thread chunks (correct.cc:244-261); merging stays sequential.

    ``distributed``: multi-host mode (one process per host, each given
    only its LOCAL count outputs and FASTQ chunk).  Whitelist priors and
    per-barcode read totals are summed across the processes
    (parallel/distrib.allreduce_counts, over gloo), so the H1/H2 decisions
    and the greedy bucket assignment are globally identical: every host
    routes a given barcode to the same bucket index, and per-host bucket
    files concatenate into the exact logical buckets a single-process run
    produces.  This replaces the reference's single-host preproc reading
    every .ema-ncnt from disk (correct.cc:288-337; SURVEY §5.8 (i)).
    """
    os.makedirs(output_dir, exist_ok=True)
    if is_haplotag:
        # haplotag: no whitelist / no correction — barcodes come from
        # BX:Z: header tags (correct.cc:291, 321-342, 437-451)
        return _correct_haplotag(input_prefixes, output_dir, stream,
                                 do_bx_format, n_buckets)

    # 1. whitelist + priors
    from ema_tpu_torch import native
    from ema_tpu_torch.preproc.count import load_whitelist_file_order
    wl_file = load_whitelist_file_order(whitelist_path)
    sort_idx = np.argsort(wl_file, kind="stable")
    wl = wl_file[sort_idx]
    prior_counts = np.zeros(wl.shape[0], np.float64)
    for prefix in input_prefixes:
        bcs, cnts = read_ncnt(prefix if prefix.endswith(".ema-ncnt")
                              else prefix + ".ema-ncnt")
        idxc, hit = lookup_sorted(wl, bcs)
        np.add.at(prior_counts, idxc[hit], cnts[hit])
    if distributed:
        from ema_tpu_torch.parallel.distrib import allreduce_counts
        prior_counts = allreduce_counts(prior_counts)
    total_counts = (prior_counts + 1.0).sum()
    priors = (prior_counts + 1.0) / total_counts

    # 2. correct fused keys
    corrector = Corrector(wl, priors, do_h2)
    corrected: Dict[bytes, int] = {}
    n_reads_per_bc = np.zeros(wl.shape[0], np.int64)

    def all_blocks():
        for prefix in input_prefixes:
            fpath = (prefix[:-9] + ".ema-fcnt"
                     if prefix.endswith(".ema-ncnt")
                     else prefix + ".ema-fcnt")
            yield from read_fcnt_blocks(fpath)

    def split_chunks(blocks, chunk=65536):
        # sub-chunk large blocks so threads have work to share
        for keys, counts in blocks:
            for s in range(0, keys.shape[0], chunk):
                yield keys[s:s + chunk], counts[s:s + chunk]

    def run_one(kc):
        keys, counts = kc
        out_bc, out_type = corrector.correct_block(keys, counts)
        return keys, counts, out_bc, out_type

    def merge(keys, counts, out_bc, out_type):
        ok = out_bc != 0
        idx, found = corrector._lookup(out_bc[ok].astype(np.uint32))
        np.add.at(n_reads_per_bc, idx[found], counts[ok][found])
        changed = ok & ((out_type == 1) | (out_type == 2))
        for k, b in zip(keys[changed], out_bc[changed]):
            corrected[k.tobytes()] = int(b)

    if n_threads > 1:
        # bounded submission window: Executor.map would consume the whole
        # block iterator up front, holding every fcnt block in memory
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            futs = deque()
            it = split_chunks(all_blocks())
            for kc in it:
                futs.append(ex.submit(run_one, kc))
                if len(futs) >= 2 * n_threads:
                    merge(*futs.popleft().result())
            while futs:
                merge(*futs.popleft().result())
    else:
        for kc in all_blocks():
            merge(*run_one(kc))

    if distributed:
        from ema_tpu_torch.parallel.distrib import allreduce_counts
        n_reads_per_bc = allreduce_counts(n_reads_per_bc)

    # 3. greedy bucket assignment (correct.cc:389-412): every whitelist
    # barcode, visited in the reference's map-iteration order over the
    # whitelist insertion sequence, goes to the currently smallest bucket
    sizes_file = np.zeros_like(n_reads_per_bc)
    sizes_file[sort_idx] = n_reads_per_bc
    from ema_tpu_torch.preproc.count import umap_order_cached
    order = umap_order_cached(wl_file)
    assigned = native.bucket_assign_pq(sizes_file[order], n_buckets)
    bucket_file = np.zeros(wl_file.shape[0], np.int64)
    bucket_file[order] = assigned
    bucket_of = bucket_file[sort_idx]       # indexed by sorted-wl position

    # 4. re-stream FASTQ into buckets, vectorized in chunks: barcode
    # extraction / corrected-key lookup / whitelist routing run as batch
    # array ops; only the final byte-assembly per pair stays scalar
    files = [open(os.path.join(output_dir, "ema-nobc"), "wb")]
    for i in range(n_buckets):
        files.append(open(os.path.join(output_dir, f"ema-bin-{i:03d}"), "wb"))

    # corrected keys as a sorted composite-u64 table for batched lookup
    key_dt = np.dtype([("a", "<u8"), ("b", "<u8")])
    if corrected:
        ck = np.frombuffer(b"".join(corrected.keys()),
                           np.uint8).reshape(-1, 16).copy()
        ckv = ck.view(key_dt).ravel()
        cvals = np.fromiter(corrected.values(), np.uint32, len(corrected))
        corder = np.argsort(ckv)
        ckv, cvals = ckv[corder], cvals[corder]
    else:
        ckv = np.zeros(0, key_dt)
        cvals = np.zeros(0, np.uint32)

    trim = BC_LEN + config.MATE1_TRIM
    n_routed = 0
    n_dropped = 0
    CHUNK = 8192

    def flush(pairs):
        nonlocal n_routed, n_dropped
        usable = [p for p in pairs if len(p[1]) >= config.MIN_READ_SIZE]
        n_dropped += len(pairs) - len(usable)
        if not usable:
            return
        seqs = np.frombuffer(b"".join(p[1][:BC_LEN] for p in usable),
                             np.uint8).reshape(-1, BC_LEN)
        quals = np.frombuffer(b"".join(p[3][:BC_LEN] for p in usable),
                              np.uint8).reshape(-1, BC_LEN)
        ok, has_n, bc, key = fused_keys_and_barcodes(seqs, quals)
        kv = np.ascontiguousarray(key).view(key_dt).ravel()
        if ckv.shape[0]:
            ci = np.searchsorted(ckv, kv)
            cic = np.clip(ci, 0, ckv.shape[0] - 1)
            chit = (ci < ckv.shape[0]) & (ckv[cic] == kv)
            bc = np.where(chit, cvals[cic], bc)
            has_n = has_n & ~chit
        # NB: exact-whitelist keys that the corrector REJECTED (H2 share
        # <= 0.975, counted as nobucket) still route to the raw barcode's
        # bucket here — this matches the reference, whose phase 4 looks the
        # raw barcode up in known_counts regardless of the phase-2 verdict
        # (correct.cc:486-492: only H1/H2 *changes* enter corrected_counts)
        idxc, hit = lookup_sorted(wl, bc.astype(np.uint32))
        fidx = np.where(ok & ~has_n & hit, bucket_of[idxc], 0)
        n_dropped += int((~ok).sum())

        for k, p in enumerate(usable):
            if not ok[k]:
                continue   # sub-'!' barcode quals: dropped (correct.cc:473)
            name1, r1, q1 = p[0], p[1], p[3]
            name2, r2, q2 = p[4], p[5], p[7]
            fi = int(fidx[k])
            f = files[fi]
            short1 = _short(name1)
            short2 = _short(name2)
            if fi and not do_bx_format:
                bcs = decode_bc_preproc_str(int(bc[k])).encode()
                f.write(bcs + b" " + short1 + b" " + r1[trim:] + b" "
                        + q1[trim:] + b" " + r2 + b" " + q2 + b"\n")
            elif fi and do_bx_format:
                bcs = decode_bc_preproc_str(int(bc[k])).encode()
                f.write(short1 + b" BX:Z:" + bcs + b"-1\n" + r1[trim:]
                        + b"\n+\n" + q1[trim:] + b"\n")
                f.write(short2 + b" BX:Z:" + bcs + b"-1\n" + r2
                        + b"\n+\n" + q2 + b"\n")
            elif do_bx_format:
                # nobc under -b: read 1 header is plain but read 2 gets a
                # bare " BX:Z:-1" — the reference prints the BX prefix and
                # "-1" suffix unconditionally and PRINT_BCD emits nothing
                # for barcode 0 (correct.cc:580-590)
                f.write(short1 + b"\n" + r1[trim:] + b"\n+\n"
                        + q1[trim:] + b"\n")
                f.write(short2 + b" BX:Z:-1\n" + r2 + b"\n+\n" + q2 + b"\n")
            else:
                f.write(short1 + b"\n" + r1[trim:] + b"\n+\n"
                        + q1[trim:] + b"\n")
                f.write(short2 + b"\n" + r2 + b"\n+\n" + q2 + b"\n")
            n_routed += 1

    pend: List[List[bytes]] = []
    for pair in iter_fastq_pairs(stream):
        pend.append(pair)
        if len(pend) >= CHUNK:
            flush(pend)
            pend = []
    flush(pend)

    for f in files:
        f.close()
    stats = dict(corrector.stats)
    stats["routed_pairs"] = n_routed
    stats["dropped_pairs"] = n_dropped
    return stats


def _correct_haplotag(input_prefixes: List[str], output_dir: str, stream,
                      do_bx_format: bool, n_buckets: int) -> dict:
    """Haplotag preproc: bucket by the BX:Z:AxxCxxBxxDxx header code.

    No correction phase (the reference skips phase 2 for haplotag,
    correct.cc:342).  Bucket assignment covers the FULL generated 96^4
    code space in the reference's map-iteration order (common.h:72,
    correct.cc:407-412), so unseen-but-valid codes get deterministic,
    reference-identical buckets.  Read 1 is NOT barcode-trimmed
    (correct.cc:543-551); bucket lines carry the 12-char haplotag code
    from the header (correct.cc:500-503).  Reference quirks replicated
    for byte parity: the BX 'room for the tag' check compares against a
    stale string (empty before the first pair, then the previous pair's
    mate-qual line, correct.cc:441-444), so the first pair is always
    dropped; pairs without a parseable BX are dropped entirely, not
    routed to ema-nobc; under -b the nobc read-2 header gets a bare
    ' BX:Z:'.
    """
    from ema_tpu_torch import native
    from ema_tpu_torch.preproc.count import (
        haplotag_all_codes, haplotag_emission_order, parse_haplotag_bx)

    # 1. merge observed counts from all .ema-ncnt inputs
    merged: Dict[int, int] = {}
    for prefix in input_prefixes:
        bcs, cnts = read_ncnt(prefix if prefix.endswith(".ema-ncnt")
                              else prefix + ".ema-ncnt")
        for b, c in zip(bcs, cnts):
            merged[int(b)] = merged.get(int(b), 0) + int(c)

    # 2. greedy assignment over the whole generated code space, in the
    # reference's map-iteration order
    ordered = haplotag_all_codes()[haplotag_emission_order()]
    sizes = np.zeros(ordered.shape[0], np.int64)
    if merged:
        obs = np.fromiter(merged.keys(), np.uint32, len(merged))
        cnt = np.fromiter(merged.values(), np.int64, len(merged))
        si = np.argsort(obs)
        obs, cnt = obs[si], cnt[si]
        idxc, hit = lookup_sorted(obs, ordered)
        sizes = np.where(hit, cnt[idxc], 0).astype(np.int64)
    assigned = native.bucket_assign_pq(sizes, n_buckets)
    # sorted lookup table code -> bucket for phase 4
    csort = np.argsort(ordered)
    codes_sorted = ordered[csort]
    bucket_sorted = assigned[csort]
    del sizes, assigned

    files = [open(os.path.join(output_dir, "ema-nobc"), "wb")]
    for i in range(n_buckets):
        files.append(open(os.path.join(output_dir, f"ema-bin-{i:03d}"), "wb"))

    stats = {"nochange": 0, "h1": 0, "h2": 0, "nobucket": 0,
             "routed_pairs": 0, "dropped_pairs": 0}
    stale_len = 0    # the reference's `s` is empty at phase-4 entry
    CHUNK = 8192

    def flush(chunk):
        """Route one chunk: BX parses stay per-pair (the stale-length
        chain is sequential), but bucket lookups batch through one
        searchsorted and writes batch per bucket file."""
        nonlocal stale_len
        parsed = []                    # (pair, bc, bc_str) for kept pairs
        for pair in chunk:
            bc, bc_str = parse_haplotag_bx(pair[0], len_check=stale_len)
            stale_len = len(pair[7])   # the reference's `s` afterwards
            if bc is None or len(pair[1]) < config.MIN_READ_SIZE:
                stats["dropped_pairs"] += 1
                continue
            parsed.append((pair, bc, bc_str))
        if not parsed:
            return
        bcs = np.fromiter((p[1] for p in parsed), np.uint32, len(parsed))
        idxc, hit = lookup_sorted(codes_sorted, bcs)
        fidxs = np.where(hit, bucket_sorted[idxc], 0)
        out: Dict[int, List[bytes]] = {}
        for k, (pair, bc, bc_str) in enumerate(parsed):
            name1, r1, q1 = pair[0], pair[1], pair[3]
            name2, r2, q2 = pair[4], pair[5], pair[7]
            fidx = int(fidxs[k])
            if not hit[k]:
                bc_str = b""   # barcode = 0: PRINT_BCD emits nothing
            short1 = _short(name1)
            short2 = _short(name2)
            buf = out.setdefault(fidx, [])
            if fidx and not do_bx_format:
                buf.append(bc_str + b" " + short1 + b" " + r1 + b" "
                           + q1 + b" " + r2 + b" " + q2 + b"\n")
                stats["nochange"] += 1
            elif do_bx_format:
                # haplotag BX has no "-1" suffix (correct.cc:527-536);
                # for nobc read-1 header is plain, read-2 gets ' BX:Z:'
                if fidx:
                    buf.append(short1 + b" BX:Z:" + bc_str + b"\n" + r1
                               + b"\n+\n" + q1 + b"\n")
                    stats["nochange"] += 1
                else:
                    buf.append(short1 + b"\n" + r1 + b"\n+\n" + q1
                               + b"\n")
                    stats["nobucket"] += 1
                buf.append(short2 + b" BX:Z:" + bc_str + b"\n" + r2
                           + b"\n+\n" + q2 + b"\n")
            else:
                buf.append(short1 + b"\n" + r1 + b"\n+\n" + q1 + b"\n")
                buf.append(short2 + b"\n" + r2 + b"\n+\n" + q2 + b"\n")
                stats["nobucket"] += 1
            stats["routed_pairs"] += 1
        for fidx, lines in out.items():
            files[fidx].write(b"".join(lines))

    pend: List[List[bytes]] = []
    for pair in iter_fastq_pairs(stream):
        pend.append(pair)
        if len(pend) >= CHUNK:
            flush(pend)
            pend = []
    flush(pend)

    for f in files:
        f.close()
    return stats
