"""The plain reference that decides ``correct``: SAM records held to the
generator's truth and to a plain dynamic program over the genome.

It imports nothing of the program.  It reads the SAM text the timed
path wrote, the pool of reads and their truth (the generator's), and
the genome (the generator's array, not the port's index), and it
computes:

- ``bad_pairs``: pairs due whose records are not exactly one primary
  record per mate, with the mate's flag and its own bases and qualities
  (reverse-complemented where the record is on the reverse strand), and
  records of pairs not due.  Exact: limit 0.
- ``mi_outside`` (bucketed calls): records whose MI lies outside their
  bucket's namespace.  Exact: limit 0.
- ``bucket_wrong`` (bucketed calls): lines of the program's bucket files
  outside the bucket that preproc's rule gives their pair's barcode
  (``buckets.py``, from the generator's barcodes and whitelist), and
  pairs that their bucket holds other than once.  Exact: limit 0.
- ``nm_wrong``: sampled mapped records whose NM is not the edit distance
  of the CIGAR at POS against the genome.  Exact: limit 0.
- ``sw_gap_max``: over the sampled mapped records, the best score of a
  plain affine-gap alignment of the read near POS (BWA-MEM scoring with
  its clipping penalty, the model of the port's SW kernels) less the
  score of the record's own CIGAR at POS.  0 when every CIGAR is an
  optimal alignment.
- ``off_truth_pct``: primary records unmapped or more than ``tol_bp``
  from the truth, of all primary records due.
- ``em_off_truth_pct``: the same, of the records of mates that lie
  wholly in an exact repeat copy, where only the barcode's other reads
  (the cloud EM) tell the copies apart.
- ``em_low_xg_pct``: of the mapped records of those mates, the share
  whose XG (the EM's posterior of the alignment chosen) is under 0.5.
"""

from __future__ import annotations

import re

import numpy as np

from ema_bench.generate import name_pair, revcomp

NEG = -(1 << 28)
_CIGAR = re.compile(r"(\d+)([MIDSHN=X])")
_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i


class Records:
    """The primary records of the due pairs, gathered unit by unit."""

    def __init__(self, pool):
        self.pool = pool
        self.bad_pairs = 0
        self.mi_outside = 0
        self.bucket_wrong = 0
        self.due_records = 0
        # (pair, mate, flag, pos, cigar, nm, mapq, seq, xg)
        self.rows = []

    def add_unit(self, lines, due: np.ndarray, mi_ns=None,
                 mi_shift: int = 0) -> None:
        """One unit's SAM body (``lines``: an iterable of record lines)
        whose due pairs are ``due`` (bool [P]); ``mi_ns`` (int [P]), where
        given, is each pair's MI namespace, ``MI >> mi_shift``."""
        pool = self.pool
        seen = np.zeros((pool.n, 2), np.int32)
        wrong = np.zeros(pool.n, bool)
        quals = [pool.qual * pool.r1.shape[1], pool.qual * pool.r2.shape[1]]
        for ln in lines:
            if ln.startswith("@"):
                continue
            f = ln.rstrip("\n").split("\t")
            q = f[0]
            try:
                k = name_pair(q)[1]
            except ValueError:
                self.bad_pairs += 1
                continue
            if not (0 <= k < pool.n and pool.names[k] == q):
                self.bad_pairs += 1
                continue
            flag = int(f[1])
            if flag & 0x900:               # secondary, supplementary
                continue
            mate = 0 if flag & 0x40 else 1
            if not (flag & 0x1) or bool(flag & 0x40) == bool(flag & 0x80):
                wrong[k] = True
                continue
            seen[k, mate] += 1
            seq = pool.seq(k, mate)
            qual = quals[mate]
            if flag & 0x10:
                seq, qual = revcomp(seq), qual[::-1]
            if f[9] != seq or f[10] != qual:
                wrong[k] = True
            if mi_ns is not None:
                for t in f[11:]:
                    if t.startswith("MI:i:") and \
                            int(t[5:]) >> mi_shift != mi_ns[k]:
                        self.mi_outside += 1
            nm, xg = -1, -1.0
            for t in f[11:]:
                if t.startswith("NM:i:"):
                    nm = int(t[5:])
                elif t.startswith("XG:f:"):
                    xg = float(t[5:])
            self.rows.append((k, mate, flag, int(f[3]), f[5], nm,
                              int(f[4]), f[9], xg))
        ok = (seen == 1).all(axis=1) & ~wrong
        self.bad_pairs += int((due & ~ok).sum())
        self.bad_pairs += int((~due & (seen.any(axis=1) | wrong)).sum())
        self.due_records += 2 * int(due.sum())


def cigar_walk(seq: str, pos0: int, cigar: str, genome: np.ndarray,
               sc: dict):
    """(score with the clipping penalty, NM, leading clip, reference
    span) of an alignment; None where the CIGAR does not fit the read or
    the genome."""
    ops = _CIGAR.findall(cigar)
    if not ops:
        return None
    read = _LUT[np.frombuffer(seq.encode(), np.uint8)]
    q = r = nm = 0
    score = 0
    lead = 0
    for i, (n, op) in enumerate(ops):
        n = int(n)
        if op in "SH":
            if 0 < i < len(ops) - 1:
                return None
            if i == 0:
                lead = n
            score -= sc["clip"]
            q += n
        elif op in "M=X":
            g0 = pos0 + r
            if g0 < 0 or g0 + n > genome.shape[0] or q + n > read.shape[0]:
                return None
            a = read[q:q + n]
            b = genome[g0:g0 + n]
            same = int((a == b).sum())
            amb = int(((a > 3) | (b > 3)).sum())
            mis = n - same
            nm += mis
            score += same * sc["match"] - (mis - amb) * sc["mismatch"] - amb
            q += n
            r += n
        elif op == "I":
            score -= sc["gap_open"] + n * sc["gap_extend"]
            nm += n
            q += n
        elif op in "DN":
            score -= sc["gap_open"] + n * sc["gap_extend"]
            nm += n
            r += n
    if q != read.shape[0]:
        return None
    return score, nm, lead, r


def best_scores(reads, windows, sc: dict) -> np.ndarray:
    """Best alignment score of each read against its window: affine gaps
    (a gap of n costs gap_open + n gap_extend), any window start and
    end, a read clipped at either end for ``clip`` each (the scoring of
    the port's SW kernels and of BWA-MEM's extension).  ``reads``: lists
    of uint8 codes; ``windows``: lists of uint8 codes."""
    R = len(reads)
    M = max(len(x) for x in reads)
    N = max(len(x) for x in windows)
    Q = np.full((R, M), 9, np.uint8)
    W = np.full((R, N), 8, np.uint8)
    mlen = np.zeros(R, np.int64)
    for i, (a, b) in enumerate(zip(reads, windows)):
        Q[i, :len(a)] = a
        W[i, :len(b)] = b
        mlen[i] = len(a)
    valid_col = W != 8
    goe = sc["gap_open"] + sc["gap_extend"]
    ge = sc["gap_extend"]
    colk = ge * np.arange(1, N + 1, dtype=np.int64)[None, :]
    H_prev = np.full((R, N + 1), NEG, np.int64)
    V_prev = np.full((R, N + 1), NEG, np.int64)
    best = np.full(R, NEG, np.int64)
    for i in range(1, M + 1):
        qi = Q[:, i - 1][:, None]
        s = np.where(qi == W, sc["match"], -sc["mismatch"])
        s = np.where((qi == 4) | (W == 4), -1, s)
        fresh = 0 if i == 1 else -sc["clip"]
        diag = np.maximum(H_prev[:, :-1], fresh) + s
        V = np.maximum(H_prev[:, 1:] - goe, V_prev[:, 1:] - ge)
        H0 = np.maximum(diag, V)
        H0 = np.where(valid_col, H0, NEG)
        # horizontal gaps: E[j] = max over k < j of H0[k] - goe - ge (j-1-k)
        A = np.maximum.accumulate(H0 + colk, axis=1)
        E = np.full_like(H0, NEG)
        E[:, 1:] = A[:, :-1] - colk[:, :-1] - goe
        H = np.maximum(H0, np.where(valid_col, E, NEG))
        live = i <= mlen
        end = np.where(i == mlen, 0, -sc["clip"])
        row_best = H.max(axis=1) + end
        best = np.where(live, np.maximum(best, row_best), best)
        H = np.where(live[:, None], H, NEG)
        V = np.where(live[:, None], V, NEG)
        H_prev[:, 1:] = H
        V_prev[:, 1:] = V
    return best


def check(recs: Records, genome: np.ndarray, sc: dict, rng,
          n_sample: int, tol_bp: int, pad: int = 32) -> dict:
    """The numbers that decide ``correct`` (see the module's text)."""
    pool = recs.pool
    rows = recs.rows
    n_rec = len(rows)
    k = np.fromiter((r[0] for r in rows), np.int64, n_rec)
    mate = np.fromiter((r[1] for r in rows), np.int64, n_rec)
    flag = np.fromiter((r[2] for r in rows), np.int64, n_rec)
    mapped = (flag & 0x4) == 0
    lead = np.zeros(n_rec, np.int64)
    for i in np.flatnonzero(mapped):
        m = re.match(r"(\d+)[SH]", rows[i][4])
        lead[i] = int(m.group(1)) if m else 0
    pos = np.fromiter((r[3] for r in rows), np.int64, n_rec)
    truth = pool.left[k, mate]
    at = mapped & (np.abs(pos - 1 - lead - truth) <= tol_bp)
    missing = max(recs.due_records - n_rec, 0)
    off = 100.0 * (n_rec - int(at.sum()) + missing) / max(
        recs.due_records, 1)
    emr = pool.em_repeat[k, mate]
    em_off = 100.0 * int((emr & ~at).sum()) / max(int(emr.sum()), 1)
    xg = np.fromiter((r[8] for r in rows), np.float64, n_rec)
    em_mapped = emr & mapped
    em_low_xg = 100.0 * int((em_mapped & (xg < 0.5)).sum()) / max(
        int(em_mapped.sum()), 1)

    cand = np.flatnonzero(mapped)
    pick = (rng.choice(cand, min(n_sample, cand.shape[0]), replace=False)
            if cand.shape[0] else cand)
    nm_wrong = 0
    reads, windows, own = [], [], []
    for i in sorted(pick.tolist()):
        _, _, _, p, cigar, nm, _, seq, _ = rows[i]
        got = cigar_walk(seq, p - 1, cigar, genome, sc)
        if got is None:
            nm_wrong += 1
            continue
        score, nm_cigar, lead_i, rspan = got
        nm_wrong += nm_cigar != nm
        tail = len(seq) - lead_i
        lo = max(p - 1 - lead_i - pad, 0)
        hi = min(p - 1 + rspan + tail + pad, genome.shape[0])
        reads.append(_LUT[np.frombuffer(seq.encode(), np.uint8)])
        windows.append(genome[lo:hi])
        own.append(score)
    gap = 0
    if reads:
        gaps = []
        for s in range(0, len(reads), 1024):
            gaps.append(best_scores(reads[s:s + 1024], windows[s:s + 1024],
                                    sc) - np.asarray(own[s:s + 1024]))
        gap = int(np.concatenate(gaps).max())
    return {"bad_pairs": recs.bad_pairs, "mi_outside": recs.mi_outside,
            "bucket_wrong": recs.bucket_wrong,
            "nm_wrong": int(nm_wrong), "sw_gap_max": gap,
            "off_truth_pct": off, "em_off_truth_pct": em_off,
            "em_low_xg_pct": em_low_xg,
            "sampled_records": int(len(reads)),
            "em_repeat_records": int(emr.sum()),
            "records": int(n_rec)}
