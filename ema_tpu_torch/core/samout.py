"""SAM emission (reference: src/samrecord.c:104-284, align.c:193-212).

Host-side formatting of selected records into SAM lines: flag assembly,
3-way-min mapq, CIGAR with hard->soft clip conversion, mate fields and
TLEN, revcomp of seq/qual for reverse-strand records, and the linked-read
tags NM / BX / XG / MI / XF / RG / XA.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ema_tpu_torch import config
from ema_tpu_torch.core import score as score_mod
from ema_tpu_torch.core.pairing import is_proper_pair
from ema_tpu_torch.utils.barcodes import decode_bc

SAM_READ_PAIRED = 1
SAM_READ_PROPER = 2
SAM_READ_UNMAPPED = 4
SAM_MATE_UNMAPPED = 8
SAM_READ_REVERSED = 16
SAM_MATE_REVERSED = 32
SAM_1ST_IN_PAIR = 64
SAM_2ND_IN_PAIR = 128
SAM_READ_IS_A_DUP = 1024

_CIGAR_OPS = "MIDSS"   # op 3 (H) printed as S — samrecord.c:187
_COMP_TABLE = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def write_sam_header(chrom_names, chrom_lens, rg: Optional[str],
                     version: str, cmd_line: str) -> str:
    lines = ["@HD\tVN:1.3\tSO:unsorted"]
    for name, ln in zip(chrom_names, chrom_lens):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    if rg:
        lines.append(rg)
    lines.append(f"@PG\tID:ema\tPN:ema\tVN:{version}\tCL:{cmd_line}")
    return "\n".join(lines) + "\n"


_CIGAR_CACHE: dict = {}


def cigar_string(cigar_ops: np.ndarray) -> str:
    """BAM-encoded ops -> CIGAR text; cached (most reads share e.g. 100M)."""
    key = cigar_ops.tobytes()
    s = _CIGAR_CACHE.get(key)
    if s is None:
        s = "".join(f"{int(op) >> 4}{_CIGAR_OPS[int(op) & 0xF]}"
                    for op in cigar_ops)
        if len(_CIGAR_CACHE) > 100_000:
            _CIGAR_CACHE.clear()
        _CIGAR_CACHE[key] = s
    return s


_REFLEN_CACHE: dict = {}


def _ref_len(cigar_ops: np.ndarray) -> int:
    """Reference-consumed length of a CIGAR (samrecord.c:75-84)."""
    key = cigar_ops.tobytes()
    t = _REFLEN_CACHE.get(key)
    if t is None:
        t = 0
        for op in cigar_ops:
            o = int(op) & 0xF
            if o == 0 or o == 2:
                t += int(op) >> 4
        if len(_REFLEN_CACHE) > 100_000:
            _REFLEN_CACHE.clear()
        _REFLEN_CACHE[key] = t
    return t


def revcomp(seq: str) -> str:
    return seq.translate(_COMP_TABLE)[::-1]


def format_g(x: float) -> str:
    """%.5g with C-style formatting (samrecord.c XG:f tag)."""
    return f"{x:.5g}"


def format_record(rec, mate, ident: str, chrom_name: str,
                  mate_chrom_name: Optional[str],
                  seq: str, qual: str,
                  rec_cigar: Optional[np.ndarray],
                  mate_cigar: Optional[np.ndarray],
                  gamma: float, cloud_id: int, cloud_bad: int,
                  alt: Optional[dict],
                  rg_id: Optional[str], bx_index: str,
                  is_haplotag: bool, bc_len: int,
                  mapq: Optional[int] = None,
                  bc_str: Optional[str] = None,
                  lr_tags: bool = True) -> str:
    """Format one SAM line.

    ``rec``/``mate`` are RECORD_DTYPE rows or None (one side may be
    unmapped — samrecord.c:157-174).  ``seq``/``qual`` are the record's
    read (forward orientation as read from FASTQ).
    """
    flag = SAM_READ_PAIRED
    chrom = "*"
    pos = 0

    if rec is not None:
        chrom = chrom_name
        pos = int(rec["pos"])
        bc = int(rec["bc"])
        if mapq is None:
            mapq = int(score_mod.final_mapq(
                np.array([gamma]), np.array([rec["score_mapq"]]),
                np.array([rec["mapq"]]))[0])
        if rec["rev"]:
            flag |= SAM_READ_REVERSED
        if rec["duplicate"]:
            flag |= SAM_READ_IS_A_DUP
        flag |= SAM_1ST_IN_PAIR if rec["mate"] == 0 else SAM_2ND_IN_PAIR
    else:
        bc = int(mate["bc"])
        mapq = 0
        flag |= SAM_READ_UNMAPPED
        flag |= SAM_2ND_IN_PAIR if mate["mate"] == 0 else SAM_1ST_IN_PAIR

    if mate is not None:
        if rec is not None and _is_pair(rec, mate):
            flag |= SAM_READ_PROPER
        if mate["rev"]:
            flag |= SAM_MATE_REVERSED
    else:
        flag |= SAM_MATE_UNMAPPED

    cig = cigar_string(rec_cigar) if rec is not None else "*"

    # mate fields + TLEN (samrecord.c:194-211)
    if mate is not None:
        same = rec is not None and rec["chrom"] == mate["chrom"]
        rnext = "=" if same else mate_chrom_name
        pnext = int(mate["pos"])
        if same and rec_cigar is not None and mate_cigar is not None \
                and len(rec_cigar) and len(mate_cigar):
            p0 = int(rec["aln_pos0"]) + (_ref_len(rec_cigar) - 1 if rec["rev"] else 0)
            p1 = int(mate["aln_pos0"]) + (_ref_len(mate_cigar) - 1 if mate["rev"] else 0)
            sign = 1 if p0 > p1 else (-1 if p0 < p1 else 0)
            tlen = -(p0 - p1 + sign)
        else:
            tlen = 0
    else:
        rnext, pnext, tlen = "*", 0, 0

    # seq/qual
    if rec is not None and rec["rev"]:
        seq = revcomp(seq)
        qual = qual[::-1]

    line = (f"{ident}\t{flag}\t{chrom}\t{pos}\t{mapq}\t{cig}\t"
            f"{rnext}\t{pnext}\t{tlen}\t{seq}\t{qual}")

    # tags
    if not lr_tags:
        # no-barcode mode: plain SAM, like the reference's `bwa mem` path
        # for ema-nobc reads (README.md:132-137)
        if rec is not None:
            line += f"\tNM:i:{int(rec['edit_dist'])}"
    elif rec is not None:
        if bc_str is None:
            bc_str = decode_bc(bc, bc_len, is_haplotag)
        bx = bc_str if is_haplotag else f"{bc_str}-{bx_index}"
        line += (f"\tNM:i:{int(rec['edit_dist'])}\tBX:Z:{bx}"
                 f"\tXG:f:{format_g(gamma)}\tMI:i:{cloud_id}\tXF:i:{cloud_bad}")
    else:
        if bc_str is None:
            bc_str = decode_bc(bc, bc_len, is_haplotag)
        bx = bc_str if is_haplotag else f"{bc_str}-1"
        line += f"\tBX:Z:{bx}"

    if rg_id:
        line += f"\tRG:Z:{rg_id.split()[0]}"

    if alt is not None:
        line += ("\tXA:Z:"
                 f"{alt['chrom']},{'-' if alt['rev'] else '+'}{alt['pos']},"
                 f"{cigar_string(alt['cigar'])},{alt['edit_dist']};")
    return line + "\n"


def _is_pair(r1, r2) -> bool:
    """Proper-pair predicate (align.c:27-40)."""
    return is_proper_pair(r1["chrom"], r1["pos"], r1["rev"],
                          r2["chrom"], r2["pos"], r2["rev"])


# ---------------------------------------------------------------------------
# Batched group emission (numeric prep vectorized here; string assembly in
# C++ native.format_sam_batch — the reference's print_sam_record in C)
# ---------------------------------------------------------------------------

def make_contig_blob(names) -> tuple:
    blob = "".join(names).encode()
    off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(n) for n in names], out=off[1:])
    return blob, off


def _ref_len_vec(pool: np.ndarray, off: np.ndarray, ln: np.ndarray,
                 max_ops: int) -> np.ndarray:
    """Reference-consumed length per CIGAR (one native pool pass)."""
    if off.shape[0] == 0:
        return np.zeros(0, np.int64)
    from ema_tpu_torch import native
    return native.cigar_stats_pool(pool, off, ln)[4]


def emit_group_lines(res, pool, max_cigar_ops, seqs, quals,
                     contig_blob, contig_off, rg_id, bx_str: str,
                     nobc: bool, mapqs) -> List[str]:
    """All SAM lines for one processed barcode group (GroupResult);
    single-group front-end for emit_groups_lines."""
    return emit_groups_lines([(res, bx_str, mapqs)], pool, max_cigar_ops,
                             seqs, quals, contig_blob, contig_off, rg_id,
                             nobc)[0]


def emit_groups_lines(groups, pool, max_cigar_ops, seqs, quals,
                      contig_blob, contig_off, rg_id,
                      nobc: bool) -> List[List[str]]:
    """SAM lines for MANY processed barcode groups in one native call.

    ``groups``: list of (GroupResult, bx_full_str, mapqs).  Exactly
    reproduces per-group emit_group_lines output (numeric prep vectorized
    over the concatenated record space; BX per row; string assembly in
    C++), returning one line-list per input group.  Callers with
    bx_index != "1" use the scalar path instead (the mapped/unmapped BX
    suffixes diverge there).
    """
    from ema_tpu_torch import native

    out_lists: List[List[str]] = [[] for _ in groups]
    live = [(gi, res, bxs, mq) for gi, (res, bxs, mq) in enumerate(groups)
            if len(res.emit_pairs)]
    if not live:
        return out_lists

    if len(live) == 1:
        gi0, res, bx_one, mapqs = live[0]
        R, RI = res.records, res.idents
        gamma_v, cloud_v, bad_v, alt_v = (res.gamma, res.cloud_id,
                                          res.cloud_bad, res.alt_idx)
        pairs = np.asarray(res.emit_pairs, np.int64).reshape(-1, 2)
        a_arr, b_arr = pairs[:, 0], pairs[:, 1]
        bx_rows = None
        bx_bytes_one = bx_one.encode()
    else:
        # concatenated record space with per-group index offsets
        rcounts = [r.records.shape[0] for _, r, _, _ in live]
        roff = np.concatenate([[0], np.cumsum(rcounts)])
        R = np.concatenate([r.records for _, r, _, _ in live])
        RI = np.concatenate([r.idents for _, r, _, _ in live])
        gamma_v = np.concatenate([r.gamma for _, r, _, _ in live])
        cloud_v = np.concatenate([r.cloud_id for _, r, _, _ in live])
        bad_v = np.concatenate([r.cloud_bad for _, r, _, _ in live])
        alt_v = np.concatenate(
            [np.where(r.alt_idx >= 0, r.alt_idx + o, -1)
             for (_, r, _, _), o in zip(live, roff)])
        mapqs = np.concatenate([m for _, _, _, m in live])
        ab = []
        bx_row_list = []
        for (_, r, bxs, _), o in zip(live, roff):
            pr = np.asarray(r.emit_pairs, np.int64).reshape(-1, 2)
            ab.append(np.where(pr >= 0, pr + o, -1))
            bx_row_list.extend([bxs.encode()] * (2 * pr.shape[0]))
        ab = np.concatenate(ab)
        a_arr, b_arr = ab[:, 0], ab[:, 1]
        bx_rows = bx_row_list
        bx_bytes_one = b""
    P = a_arr.shape[0]
    # rows interleaved: [rec_a, rec_b-or-unmapped] per pair
    rec = np.stack([a_arr, b_arr], axis=1).ravel()
    mate = np.stack([b_arr, a_arr], axis=1).ravel()
    M = rec.shape[0]
    mapped = rec >= 0
    has_mate = mate >= 0
    ri = np.maximum(rec, 0)
    mi_ = np.maximum(mate, 0)

    # reference-consumed lengths for TLEN (aln_pos0 + reflen - 1 for rev)
    reflen = _ref_len_vec(pool, R["cig_off"], R["cig_len"], max_cigar_ops)

    flag = np.full(M, SAM_READ_PAIRED, np.int32)
    flag |= np.where(mapped & (R["rev"][ri] != 0), SAM_READ_REVERSED, 0)
    flag |= np.where(mapped & R["duplicate"][ri], SAM_READ_IS_A_DUP, 0)
    flag |= np.where(mapped,
                     np.where(R["mate"][ri] == 0, SAM_1ST_IN_PAIR,
                              SAM_2ND_IN_PAIR),
                     np.where(R["mate"][mi_] == 0, SAM_2ND_IN_PAIR,
                              SAM_1ST_IN_PAIR))
    flag |= np.where(mapped, 0, SAM_READ_UNMAPPED)
    # proper pair (both mapped, FR, insert window — align.c:27-40)
    both = mapped & has_mate
    d = np.where(R["rev"][mi_] != 0,
                 R["pos"][mi_] - R["pos"][ri],
                 R["pos"][ri] - R["pos"][mi_])
    proper = both & (R["rev"][ri] != R["rev"][mi_]) \
        & (R["chrom"][ri] == R["chrom"][mi_]) \
        & (d >= config.INSERT_MIN) & (d <= config.INSERT_MAX)
    flag |= np.where(proper, SAM_READ_PROPER, 0)
    flag |= np.where(has_mate & (R["rev"][mi_] != 0), SAM_MATE_REVERSED, 0)
    flag |= np.where(has_mate, 0, SAM_MATE_UNMAPPED)

    chrom_idx = np.where(mapped, R["chrom"][ri], -2).astype(np.int32)
    pos = np.where(mapped, R["pos"][ri], 0)
    mapq = np.where(mapped, mapqs[ri], 0).astype(np.int32)

    same = both & (R["chrom"][ri] == R["chrom"][mi_])
    # '=' only when same-chrom AND this record mapped; otherwise mate chrom
    rnext = np.where(~has_mate, -2,
                     np.where(same, -1, R["chrom"][mi_])).astype(np.int32)
    pnext = np.where(has_mate, R["pos"][mi_], 0)
    tl_ok = same & (R["cig_len"][ri] > 0) & (R["cig_len"][mi_] > 0)
    p0 = R["aln_pos0"][ri] + np.where(R["rev"][ri] != 0, reflen[ri] - 1, 0)
    p1 = R["aln_pos0"][mi_] + np.where(R["rev"][mi_] != 0,
                                       reflen[mi_] - 1, 0)
    sign = np.sign(p0 - p1)
    tlen = np.where(tl_ok, -(p0 - p1 + sign), 0)

    cig_off = np.where(mapped, R["cig_off"][ri], 0)
    cig_len = np.where(mapped, R["cig_len"][ri], -1).astype(np.int32)
    rev = np.where(mapped, R["rev"][ri], 0).astype(np.int32)
    nm = np.where(mapped, R["edit_dist"][ri], 0).astype(np.int32)
    gamma = np.where(mapped, gamma_v[ri], 0.0)
    mi_tag = np.where(mapped, cloud_v[ri], 0)
    xf = np.where(mapped, bad_v[ri], 0).astype(np.int32)

    alt = np.where(mapped, alt_v[ri], -1)
    has_alt = alt >= 0
    ai = np.maximum(alt, 0)
    alt_chrom = np.where(has_alt, R["chrom"][ai], 0).astype(np.int32)
    alt_pos = np.where(has_alt, R["pos"][ai], 0)
    alt_rev = np.where(has_alt, R["rev"][ai], 0).astype(np.int32)
    alt_cig_off = np.where(has_alt, R["cig_off"][ai], 0)
    alt_cig_len = np.where(has_alt, R["cig_len"][ai], -1).astype(np.int32)
    alt_nm = np.where(has_alt, R["edit_dist"][ai], 0).astype(np.int32)

    if nobc:
        lr = np.where(mapped, 3, 0).astype(np.int32)
    else:
        lr = np.where(mapped, 1, 2).astype(np.int32)

    # string blobs: names per row; seq/qual row = pair*2 + mate# —
    # vectorized source/row selection, strings gathered via object-array
    # fancy indexing (no per-record Python bookkeeping)
    is_rec = rec >= 0
    src_v = np.where(is_rec, rec, mate).astype(np.int64)
    mate_col = R["mate"][src_v].astype(np.int64)
    row_v = (R["pair"][src_v].astype(np.int64) * 2
             + np.where(is_rec, mate_col, 1 - mate_col))
    name_list = RI[src_v].tolist()
    # callers pass chunk-level object ndarrays (pipeline converts once
    # per chunk); converting a ~4k-string list here per GROUP dominated
    # the emit path
    seq_arr = seqs if isinstance(seqs, np.ndarray) \
        else np.asarray(seqs, dtype=object)
    qual_arr = quals if isinstance(quals, np.ndarray) \
        else np.asarray(quals, dtype=object)
    seq_list = seq_arr[row_v].tolist()
    qual_list = qual_arr[row_v].tolist()
    names_blob = "".join(name_list).encode()
    seqs_blob = "".join(seq_list).encode()
    quals_blob = "".join(qual_list).encode()

    def offs(lst):
        o = np.zeros(len(lst) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, lst), np.int64, len(lst)),
                  out=o[1:])
        return o

    if bx_rows is None:
        bx_arg = bx_bytes_one
    else:
        bx_blob = b"".join(bx_rows)
        bx_off = np.zeros(len(bx_rows) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, bx_rows), np.int64, len(bx_rows)),
                  out=bx_off[1:])
        bx_arg = (bx_blob, bx_off)
    rg_bytes = (rg_id or "").encode()

    out = native.format_sam_batch(
        names_blob, offs(name_list), seqs_blob, offs(seq_list),
        quals_blob, offs(qual_list), contig_blob, contig_off,
        flag, chrom_idx, pos, mapq, rnext, pnext, tlen, rev,
        cig_off, cig_len, pool, nm, gamma, mi_tag, xf,
        alt_chrom, alt_pos, alt_rev, alt_cig_off, alt_cig_len, alt_nm,
        lr, bx_arg, rg_bytes)
    lines = out.decode().splitlines(keepends=True)
    # split back into per-group line lists (2 rows per emitted pair)
    at = 0
    for gi, r, _, _ in live:
        n_g = 2 * len(r.emit_pairs)
        out_lists[gi] = lines[at:at + n_g]
        at += n_g
    assert at == len(lines)
    return out_lists
