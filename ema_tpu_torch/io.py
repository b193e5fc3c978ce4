"""Input readers for the align stage (reference: src/align.c:637-843).

A copy of ema_tpu/io.py:1-199, which imports ``ReadBatch`` from the
jax-importing ema_tpu/core/pipeline.py; these readers return the port's
``ReadBatch`` and import no jax.  Three input modes, as in the reference:
  - special EMA-FASTQ bucket files (`-s`): one line per pair
    `bc id read1 qual1 read2 qual2` (read1/qual1 barcode+7bp-trimmed);
    the whole file is read and sorted by barcode prefix
    (align.c:746-806).
  - standard barcode-sorted paired FASTQs (`-1`/`-2`), barcode taken from
    the read ID by the platform extractor (techs.c:5-69).
  - interleaved single FASTQ (`-1` only).
"""

from __future__ import annotations

import gzip
from typing import List, Tuple

from ema_tpu_torch.utils.barcodes import encode_bc, extract_bc_from_id
from ema_tpu_torch.core.batch import ReadBatch


def _open_text(path: str):
    """Open a (possibly gzipped) text input.  The reference delegates
    decompression to pigz in its shell pipeline (README.md:96-122); here
    .gz inputs decompress transparently."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_special_rows(path: str, is_haplotag: bool = False,
                      bc_len: int = 16):
    """Read a bucket file into barcode-sorted parallel lists
    (ids, bcs, s1, q1, s2, q2)."""
    rows: List[Tuple[str, ...]] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            rows.append(tuple(line.split(" ")))
    # sort by the barcode prefix (strncmp with BC_LEN — align.c:752-757)
    rows.sort(key=lambda r: r[0][:bc_len])
    ids, bcs, s1, q1, s2, q2 = [], [], [], [], [], []
    for r in rows:
        bc_str, rid, r1, r1q, r2, r2q = r[0], r[1], r[2], r[3], r[4], r[5]
        bcs.append(encode_bc(bc_str, is_haplotag))
        ids.append(rid[1:] if rid.startswith("@") else rid)
        s1.append(r1)
        q1.append(r1q)
        s2.append(r2)
        q2.append(r2q)
    return ids, bcs, s1, q1, s2, q2


def read_special_fastq(path: str, is_haplotag: bool = False,
                       bc_len: int = 16) -> ReadBatch:
    """Read a bucket file into one barcode-sorted ReadBatch."""
    return ReadBatch.from_pairs(*read_special_rows(path, is_haplotag, bc_len))


def _read_fastq_records(path: str):
    with _open_text(path) as f:
        while True:
            rid = f.readline()
            if not rid:
                return
            seq = f.readline().rstrip("\n")
            f.readline()
            qual = f.readline().rstrip("\n")
            yield rid.rstrip("\n"), seq, qual


def read_fastq_pair(fq1_path: str, fq2_path: str | None,
                    platform: str) -> ReadBatch:
    """Standard path: two barcode-sorted FASTQs (or one interleaved),
    read whole (the ``-1/-2 --sort`` path).

    ``platform == "none"``: no-barcode mode — every pair gets a unique
    synthetic barcode so each forms its own group (the align path for the
    reference's ema-nobc reads, README.md:132-137).
    """
    ids, bcs, s1, q1, s2, q2 = [], [], [], [], [], []
    if fq2_path is None or fq2_path == fq1_path:
        recs = list(_read_fastq_records(fq1_path))
        r1s, r2s = recs[0::2], recs[1::2]
    else:
        r1s = list(_read_fastq_records(fq1_path))
        r2s = list(_read_fastq_records(fq2_path))
    if len(r1s) != len(r2s):
        raise ValueError("unpaired FASTQ inputs")
    for i, ((id1, sa, qa), (_, sb, qb)) in enumerate(zip(r1s, r2s)):
        if platform == "none":
            rid = id1[1:] if id1.startswith("@") else id1
            ident, bc = rid.split(" ")[0], i
        else:
            ident, bc = extract_bc_from_id(id1, platform)
        ids.append(ident)
        bcs.append(bc)
        s1.append(sa)
        q1.append(qa)
        s2.append(sb)
        q2.append(qb)
    # group by barcode, preserving arrival order within a barcode
    order = sorted(range(len(ids)), key=lambda i: bcs[i])
    return ReadBatch.from_pairs(
        [ids[i] for i in order], [bcs[i] for i in order],
        [s1[i] for i in order], [q1[i] for i in order],
        [s2[i] for i in order], [q2[i] for i in order])


def iter_fastq_pair_groups(fq1_path: str, fq2_path: str | None,
                           platform: str):
    """Stream whole barcode groups from barcode-sorted paired FASTQs.

    The reference pulls one complete barcode group per lock acquisition
    (read_fastq_rec_bc_group, align.c:637-744) instead of slurping the
    input; this is the generator equivalent — memory is bounded by the
    largest single barcode group.  Yields (ids, bcs, s1, q1, s2, q2).

    ``platform == "none"``: every pair is its own group with a synthetic
    unique barcode (the ema-nobc path).
    """
    if fq2_path is None or fq2_path == fq1_path:
        def pairs():
            it = _read_fastq_records(fq1_path)
            while True:
                try:
                    r1 = next(it)
                except StopIteration:
                    return
                r2 = next(it)     # unpaired trailing record raises
                yield r1, r2
        pair_it = pairs()
    else:
        def pairs2():
            it1 = _read_fastq_records(fq1_path)
            it2 = _read_fastq_records(fq2_path)
            for r1 in it1:
                try:
                    r2 = next(it2)
                except StopIteration:
                    raise AssertionError("unpaired FASTQ inputs") from None
                yield r1, r2
            if next(it2, None) is not None:
                raise AssertionError("unpaired FASTQ inputs")
        pair_it = pairs2()

    cur_bc = None
    seen: set = set()
    warned = False
    ids: List[str] = []
    bcs: List[int] = []
    s1: List[str] = []
    q1: List[str] = []
    s2: List[str] = []
    q2: List[str] = []
    n = 0
    for (id1, sa, qa), (_, sb, qb) in pair_it:
        if platform == "none":
            rid = id1[1:] if id1.startswith("@") else id1
            ident, bc = rid.split(" ")[0], n
        else:
            ident, bc = extract_bc_from_id(id1, platform)
        if cur_bc is not None and bc != cur_bc and ids:
            yield ids, bcs, s1, q1, s2, q2
            ids, bcs, s1, q1, s2, q2 = [], [], [], [], [], []
            seen.add(cur_bc)
            if not warned and bc in seen:
                # the reference requires barcode-sorted FASTQs too
                # (README.md:73) and would silently fragment the group
                # the same way; at least say so
                import sys
                sys.stderr.write(
                    "ema_tpu: WARNING: input FASTQ is not barcode-"
                    "grouped (barcode seen again after a gap); cloud "
                    "EM runs per contiguous run — sort the FASTQ by "
                    "barcode for correct linked-read output\n")
                warned = True
        cur_bc = bc
        ids.append(ident)
        bcs.append(bc)
        s1.append(sa)
        q1.append(qa)
        s2.append(sb)
        q2.append(qb)
        n += 1
    if ids:
        yield ids, bcs, s1, q1, s2, q2


def read_fai(path: str) -> List[str]:
    """Chromosome name table from a .fai (main.c:57-71)."""
    names = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                names.append(line.split()[0])
    return names
