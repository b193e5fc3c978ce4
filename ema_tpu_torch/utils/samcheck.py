"""Strict SAM validity checker (spec-level invariants).

No samtools in the loop: this module replaces `samtools quickcheck`-style
validation for tests and pipelines.  Checks per record: field syntax,
CIGAR/SEQ length agreement, flag consistency, positions within @SQ bounds;
and per read-pair: mate cross-references (RNEXT/PNEXT), strand flags, and
TLEN antisymmetry.

Returns a list of violation strings (empty = valid).

The port's own copy of ema_tpu/utils/samcheck.py; chip_smoke.py runs it
over the bench world's SAM on the card's host, where there is no samtools.
"""

from __future__ import annotations

import re
from typing import Dict, List

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_QUERY_OPS = set("MIS=X")


def check_sam(lines) -> List[str]:
    errors: List[str] = []
    sq_len: Dict[str, int] = {}
    pairs: Dict[str, List[dict]] = {}
    n_body = 0

    for lno, line in enumerate(lines, 1):
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith("@"):
            if line.startswith("@SQ"):
                f = dict(t.split(":", 1) for t in line.split("\t")[1:])
                sq_len[f["SN"]] = int(f["LN"])
            continue
        n_body += 1
        f = line.split("\t")
        if len(f) < 11:
            errors.append(f"line {lno}: only {len(f)} fields")
            continue
        qname, flag_s, rname, pos_s, mapq_s, cigar = f[:6]
        rnext, pnext_s, tlen_s, seq, qual = f[6:11]

        if " " in qname or not qname:
            errors.append(f"line {lno}: bad QNAME {qname!r}")
        try:
            flag, pos = int(flag_s), int(pos_s)
            mapq, pnext, tlen = int(mapq_s), int(pnext_s), int(tlen_s)
        except ValueError:
            errors.append(f"line {lno}: non-integer core field")
            continue
        if not 0 <= mapq <= 255:
            errors.append(f"line {lno}: MAPQ {mapq} out of range")

        unmapped = bool(flag & 4)
        if unmapped:
            if cigar != "*":
                errors.append(f"line {lno}: unmapped read has CIGAR")
        else:
            if rname == "*" or rname not in sq_len:
                errors.append(f"line {lno}: RNAME {rname!r} not in header")
            elif not 1 <= pos <= sq_len[rname]:
                errors.append(f"line {lno}: POS {pos} outside {rname}")
            ops = _CIG_RE.findall(cigar)
            if "".join(n + o for n, o in ops) != cigar:
                errors.append(f"line {lno}: malformed CIGAR {cigar!r}")
            qlen = sum(int(n) for n, o in ops if o in _QUERY_OPS)
            if seq != "*" and qlen != len(seq):
                errors.append(
                    f"line {lno}: CIGAR consumes {qlen} != SEQ {len(seq)}")
            if not unmapped and rname in sq_len:
                rlen = sum(int(n) for n, o in ops if o in "MDN=X")
                if pos + rlen - 1 > sq_len[rname]:
                    errors.append(
                        f"line {lno}: alignment end past {rname} length")
        if seq != "*" and qual != "*" and len(seq) != len(qual):
            errors.append(f"line {lno}: SEQ/QUAL length mismatch")

        if flag & 1:
            pairs.setdefault(qname, []).append(dict(
                lno=lno, flag=flag, rname=rname, pos=pos,
                rnext=rnext, pnext=pnext, tlen=tlen))

    for qname, recs in pairs.items():
        prim = [r for r in recs if not r["flag"] & 0x900]
        if len(prim) != 2:
            errors.append(f"{qname}: {len(prim)} primary records (want 2)")
            continue
        a, b = prim
        if bool(a["flag"] & 64) == bool(b["flag"] & 64):
            errors.append(f"{qname}: both mates have the same 1st/2nd flag")
        for x, y in ((a, b), (b, a)):
            if bool(x["flag"] & 8) != bool(y["flag"] & 4):
                errors.append(f"{qname}: mate-unmapped flag inconsistent")
            if bool(x["flag"] & 32) != bool(y["flag"] & 16):
                errors.append(f"{qname}: mate-reverse flag inconsistent")
            if not y["flag"] & 4:
                want = "=" if (x["rname"] == y["rname"]
                               and not x["flag"] & 4) else y["rname"]
                if x["rnext"] not in (want, y["rname"]):
                    errors.append(f"{qname}: RNEXT {x['rnext']!r} wrong")
                if x["pnext"] != y["pos"]:
                    errors.append(f"{qname}: PNEXT {x['pnext']} != mate POS "
                                  f"{y['pos']}")
        if not a["flag"] & 4 and not b["flag"] & 4 \
                and a["rname"] == b["rname"] and a["tlen"] != -b["tlen"]:
            errors.append(f"{qname}: TLEN not antisymmetric "
                          f"({a['tlen']} vs {b['tlen']})")
    if n_body == 0:
        errors.append("no body records")
    return errors
