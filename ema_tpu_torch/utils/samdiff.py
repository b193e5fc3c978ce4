"""Order-insensitive SAM concordance diff (reference-EMA comparator).

The reference's correctness was established externally (paper notebook,
reference README.md:208); its own output is the concordance target for
this build (BASELINE.md).  Bit-identical comparison caveats (SURVEY.md
§4): run the reference with -t1 and without -d (srand(time) in
split.c:54-59), and compare order-insensitively — thread arrival order
permutes records, and MI (cloud id) numbering depends on visit order.

``diff_sams`` indexes both files by (QNAME, mate) primary records and
reports field-level concordance; MI ids are compared as a *mapping*
(bijective renaming allowed), not as values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class SamDiffStats:
    n_a: int = 0
    n_b: int = 0
    shared: int = 0
    only_a: int = 0
    only_b: int = 0
    pos_match: int = 0
    flag_match: int = 0
    cigar_match: int = 0
    mapq_match: int = 0
    mapq_close: int = 0          # |delta| <= 5
    bx_match: int = 0
    xg_close: int = 0            # |delta| <= 0.01
    mi_consistent: int = 0
    mate_match: int = 0          # RNEXT/PNEXT/TLEN triple
    seq_match: int = 0           # SEQ+QUAL (incl. revcomp orientation)
    xa_match: int = 0            # XA alt string
    mismatches: List[str] = dataclasses.field(default_factory=list)

    def concordance(self) -> float:
        """Primary metric: shared records whose (pos, flag, cigar) agree."""
        if not self.shared:
            return 0.0
        return min(self.pos_match, self.flag_match, self.cigar_match) \
            / self.shared

    def summary(self) -> str:
        s = self.shared or 1
        return "\n".join([
            f"records: a={self.n_a} b={self.n_b} shared={self.shared} "
            f"only_a={self.only_a} only_b={self.only_b}",
            f"pos:    {self.pos_match}/{self.shared} "
            f"({100.0 * self.pos_match / s:.3f}%)",
            f"flag:   {self.flag_match}/{self.shared} "
            f"({100.0 * self.flag_match / s:.3f}%)",
            f"cigar:  {self.cigar_match}/{self.shared} "
            f"({100.0 * self.cigar_match / s:.3f}%)",
            f"mapq:   exact {self.mapq_match}/{self.shared}, "
            f"within5 {self.mapq_close}/{self.shared}",
            f"BX:     {self.bx_match}/{self.shared}",
            f"XG~:    {self.xg_close}/{self.shared}",
            f"MI map: {self.mi_consistent}/{self.shared}",
            f"mate:   {self.mate_match}/{self.shared}",
            f"seq:    {self.seq_match}/{self.shared}",
            f"XA:     {self.xa_match}/{self.shared}",
            f"concordance (pos+flag+cigar): "
            f"{100.0 * self.concordance():.3f}%",
        ])


def _parse(path: str) -> Dict[Tuple[str, int], dict]:
    out: Dict[Tuple[str, int], dict] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@") or not line.strip():
                continue
            fld = line.rstrip("\n").split("\t")
            flag = int(fld[1])
            if flag & 0x900:          # secondary/supplementary
                continue
            mate = 1 if flag & 0x80 else 0
            tags = {}
            for t in fld[11:]:
                k, _, v = t.split(":", 2)
                tags[k] = v
            out[(fld[0], mate)] = dict(
                flag=flag, rname=fld[2], pos=int(fld[3]), mapq=int(fld[4]),
                cigar=fld[5], rnext=fld[6], pnext=fld[7], tlen=fld[8],
                seq=fld[9], qual=fld[10], tags=tags)
    return out


# flags that must agree; duplicate (0x400) excluded by default because the
# reference's dup-marking depends on selection among exact ties
FLAG_MASK = 0x1 | 0x2 | 0x4 | 0x8 | 0x10 | 0x20 | 0x40 | 0x80


def diff_sams(path_a: str, path_b: str, pos_tol: int = 0,
              flag_mask: int = FLAG_MASK,
              max_report: int = 20) -> SamDiffStats:
    a = _parse(path_a)
    b = _parse(path_b)
    st = SamDiffStats(n_a=len(a), n_b=len(b))
    keys = set(a) & set(b)
    st.shared = len(keys)
    st.only_a = len(a) - st.shared
    st.only_b = len(b) - st.shared
    mi_map: Dict[str, str] = {}
    mi_rev: Dict[str, str] = {}

    def report(key, what, va, vb):
        if len(st.mismatches) < max_report:
            st.mismatches.append(f"{key[0]}/{key[1]}: {what} {va} != {vb}")

    for key in sorted(keys):
        ra, rb = a[key], b[key]
        if ra["rname"] == rb["rname"] \
                and abs(ra["pos"] - rb["pos"]) <= pos_tol:
            st.pos_match += 1
        else:
            report(key, "pos", f"{ra['rname']}:{ra['pos']}",
                   f"{rb['rname']}:{rb['pos']}")
        if (ra["flag"] & flag_mask) == (rb["flag"] & flag_mask):
            st.flag_match += 1
        else:
            report(key, "flag", ra["flag"], rb["flag"])
        if ra["cigar"] == rb["cigar"]:
            st.cigar_match += 1
        else:
            report(key, "cigar", ra["cigar"], rb["cigar"])
        if ra["mapq"] == rb["mapq"]:
            st.mapq_match += 1
        if abs(ra["mapq"] - rb["mapq"]) <= 5:
            st.mapq_close += 1
        ta, tb_ = ra["tags"], rb["tags"]
        if ta.get("BX") == tb_.get("BX"):
            st.bx_match += 1
        try:
            if abs(float(ta.get("XG", 0)) - float(tb_.get("XG", 0))) <= 1e-2:
                st.xg_close += 1
        except ValueError:
            pass
        if (ra["rnext"], ra["pnext"], ra["tlen"]) \
                == (rb["rnext"], rb["pnext"], rb["tlen"]):
            st.mate_match += 1
        else:
            report(key, "mate-fields",
                   (ra["rnext"], ra["pnext"], ra["tlen"]),
                   (rb["rnext"], rb["pnext"], rb["tlen"]))
        if (ra["seq"], ra["qual"]) == (rb["seq"], rb["qual"]):
            st.seq_match += 1
        else:
            report(key, "seq/qual", ra["seq"][:20], rb["seq"][:20])
        if ta.get("XA") == tb_.get("XA"):
            st.xa_match += 1
        else:
            report(key, "XA", ta.get("XA"), tb_.get("XA"))
        mia, mib = ta.get("MI"), tb_.get("MI")
        if mia is None and mib is None:
            st.mi_consistent += 1
        elif mia is not None and mib is not None:
            if mi_map.setdefault(mia, mib) == mib \
                    and mi_rev.setdefault(mib, mia) == mia:
                st.mi_consistent += 1
            else:
                report(key, "MI-mapping", mia, mib)
    return st


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="ema_tpu samdiff",
        description="order-insensitive SAM concordance diff "
                    "(compare vs reference EMA output: run the reference "
                    "with -t1 and no -d)")
    ap.add_argument("sam_a")
    ap.add_argument("sam_b")
    ap.add_argument("--pos-tol", type=int, default=0)
    ap.add_argument("--with-dup-flag", action="store_true",
                    help="include the 0x400 duplicate flag in comparison")
    ap.add_argument("--max-report", type=int, default=20)
    ap.add_argument("--fail-under", type=float, default=None,
                    help="exit 1 if concordance %% falls below this")
    a = ap.parse_args(argv)
    mask = FLAG_MASK | (0x400 if a.with_dup_flag else 0)
    st = diff_sams(a.sam_a, a.sam_b, pos_tol=a.pos_tol, flag_mask=mask,
                   max_report=a.max_report)
    print(st.summary())
    for m in st.mismatches:
        print("  MISMATCH", m, file=sys.stderr)
    if a.fail_under is not None \
            and 100.0 * st.concordance() < a.fail_under:
        return 1
    return 0
