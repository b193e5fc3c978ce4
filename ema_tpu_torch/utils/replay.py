"""Candidate-replay capture for the reference align-core oracle.

The reference EM/selection/SAM stack (src/align.c:214-630 + samdict.c +
samrecord.c) depends on bwa only through bwabridge.  The concordance
oracle (tests/oracle/bwabridge_stub.c) replays OUR candidate sets into
the reference's own compiled code; this module writes those candidates
in the stub's replay format from live CandidateSets.

Per-read candidates are emitted best-score-first across both strands
(stable on ties), matching the order mem_align1_core hands the
reference (it anchors its edit-distance window on candidate 0,
align.c:1018-1024).

The port's own copy of ema_tpu/utils/replay.py (the port imports nothing
of the JAX package); ``Aligner.replay_sink`` takes ``ReplayWriter.add``.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

_CIG_OPS = "MIDSS"


def cigar_string(ops: np.ndarray, n: int) -> str:
    if n == 0:
        return "*"
    return "".join(f"{int(op) >> 4}{_CIG_OPS[int(op) & 0xF]}"
                   for op in ops[:n])


class ReplayWriter:
    """Buffers (ident, mate) candidate entries; writes the replay file on
    close.  Thread-safe: iter_batch_sam calls ``add`` from chunk workers."""

    def __init__(self, path: str, contig_names: List[str],
                 contig_lens: List[int]):
        self.path = path
        self.contigs = list(zip(contig_names, contig_lens))
        self.entries: List[str] = []
        self._lock = threading.Lock()

    def add(self, batch, cs) -> None:
        """Append one chunk's candidates (ReadBatch + CandidateSet)."""
        N = cs.owner.shape[0]
        lines: List[str] = []
        if N:
            rspan = _ref_span(cs.cigars, cs.n_cigar)
            order = np.lexsort((np.arange(N), -cs.sw.astype(np.int64),
                                cs.owner))
            bounds = np.nonzero(np.diff(cs.owner[order]))[0] + 1
            starts = np.concatenate([[0], bounds, [N]])
            for s, e in zip(starts[:-1], starts[1:]):
                idxs = order[s:e]
                owner = int(cs.owner[idxs[0]])
                ident = batch.ids[owner // 2]
                lines.append(f"E {ident} {owner % 2} {e - s}")
                for i in idxs:
                    i = int(i)
                    lines.append(
                        " ".join([
                            _contig_token(self.contigs, int(cs.chrom[i])),
                            str(int(cs.pos_local[i]) - 1),
                            str(int(cs.rev[i])),
                            str(int(cs.sw[i])),
                            str(int(cs.sub[i])),
                            "0",                       # csub
                            str(int(cs.sub_n[i])),
                            str(int(cs.seedcov[i])),
                            "%.9g" % float(cs.frac_rep[i]),
                            str(int(cs.qb[i])),
                            str(int(cs.qe[i])),
                            "0",                       # rb
                            str(int(rspan[i])),        # re
                            str(int(cs.nm[i])),
                            cigar_string(cs.cigars[i], int(cs.n_cigar[i])),
                        ]))
        with self._lock:
            self.entries.extend(lines)

    def close(self) -> None:
        n_entries = sum(1 for l in self.entries if l.startswith("E "))
        with open(self.path, "w") as f:
            f.write(f"NCONTIGS {len(self.contigs)}\n")
            for name, ln in self.contigs:
                f.write(f"{name} {ln}\n")
            f.write(f"NENTRIES {n_entries}\n")
            f.write("\n".join(self.entries))
            if self.entries:
                f.write("\n")


def _contig_token(contigs, idx: int) -> str:
    return contigs[idx][0]


def _ref_span(cigars: np.ndarray, n_cigar: np.ndarray) -> np.ndarray:
    ops = cigars & 0xF
    lens = (cigars >> 4).astype(np.int64)
    live = np.arange(cigars.shape[1])[None, :] < n_cigar[:, None]
    use = live & ((ops == 0) | (ops == 2))
    return np.where(use, lens, 0).sum(axis=1)
