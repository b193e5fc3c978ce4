"""The benchmark's one generator: a reference genome with planted repeat
families, a sample that differs from it by SNVs and small indels, and
linked-read pairs drawn from that sample, with the barcodes and read
names of the configuration's platform.  Everything is numpy and
comes from a seed: the genome from the configuration's own seed, the
sample and its reads from the run's ``--seed``.

Parameters come from data files only: ``configs/<name>.json`` (genome,
read shapes, platform) and ``traffic/<name>.json`` (molecules, pairs,
inserts, pool size).

Barcodes follow EMA's platforms (src/techs.c): ``10x``, ``dbs`` and
``tellseq`` draw ACGT strings of ``reads.bc_len``; ``haplotag`` draws
four segments A, C, B and D, each numbered 01-96 (Meier et al., PNAS
118:e2015005118, 2021); ``tru`` and ``cpt`` draw distinct integers from
``reads.bc_range`` (both ends included).  Groups come in the order of
the aligner's barcode value, worked out here in NumPy.

A read pair's truth is the 0-based reference coordinate of the leftmost
base of each mate, as aligned on the forward strand.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ASCII = np.frombuffer(b"ACGTN", np.uint8)
COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def _substitute(rng, codes: np.ndarray, rate: float) -> None:
    """Replace each base, with probability ``rate``, by another base."""
    hit = np.flatnonzero(rng.random(codes.shape) < rate) if rate else []
    if len(hit):
        flat = codes.reshape(-1)
        flat[hit] = (flat[hit] + rng.integers(1, 4, len(hit))) % 4


def make_genome(g: dict):
    """(codes uint8 [length], repeats int64 [k, 3]) for a genome section
    of a configuration.  ``repeats`` rows are (start, end, divergence in
    parts per million) of each family's source and its copies.

    Families: ``repeat_families`` units of a length drawn from
    ``repeat_unit_bp``, each copied ``repeat_copies`` times to random
    places, copy c diverged by substitutions at
    ``repeat_divergence[c % len]`` (the pattern of the port's
    tools/measure_accuracy.plant_repeats)."""
    rng = np.random.default_rng(int(g["seed"]))
    n = int(g["length"])
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    lo, hi = g["repeat_unit_bp"]
    divs = g["repeat_divergence"]
    rows = []
    for _ in range(int(g["repeat_families"])):
        ln = int(rng.integers(lo, hi + 1))
        src = int(rng.integers(0, n - ln))
        unit = codes[src:src + ln].copy()
        rows.append((src, src + ln, 0))
        for c in range(int(g["repeat_copies"])):
            at = int(rng.integers(0, n - ln))
            cp = unit.copy()
            rate = float(divs[c % len(divs)])
            nmut = int(round(rate * ln))
            if nmut:
                pos = rng.choice(ln, nmut, replace=False)
                cp[pos] = (cp[pos] + rng.integers(1, 4, nmut)) % 4
            codes[at:at + ln] = cp
            rows.append((at, at + ln, int(round(rate * 1e6))))
    return codes, np.asarray(rows, np.int64).reshape(-1, 3)


@dataclasses.dataclass
class Sample:
    """The sample's genome and the map from its coordinates back to the
    reference's: segment k starts at sample coordinate ``s_start[k]``
    and, where ``s_ref[k] >= 0``, is reference bases from ``s_ref[k]``;
    an inserted segment has ``s_ref[k] = -(insertion point) - 1``."""
    codes: np.ndarray
    s_start: np.ndarray
    s_ref: np.ndarray

    def to_ref(self, s: np.ndarray) -> np.ndarray:
        k = np.searchsorted(self.s_start, s, side="right") - 1
        base = self.s_ref[k]
        return np.where(base >= 0, base + (s - self.s_start[k]), -base - 1)


def make_sample(rng, ref: np.ndarray, snv_rate: float, indel_rate: float,
                indel_len) -> Sample:
    """The reference with SNVs at ``snv_rate`` and insertions or deletions
    of ``indel_len`` bases at ``indel_rate`` per reference base."""
    n = ref.shape[0]
    codes = ref.copy()
    n_snv = int(rng.binomial(n, snv_rate))
    pos = rng.integers(0, n, n_snv)
    codes[pos] = (codes[pos] + rng.integers(1, 4, n_snv)) % 4
    n_ind = int(rng.binomial(n, indel_rate))
    at = np.unique(rng.integers(1000, n - 1000, n_ind))
    lens = rng.integers(indel_len[0], indel_len[1] + 1, at.shape[0])
    is_ins = rng.random(at.shape[0]) < 0.5
    pieces, s_start, s_ref = [], [], []
    s = prev = 0
    for a, ln, ins in zip(at.tolist(), lens.tolist(), is_ins.tolist()):
        if a < prev:               # inside the previous deletion
            continue
        pieces.append(codes[prev:a])
        s_start.append(s)
        s_ref.append(prev)
        s += a - prev
        if ins:
            pieces.append(rng.integers(0, 4, ln, dtype=np.uint8))
            s_start.append(s)
            s_ref.append(-a - 1)
            s += ln
            prev = a
        else:
            prev = a + ln
    pieces.append(codes[prev:])
    s_start.append(s)
    s_ref.append(prev)
    return Sample(np.concatenate(pieces), np.asarray(s_start, np.int64),
                  np.asarray(s_ref, np.int64))


def encode_bc(codes: np.ndarray) -> np.ndarray:
    """[N, L] base codes -> the aligner's 2-bit barcode value, first base
    in the low bits (EMA's src/util.c), which orders its barcode groups."""
    shifts = 2 * np.arange(codes.shape[1], dtype=np.uint64)
    return (codes.astype(np.uint64) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64)


ACGT_PLATFORMS = ("10x", "dbs", "tellseq")
INT_PLATFORMS = ("tru", "cpt")
PLATFORMS = ACGT_PLATFORMS + ("haplotag",) + INT_PLATFORMS
HAPLOTAG_WELLS = 96     # each of the four segments is numbered 01-96


def draw_barcodes(rng, platform: str, reads: dict, n_bc: int):
    """``n_bc`` distinct barcodes of ``platform``: (label of each, as the
    read name carries it; the aligner's barcode value of each, uint64).

    ACGT platforms take one [n_bc, bc_len] draw of base codes, and draw
    again only the barcodes whose value an earlier one has; haplotag
    packs its segments as A<<24 | C<<16 | B<<8 | D (EMA src/util.c);
    integer platforms' value is the integer."""
    if platform in ACGT_PLATFORMS:
        bl = int(reads["bc_len"])
        codes = rng.integers(0, 4, (n_bc, bl), dtype=np.uint8)
        val = encode_bc(codes)
        while True:
            _, first = np.unique(val, return_index=True)
            if first.shape[0] == n_bc:
                break
            again = np.setdiff1d(np.arange(n_bc), first)
            codes[again] = rng.integers(0, 4, (again.shape[0], bl),
                                        dtype=np.uint8)
            val = encode_bc(codes)
        return ["".join("ACGT"[c] for c in row) for row in
                codes.tolist()], val
    if platform == "haplotag":
        w = HAPLOTAG_WELLS
        flat = rng.choice(w ** 4, n_bc, replace=False)
        seg = np.stack([flat // w ** 3, flat // w ** 2 % w, flat // w % w,
                        flat % w], axis=1).astype(np.uint64) + 1
        val = (seg[:, 0] << 24) | (seg[:, 1] << 16) | (seg[:, 2] << 8) \
            | seg[:, 3]
        return ["A%02dC%02dB%02dD%02d" % tuple(r) for r in seg.tolist()], \
            val.astype(np.uint64)
    if platform in INT_PLATFORMS:
        lo, hi = (int(x) for x in reads["bc_range"])
        if hi - lo + 1 < n_bc:
            raise ValueError(f"reads.bc_range {lo}-{hi} holds fewer than "
                             f"the {n_bc} barcodes the traffic draws")
        val = lo + rng.choice(hi - lo + 1, n_bc, replace=False)
        return [str(v) for v in val.tolist()], val.astype(np.uint64)
    raise ValueError(f"no barcodes for platform {platform!r} (one of "
                     f"{', '.join(PLATFORMS)})")


def read_name(platform: str, group: int, k: int, label: str) -> str:
    """The QNAME that the port prints for pair ``k`` of ``group``: the
    harness's ``g<group>p<k>``, led by the well number on ``tru``, whose
    reader takes the whole read ID (EMA src/techs.c)."""
    name = f"g{group}p{k}"
    return f"{label}-{name}" if platform == "tru" else name


def name_pair(qname: str):
    """(group, pair) of a QNAME made by ``read_name``."""
    i = qname.rindex("g")
    j = qname.index("p", i)
    return int(qname[i + 1:j]), int(qname[j + 1:])


# the FASTQ header of a pair on each platform, as the port's reader takes
# it (EMA src/techs.c): ``name:BC`` (10x, DBS), ``name BX:Z:BC`` (the form
# TELL-seq's and haplotagging's pipelines write), the well number leading
# the ID (TruSeq SLR; ``read_name`` puts it there), and ``name:BC<n>``,
# whose number CPT-seq's reader takes from two characters past the last
# ':'
HEADS = {"10x": "@{name}:{bc}\n", "dbs": "@{name}:{bc}\n",
         "tellseq": "@{name} BX:Z:{bc}\n", "haplotag": "@{name} BX:Z:{bc}\n",
         "tru": "@{name}\n", "cpt": "@{name}:BC{bc}\n"}


@dataclasses.dataclass
class Pool:
    """Read pairs in barcode-group order (the order of a barcode-sorted
    FASTQ, groups by the aligner's barcode value)."""
    names: list            # QNAME of pair k (read_name)
    bcs: list              # barcode label of pair k
    group: np.ndarray      # int64 [P] group of pair k (0, 1, ... in order)
    r1: np.ndarray         # uint8 [P, r1_len] mate 1 as sequenced
    r2: np.ndarray         # uint8 [P, r2_len] mate 2 as sequenced
    left: np.ndarray       # int64 [P, 2] truth: leftmost reference base
    rev: np.ndarray        # bool [P, 2] mate on the reverse strand
    em_repeat: np.ndarray  # bool [P, 2] mate wholly inside an exact
    #                        repeat copy (em_repeat_max_ppm)
    qual: str              # the quality character of every base
    platform: str = "10x"  # the read names' form (HEADS)
    bc_val: np.ndarray = None  # uint64 [P] the aligner's barcode value

    @property
    def n(self) -> int:
        return len(self.names)

    def seq(self, k: int, mate: int) -> str:
        r = self.r1 if mate == 0 else self.r2
        return ASCII[r[k]].tobytes().decode()


def make_pool(rng, sample: Sample, repeats: np.ndarray, reads: dict,
              traffic: dict, n_pairs: int, platform: str = "10x") -> Pool:
    """``n_pairs`` pairs of linked reads: barcodes of ``molecules``
    molecules of ``molecule_bp``, each with ``pairs_per_molecule`` pairs
    of insert sizes in ``insert_bp``, strands at random, sequencing
    substitutions at ``reads['seq_error_rate']``.  The last group is cut
    so that the pool holds exactly ``n_pairs``."""
    gs = sample.codes.shape[0]
    mol_bp = int(traffic["molecule_bp"])
    per_bc = (traffic["molecules"][0] + traffic["molecules"][1]) / 2
    per_mol = (traffic["pairs_per_molecule"][0]
               + traffic["pairs_per_molecule"][1]) / 2
    n_bc = int(n_pairs / (per_bc * per_mol) * 1.3) + 8
    n_mol = rng.integers(traffic["molecules"][0],
                         traffic["molecules"][1] + 1, n_bc)
    mol_bc = np.repeat(np.arange(n_bc), n_mol)
    mol_start = rng.integers(0, gs - mol_bp, mol_bc.shape[0])
    n_pm = rng.integers(traffic["pairs_per_molecule"][0],
                        traffic["pairs_per_molecule"][1] + 1,
                        mol_bc.shape[0])
    pair_mol = np.repeat(np.arange(mol_bc.shape[0]), n_pm)
    pair_bc = mol_bc[pair_mol]
    bc_str, bc_val = draw_barcodes(rng, platform, reads, n_bc)
    # barcode-sorted: groups in the aligner's barcode order, pairs of a
    # group shuffled
    bc_rank = np.empty(n_bc, np.int64)
    bc_rank[np.argsort(bc_val, kind="stable")] = np.arange(n_bc)
    order = np.lexsort((rng.random(pair_bc.shape[0]), bc_rank[pair_bc]))
    order = order[:n_pairs]
    if order.shape[0] < n_pairs:
        raise ValueError("traffic yields fewer pairs than the pool holds")
    pair_mol = pair_mol[order]
    pair_bc = pair_bc[order]
    P = n_pairs

    l1, l2 = int(reads["r1_len"]), int(reads["r2_len"])
    ins = rng.integers(traffic["insert_bp"][0], traffic["insert_bp"][1] + 1,
                       P)
    ms = mol_start[pair_mol]
    frag = ms + (rng.random(P) * (mol_bp - ins)).astype(np.int64)
    rev1 = rng.random(P) < 0.5
    # mate spans on the sample's forward strand: the forward mate starts
    # the fragment, the reverse mate ends it
    start1 = np.where(rev1, frag + ins - l1, frag)
    start2 = np.where(rev1, frag, frag + ins - l2)
    r1 = sample.codes[start1[:, None] + np.arange(l1)[None, :]]
    r2 = sample.codes[start2[:, None] + np.arange(l2)[None, :]]
    # a reverse mate is sequenced as the reverse complement
    r1 = np.where(rev1[:, None], 3 - r1[:, ::-1], r1).astype(np.uint8)
    r2 = np.where(~rev1[:, None], 3 - r2[:, ::-1], r2).astype(np.uint8)
    err = float(reads["seq_error_rate"])
    _substitute(rng, r1, err)
    _substitute(rng, r2, err)

    left = np.stack([sample.to_ref(start1), sample.to_ref(start2)], axis=1)
    ends = np.stack([sample.to_ref(start1 + l1 - 1),
                     sample.to_ref(start2 + l2 - 1)], axis=1)
    near = repeats[repeats[:, 2] <= int(traffic["em_repeat_max_ppm"])]
    em_rep = np.zeros((P, 2), bool)
    for s, e, _ in near.tolist():
        em_rep |= (left >= s) & (ends < e)

    group = np.concatenate([[0], np.cumsum(pair_bc[1:] != pair_bc[:-1])])
    bcs = [bc_str[b] for b in pair_bc.tolist()]
    names = [read_name(platform, g, k, bc) for k, (g, bc) in
             enumerate(zip(group.tolist(), bcs))]
    return Pool(names=names, bcs=bcs, group=group.astype(np.int64), r1=r1,
                r2=r2, left=left, rev=np.stack([rev1, ~rev1], axis=1),
                em_repeat=em_rep, qual=str(reads["qual"]),
                platform=platform, bc_val=bc_val[pair_bc])


def write_pair_fastqs(pool: Pool, path1: str, path2: str) -> None:
    """Barcode-sorted paired FASTQs as ``align -1/-2 -p <platform>`` reads
    them: each header in the platform's form (``HEADS``)."""
    q1 = pool.qual * pool.r1.shape[1]
    q2 = pool.qual * pool.r2.shape[1]
    s1 = ASCII[pool.r1]
    s2 = ASCII[pool.r2]
    form = HEADS[pool.platform]
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for k in range(pool.n):
            head = form.format(name=pool.names[k], bc=pool.bcs[k])
            f1.write(f"{head}{s1[k].tobytes().decode()}\n+\n{q1}\n")
            f2.write(f"{head}{s2[k].tobytes().decode()}\n+\n{q2}\n")


def write_interleaved_fastq(rng, pool: Pool, path: str,
                            spacer: int) -> None:
    """The interleaved FASTQ that ``count`` and ``preproc`` read: mate 1
    is the 16 bp barcode, ``spacer`` bases that preproc trims, then the
    read (10x Chromium Genome, EMA README)."""
    sp = ASCII[rng.integers(0, 4, (pool.n, spacer))]
    s1 = ASCII[pool.r1]
    s2 = ASCII[pool.r2]
    q1 = pool.qual * (pool.r1.shape[1] + spacer + len(pool.bcs[0]))
    q2 = pool.qual * pool.r2.shape[1]
    with open(path, "w") as f:
        for k in range(pool.n):
            name = pool.names[k]
            f.write(f"@{name}\n{pool.bcs[k]}{sp[k].tobytes().decode()}"
                    f"{s1[k].tobytes().decode()}\n+\n{q1}\n"
                    f"@{name}\n{s2[k].tobytes().decode()}\n+\n{q2}\n")


def write_whitelist(rng, pool: Pool, path: str, decoys: int) -> None:
    """The pool's barcodes and ``decoys`` random others, shuffled."""
    wl = sorted(set(pool.bcs))
    bl = len(wl[0])
    extra = ["".join("ACGT"[c] for c in row)
             for row in rng.integers(0, 4, (decoys, bl)).tolist()]
    allbc = np.asarray(sorted(set(wl) | set(extra)))
    rng.shuffle(allbc)
    with open(path, "w") as f:
        f.write("\n".join(allbc.tolist()) + "\n")
