"""Synthetic linked-read simulator for the port's smoke run and tools: a
copy of tests/simulate.py on the port's own barcode codec, with the same
rng sequence, so the same seed gives the same world."""

import numpy as np

BASES = "ACGT"


def rand_genome(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def to_str(codes):
    return "".join(BASES[c] for c in codes)


def revcomp_str(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp[c] for c in reversed(s))


def mutate(rng, s, rate):
    out = list(s)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = BASES[int(rng.integers(0, 4))]
    return "".join(out)


def simulate_pairs(rng, genome_str, n_barcodes=4, frags_per_bc=(1, 3),
                   pairs_per_frag=(8, 20), frag_len=20_000,
                   read_len=100, err=0.003, bc_len=16):
    """Returns (ids, bc_strs, bcs, s1, q1, s2, q2, truth).

    truth: per pair dict(pos1, pos2) of 1-based expected positions.
    Fully vectorized (supports 100k+ pairs for benchmarks).
    """
    from ema_tpu_torch.utils.barcodes import encode_bc_default

    G = len(genome_str)
    codes = np.frombuffer(genome_str.encode(), np.uint8)
    code_lut = np.full(256, 0, np.uint8)
    for i, c in enumerate(BASES):
        code_lut[ord(c)] = i
    gcodes = code_lut[codes]

    # per-barcode fragment counts, per-fragment pair counts
    n_frags = rng.integers(*frags_per_bc, n_barcodes)
    total_frags = int(n_frags.sum())
    frag_bc = np.repeat(np.arange(n_barcodes), n_frags)
    frag_start = rng.integers(0, max(1, G - frag_len), total_frags)
    n_pairs = rng.integers(*pairs_per_frag, total_frags)
    P = int(n_pairs.sum())
    pair_frag = np.repeat(np.arange(total_frags), n_pairs)

    insert = rng.integers(read_len + 20, 400, P)
    fs = frag_start[pair_frag]
    hi = np.minimum(fs + frag_len, G) - insert - 1
    p = (fs + (rng.random(P) * np.maximum(hi - fs, 1)).astype(np.int64))
    qpos = p + insert - read_len

    t = np.arange(read_len)
    r1c = gcodes[p[:, None] + t[None, :]]
    r2c = (3 - gcodes[qpos[:, None] + t[None, :]])[:, ::-1]
    for rc in (r1c, r2c):
        mut = rng.random((P, read_len)) < err
        rc[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)

    ascii_lut = np.frombuffer(b"ACGT", np.uint8)
    r1b = ascii_lut[r1c]
    r2b = ascii_lut[r2c]

    bc_codes = rng.integers(0, 4, (n_barcodes, bc_len))
    bc_strs_uniq = ["".join(BASES[c] for c in row) for row in bc_codes]
    bcs_uniq = [encode_bc_default(b) for b in bc_strs_uniq]
    pair_bc = frag_bc[pair_frag]

    qual = "I" * read_len
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = [], [], [], [], [], [], [], []
    for i in range(P):
        b = int(pair_bc[i])
        ids.append(f"sim{i}")
        bcs.append(bcs_uniq[b])
        bc_strs.append(bc_strs_uniq[b])
        s1.append(r1b[i].tobytes().decode())
        s2.append(r2b[i].tobytes().decode())
        q1.append(qual)
        q2.append(qual)
        truth.append({"pos1": int(p[i]) + 1, "pos2": int(qpos[i]) + 1,
                      "bc": bc_strs_uniq[b]})
    return ids, bc_strs, bcs, s1, q1, s2, q2, truth


def parse_sam_line(line):
    f = line.rstrip("\n").split("\t")
    d = {
        "qname": f[0], "flag": int(f[1]), "rname": f[2], "pos": int(f[3]),
        "mapq": int(f[4]), "cigar": f[5], "rnext": f[6], "pnext": int(f[7]),
        "tlen": int(f[8]), "seq": f[9], "qual": f[10], "tags": {},
    }
    for t in f[11:]:
        k, typ, v = t.split(":", 2)
        d["tags"][k] = v
    return d
