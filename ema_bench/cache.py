"""The reference genome of a configuration and the port's index of it,
kept under ``ema_bench/cache/`` in the checkout (its ``.gitignore``
lists it).

A configuration's genome is fixed by its own ``genome.seed``, so one
build serves every run of every configuration with the same genome
section; the directory is keyed by that section and a hash of the
port's sources that build the index (``index/``,
``native/ema_native.cpp``, ``preproc/``), so a change to them builds
anew and never reuses a stale copy.  A directory is used only once its
``complete`` marker is written, after its files reached the disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from ema_bench import generate

PORT_SOURCES = ("index", "native/ema_native.cpp", "preproc")


def source_hash(port_root: str) -> str:
    """sha256 over the port's index-building sources, path and bytes."""
    h = hashlib.sha256()
    for rel in PORT_SOURCES:
        p = os.path.join(port_root, rel)
        files = [p] if os.path.isfile(p) else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(p) for f in fs
            if f.endswith((".py", ".cpp", ".h")))
        for f in files:
            h.update(os.path.relpath(f, port_root).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def key(config: dict, port_root: str) -> str:
    """The cache key of a configuration's genome section."""
    h = hashlib.sha256(json.dumps(config["genome"], sort_keys=True).encode())
    h.update(source_hash(port_root).encode())
    return h.hexdigest()[:16]


def write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    width = 80
    n = codes.shape[0]
    full = n // width * width
    body = generate.ASCII[codes[:full]].reshape(-1, width)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        nl = np.full((body.shape[0], 1), ord("\n"), np.uint8)
        f.write(np.concatenate([body, nl], axis=1).tobytes())
        if full < n:
            f.write(generate.ASCII[codes[full:]].tobytes() + b"\n")


class Reference:
    """Paths of a built configuration: ``fasta`` (with the port's index
    beside it, ``fasta + '.emaidx.npz'``), ``genome`` and ``repeats``
    (the generator's own arrays, which the plain reference reads)."""

    def __init__(self, d: str):
        self.dir = d
        self.fasta = os.path.join(d, "ref.fa")
        self.index = self.fasta + ".emaidx.npz"
        self.genome = os.path.join(d, "genome.npy")
        self.repeats = os.path.join(d, "repeats.npy")


def ensure(config: dict, port_root: str, cache_dir: str,
           log) -> Reference:
    """The configuration's built reference, built first where missing:
    the genome by ``generate.make_genome``, the index by the port's own
    ``build_index``.  An unfinished build is started again."""
    d = os.path.join(cache_dir, "genome@" + key(config, port_root))
    ref = Reference(d)
    if os.path.exists(os.path.join(d, "complete")):
        return ref
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    from ema_tpu_torch.index import build_index
    codes, repeats = generate.make_genome(config["genome"])
    np.save(ref.genome, codes)
    np.save(ref.repeats, repeats)
    contig = config["genome"]["contig"]
    write_fasta(ref.fasta, contig, codes)
    log(f"building the index of {codes.shape[0]} bp for {config['name']}")
    build_index({contig: codes}).save(ref.index)
    # the files on disk before any window: no write-back under it
    os.sync()
    with open(os.path.join(d, "complete"), "w") as f:
        f.write("ok\n")
    return ref
