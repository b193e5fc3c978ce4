"""BASELINE.md config 5, haplotag align across two processes and merged
sorted SAM, through the port's real CLI: the twin of tools/bench_config5.py.

    python -m ema_tpu_torch.tools.bench_config5 [--device cuda|cpu]
        [--genome BP] [--barcodes N] [--buckets N] [--out FILE]

Haplotag buckets of a simulated world (seed 20260817; 1.5 Mbp, 300
barcodes, ~18k pairs, 8 buckets by default) are aligned once by one
``align -x -p haplotag --sort`` process, then by two such processes
joined by ``--coordinator 127.0.0.1:<port> --nprocs 2`` (a gloo group:
the buckets hashed to the processes by the topology, one sorted shard
each), whose shards ``parallel/distrib.merge_sorted_shards`` merges.  The
merged SAM must be record-equivalent to the single process's (samdiff,
MI as a bijection) before any time is reported.  On a machine with one
card both processes share it, so the two-process wall validates the
multi-process path and measures no scaling; the JSON says so.  Each of
the two takes half the host's cores for torch's CPU threads
(OMP_NUM_THREADS, unless set).  Prints one JSON line; writes a file only
where ``--out`` says.
"""

from __future__ import annotations

import argparse
import glob
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from ema_tpu_torch.tools._common import (add_device_arg, cli_env, emit, log,
                                         open_device, run_cli, write_fasta)

GENOME = 1_500_000
N_BARCODES = 300
N_BUCKETS = 8


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_world(tmp: str, genome_bp: int, n_barcodes: int,
                n_buckets: int) -> tuple:
    """ref.fa and the haplotag buckets under ``tmp``: (fasta, bucket
    paths, pairs)."""
    from ema_tpu_torch.tools import simulate as sim

    rng = np.random.default_rng(20260817)
    gs = sim.to_str(sim.rand_genome(rng, genome_bp))
    ref = os.path.join(tmp, "ref.fa")
    write_fasta(ref, {"chr1": gs})
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim.simulate_pairs(
        rng, gs, n_barcodes=n_barcodes, frags_per_bc=(2, 3),
        pairs_per_frag=(15, 25), frag_len=25_000, read_len=100, err=0.003)
    uniq = sorted(set(bc_strs))
    slot = {b: k for k, b in enumerate(uniq)}
    hts = {}
    for b in uniq:
        a, c, bb, d = rng.integers(1, 97, 4)
        hts[b] = f"A{a:02d}C{c:02d}B{bb:02d}D{d:02d}"
    buckets = [os.path.join(tmp, f"hap-bin-{k:03d}")
               for k in range(n_buckets)]
    handles = [open(p, "w") for p in buckets]
    try:
        for i in range(len(ids)):
            handles[slot[bc_strs[i]] % n_buckets].write(
                f"{hts[bc_strs[i]]} {ids[i]} {s1[i]} {q1[i]} {s2[i]} "
                f"{q2[i]}\n")
    finally:
        for h in handles:
            h.close()
    return ref, buckets, len(ids), len(uniq)


def two_processes(ref: str, buckets, device: str, dirs) -> None:
    """``align -x -p haplotag --sort`` as processes 0 and 1 of one gloo
    group, process i writing its shard under dirs[i]."""
    coord = f"127.0.0.1:{free_port()}"
    # the two share the host's cores: torch's spinning CPU thread pools,
    # each as wide as the host, slowed a small CPU run 20-fold
    env = cli_env()
    env.setdefault("OMP_NUM_THREADS", str(max((os.cpu_count() or 2) // 2,
                                              1)))
    procs = []
    try:
        for i, d in enumerate(dirs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ema_tpu_torch.cli", "align", "-r",
                 ref, "--device", device, "-x", "-p", "haplotag", "--sort",
                 "--coordinator", coord, "--nprocs", "2", "--procid",
                 str(i), "-o", os.path.join(d, "out.sam"), *buckets],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errs = [p.communicate(timeout=1800)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode:
            raise RuntimeError(f"align process {i} failed (exit "
                               f"{p.returncode}):\n{err[-3000:]}")


def run(device: str, card: str, genome_bp: int = GENOME,
        n_barcodes: int = N_BARCODES, n_buckets: int = N_BUCKETS) -> dict:
    from ema_tpu_torch.parallel.distrib import merge_sorted_shards
    from ema_tpu_torch.utils import samdiff

    with tempfile.TemporaryDirectory() as tmp:
        ref, buckets, n_pairs, n_bc = write_world(tmp, genome_bp, n_barcodes,
                                                  n_buckets)
        log(f"world: {n_pairs} haplotag pairs, {n_bc} barcodes, "
            f"{n_buckets} buckets")
        run_cli(["index", "-r", ref])      # both runs load the same index
        single = os.path.join(tmp, "single.sam")
        t_single, _ = run_cli(["align", "-r", ref, "--device", device, "-x",
                               "-p", "haplotag", "--sort", "-o", single,
                               *buckets])
        log(f"single-process sorted align: {t_single:.1f}s")
        dirs = [os.path.join(tmp, f"host{i}") for i in range(2)]
        for d in dirs:
            os.makedirs(d)
        t0 = time.time()
        two_processes(ref, buckets, device, dirs)
        shards = sorted(sum((glob.glob(os.path.join(d, "out.shard*.sam"))
                             for d in dirs), []))
        merged = os.path.join(tmp, "merged.sam")
        with open(single) as f:
            header = "".join(ln for ln in f if ln.startswith("@"))
        merge_sorted_shards(shards, merged, ["chr1"], header=header)
        t_dist = time.time() - t0
        log(f"2-process align + merge: {t_dist:.1f}s ({len(shards)} "
            f"shards)")
        st = samdiff.diff_sams(single, merged)
        log(st.summary())
        if st.only_a or st.only_b or st.concordance() != 1.0:
            raise RuntimeError("config5: the merged two-process SAM is not "
                               "record-equivalent to the single process's")
    return {
        "metric": "config5_haplotag_multihost_align",
        "what": ("BASELINE config 5: haplotag buckets across 2 processes "
                 "of one gloo group (--coordinator), a sorted shard each, "
                 "merged by merge_sorted_shards; the merged SAM asserted "
                 "record-equivalent to the single process's before "
                 "timing"),
        "n_pairs": n_pairs,
        "n_buckets": n_buckets,
        "single_process_s": t_single,
        "two_process_s": t_dist,
        "single_pairs_per_sec": n_pairs / t_single,
        "device": device,
        "card": card,
        "note": ("both processes share one device (the card, or this "
                 "host's CPU): the two-process wall validates the "
                 "multi-process path, not scaling"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.bench_config5",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--barcodes", type=int, default=N_BARCODES)
    ap.add_argument("--buckets", type=int, default=N_BUCKETS)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)
    emit(run(str(dev), card, a.genome, a.barcodes, a.buckets), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
