"""End-to-end drive of the port's CLI on a simulated world: the twin of
tools/verify_drive.py.

    python -m ema_tpu_torch.tools.verify_drive [--device cuda|cpu]
        [--out FILE]

A 400 kbp genome, 40 barcodes of linked-read pairs (seed 20260818), an
interleaved FASTQ (read 1 = 16 bp barcode + 7 bp trim + read) and a
whitelist, then ``count`` -> ``preproc -n 4`` -> ``index`` -> ``align``
of each bucket through ``python -m ema_tpu_torch.cli`` subprocesses, the
aligns on ``--device``.  Every primary record is checked against the
simulation: each pair's two mates present, at least 98% within 5 bp of
the truth and at least 98% proper pairs, and BX, MI and XG on every
record; any miss exits non-zero.  The files go to a temporary directory,
removed after.  Prints the counts on stderr and one JSON line on stdout;
writes a file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ema_tpu_torch.tools._common import (add_device_arg, emit, log,
                                         open_device, run_cli, write_fasta)

MATE1_TRIM = 7


def drive(d: str, device: str) -> dict:
    """The whole drive with its files under ``d``; returns the counts."""
    from ema_tpu_torch.tools import simulate as sim

    rng = np.random.default_rng(20260818)
    genome = sim.to_str(sim.rand_genome(rng, 400_000))
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = sim.simulate_pairs(
        rng, genome, n_barcodes=40, frags_per_bc=(2, 5),
        pairs_per_frag=(8, 20), frag_len=12_000)
    n_pairs = len(ids)
    log(f"simulated {n_pairs} pairs, {len(set(bc_strs))} barcodes")
    ref = os.path.join(d, "ref.fa")
    write_fasta(ref, {"chr1": genome}, width=80)
    wl = os.path.join(d, "wl.txt")
    with open(wl, "w") as f:
        f.writelines(b + "\n" for b in sorted(set(bc_strs)))
    fq = os.path.join(d, "inter.fq")
    with open(fq, "w") as f:
        for i in range(n_pairs):
            r1 = bc_strs[i] + "G" * MATE1_TRIM + s1[i]
            f.write(f"@{ids[i]}\n{r1}\n+\n" + "I" * len(r1) + "\n")
            f.write(f"@{ids[i]}\n{s2[i]}\n+\n" + "I" * len(s2[i]) + "\n")

    t0 = time.time()
    with open(fq, "rb") as fh:
        run_cli(["count", "-w", wl, "-o", os.path.join(d, "cnt")], stdin=fh)
    with open(fq, "rb") as fh:
        run_cli(["preproc", "-w", wl, "-o", os.path.join(d, "bkt"), "-n",
                 "4", "-h", os.path.join(d, "cnt.ema-ncnt")], stdin=fh)
    run_cli(["index", "-r", ref])
    sam_paths = []
    for b in range(4):
        bkt = os.path.join(d, "bkt", f"ema-bin-{b:03d}")
        if not os.path.exists(bkt):
            continue
        out = os.path.join(d, f"out{b}.sam")
        run_cli(["align", "-r", ref, "--device", device, "-s", bkt, "-o",
                 out])
        sam_paths.append(out)
    wall = time.time() - t0

    truth_by_id = {ids[i]: truth[i] for i in range(n_pairs)}
    n_rec = n_at_truth = n_proper = n_primary = missing_tags = 0
    seen = set()
    for sp in sam_paths:
        with open(sp) as f:
            for line in f:
                if line.startswith("@"):
                    continue
                rec = sim.parse_sam_line(line)
                n_rec += 1
                flag = rec["flag"]
                if flag & 0x900:
                    continue
                n_primary += 1
                t = truth_by_id[rec["qname"]]
                want = t["pos1"] if (flag & 0x40) else t["pos2"]
                n_at_truth += abs(rec["pos"] - want) <= 5
                n_proper += bool(flag & 0x2)
                tags = rec["tags"]
                missing_tags += not ("BX" in tags and "MI" in tags
                                     and "XG" in tags)
                seen.add((rec["qname"], flag & 0xC0))
    return dict(n_pairs=n_pairs, records=n_rec, primary=n_primary,
                at_truth=n_at_truth, proper=n_proper,
                missing_tags=missing_tags, mates_seen=len(seen),
                cli_wall_s=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch.tools.verify_drive",
                                 description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev, card = open_device(ap.prog, a.device)
    with tempfile.TemporaryDirectory(prefix="ema_verify_") as d:
        r = drive(d, str(dev))
    log(f"records={r['records']} primary={r['primary']} "
        f"at_truth={r['at_truth']} proper={r['proper']} "
        f"missing_tags={r['missing_tags']}")
    primary = max(r["primary"], 1)
    at, pp = r["at_truth"] / primary, r["proper"] / primary
    faults = []
    if r["primary"] != 2 * r["n_pairs"] or r["mates_seen"] != 2 * r[
            "n_pairs"]:
        faults.append(f"{r['primary']} primary records, {r['mates_seen']} "
                      f"mates for {r['n_pairs']} pairs")
    if at < 0.98:
        faults.append(f"at-truth rate {at:.4f} < 0.98")
    if pp < 0.98:
        faults.append(f"proper-pair rate {pp:.4f} < 0.98")
    if r["missing_tags"]:
        faults.append(f"{r['missing_tags']} records lack BX, MI or XG")
    emit({**r, "at_truth_pct": 100.0 * at, "proper_pct": 100.0 * pp,
          "ok": not faults, "device": str(dev), "card": card}, a.out)
    if faults:
        raise SystemExit("verify_drive: " + "; ".join(faults))
    log(f"VERIFY OK: {at * 100:.2f}% at truth, {pp * 100:.2f}% proper, "
        f"tags complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
