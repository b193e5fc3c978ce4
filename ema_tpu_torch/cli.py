"""Command line of the port: ``align`` on a torch device, and ``index``.

    python -m ema_tpu_torch.cli align -r ref.fa --device cuda
        (-s bucket | -1 r1.fq [-2 r2.fq]) [-o out.sam] [-R RG]
        [-p platform] [-d] [-t T] [--device-em] [--seeding greedy|smem]
    python -m ema_tpu_torch.cli index -r ref.fa [-o ref.fa.emaidx.npz]

``align`` follows ema_tpu/cli.py:288-472 and reuses its jax-free
``_load_or_build_index``; ``index`` delegates to ``ema_tpu.cli``.  The
device is always named: ``--device cuda`` runs the SW kernel on the GPU
and fails if there is none; ``--device cpu`` runs the plain PyTorch
version.  ``--device-em`` runs the cloud EM on the device and
``--seeding`` picks the seed finder, as in ema_tpu/cli.py:333-339;
EMA_TPU_SEED_IMPL and EMA_TPU_SW_IMPL choose where greedy seeding and
locate run and which SW kernel scores.  The other ``ema_tpu`` modes and
align options (-x, sharding, manifests, --sort, profiling) are not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ema_tpu import config
from ema_tpu_torch import __version__


def _unescape_rg(rg: str) -> str:
    """Unescape \\t \\n \\r \\\\ in -R, single pass left-to-right
    (reference util.c escape(), util.c:97-118; ema_tpu/cli.py:359-373)."""
    out, i = [], 0
    while i < len(rg):
        c = rg[i]
        if c == "\\" and i + 1 < len(rg):
            rep = {"t": "\t", "n": "\n", "r": "\r",
                   "\\": "\\"}.get(rg[i + 1])
            if rep is not None:
                out.append(rep)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _align(rest) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch align")
    ap.add_argument("-r", dest="ref", required=True)
    ap.add_argument("-1", dest="fq1")
    ap.add_argument("-2", dest="fq2")
    ap.add_argument("-s", dest="fqx")
    ap.add_argument("-o", dest="out")
    ap.add_argument("-R", dest="rg")
    ap.add_argument("-d", dest="dens", action="store_true")
    ap.add_argument("-p", dest="platform", default="10x")
    ap.add_argument("-t", dest="threads", type=int, default=None,
                    help="in-flight chunks (1 disables overlap)")
    ap.add_argument("--device", required=True,
                    help="torch device: cuda, cuda:N or cpu")
    ap.add_argument("--device-em", action="store_true",
                    help="run the cloud-EM iterations on the device")
    ap.add_argument("--seeding", choices=("greedy", "smem"), default=None,
                    help="seed finder: greedy maximal-suffix chop (on the "
                         "device or the host, see EMA_TPU_SEED_IMPL) or "
                         "exact SMEM enumeration with BWA re-seeding in "
                         "host C++ (smem, the default)")
    a = ap.parse_args(rest)

    if (a.fqx is not None) == (a.fq1 is not None or a.fq2 is not None):
        sys.stderr.write("error: must specify *exactly one* of -1/-2 or "
                         "-s\n")
        return 1
    if a.fq1 is None and a.fq2 is not None:
        sys.stderr.write("error: cannot specify -2 without -1\n")
        return 1
    rg = _unescape_rg(a.rg) if a.rg else "@RG\tID:rg1\tSM:sample1"
    if not rg.startswith("@RG\t") or "\tID:" not in rg:
        sys.stderr.write(f"error: malformed read group: '{rg}'\n")
        return 1
    try:
        profile = config.get_platform_profile(a.platform)
    except ValueError:
        sys.stderr.write(f"error: invalid platform name: '{a.platform}'\n")
        return 1

    from ema_tpu.cli import _load_or_build_index
    from ema_tpu.core.samout import write_sam_header
    from ema_tpu.index import ShardedIndex
    from ema_tpu.utils.metrics import Metrics
    from ema_tpu_torch import io as io_mod
    from ema_tpu_torch.core.pipeline import Aligner

    met = Metrics()
    with met.stage("index_load"):
        idx = _load_or_build_index(a.ref)
    if isinstance(idx, ShardedIndex):
        sys.stderr.write("error: contig-sharded indexes are not ported "
                         "yet\n")
        return 1
    aligner_params = config.DEFAULT_ALIGNER_PARAMS
    if a.seeding:
        aligner_params = dataclasses.replace(aligner_params,
                                             seeding=a.seeding)
    cfg = config.RunConfig(platform=profile, read_group=rg,
                           aligner=aligner_params,
                           apply_density_opt=a.dens,
                           inflight_chunks=(max(a.threads, 1)
                                            if a.threads else None),
                           device_em=True if a.device_em else None)
    aligner = Aligner(idx, cfg, device=a.device)
    header = write_sam_header(idx.names, idx.lengths, rg, __version__,
                              "ema_tpu_torch align " + " ".join(rest))
    out = open(a.out, "w") if a.out else sys.stdout
    try:
        out.write(header)
        if a.fqx:
            with met.stage("read_input"):
                batch = io_mod.read_special_fastq(
                    a.fqx, profile.name == "haplotag", profile.bc_len)
            with met.stage("align", len(batch.ids)):
                lines = aligner.align_batch_to_sam(batch)
            with met.stage("write_output"):
                out.writelines(lines)
        else:
            # streaming -1/-2: whole barcode groups flow from disk through
            # bounded flush batches straight to the writer
            groups = io_mod.iter_fastq_pair_groups(a.fq1, a.fq2,
                                                   profile.name)
            with met.stage("align"):
                for lines in aligner.align_stream(groups):
                    out.writelines(lines)
    finally:
        if a.out:
            out.close()
    met.report()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    mode, rest = argv[0], argv[1:]
    if mode == "align":
        return _align(rest)
    if mode == "index":
        from ema_tpu.cli import main as ema_main
        return ema_main(["index", *rest])
    sys.stderr.write(f"error: mode {mode!r} is not ported (align, index)\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
