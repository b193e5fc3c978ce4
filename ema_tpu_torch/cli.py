"""Command line of the port: the modes of ema_tpu/cli.py, with ``align``
on a torch device.

    python -m ema_tpu_torch.cli count   -w wl.txt -o prefix [-p] < inter.fq
    python -m ema_tpu_torch.cli preproc -w wl.txt -o outdir [-n N] [-h] [-b]
        [-t T] [-p] [--coordinator H:P --nprocs N --procid I]
        prefix.ema-ncnt... < inter.fq
    python -m ema_tpu_torch.cli index   -r ref.fa [-o OUT] [--shard-bases N]
        [-j N] [--from-bwa]
    python -m ema_tpu_torch.cli align   -r ref.fa [--device cuda|cpu]
        (-s bucket | -1 r1.fq [-2 r2.fq] | -x bucket...) [-o out.sam]
        [-R RG] [-p platform] [-d] [-i idx] [-t T] [-j N] [--no-coalesce]
        [--manifest run.jsonl] [--sort] [--shard S --nshards N] [--nobc]
        [--profile DIR] [--device-em] [--seeding greedy|smem]
        [--coordinator H:P --nprocs N --procid I]
    python -m ema_tpu_torch.cli samdiff a.sam b.sam [--pos-tol N]
        [--fail-under PCT]
    python -m ema_tpu_torch.cli help

``align`` follows ema_tpu/cli.py:288-561: ``-x`` coalesces small buckets
into shared batches (``--no-coalesce -j N`` aligns buckets on N threads
instead),
with per-bucket MI namespaces, parts written atomically under
``<out>.parts``, ``--manifest`` resume, ``--sort`` (per-part sort and a
streaming merge) and ``--shard/--nshards``; a contig-sharded index runs
on a ``ShardedAligner``.  ``--device`` defaults to ``cuda``, which runs
the CUDA kernels and exits 1 if there is no card; ``--device cpu`` runs
their plain PyTorch versions.  ``--profile DIR`` writes a
torch.profiler trace, EMA_TPU_STAGE_TIMERS=1 publishes the stage timers,
and EMA_TPU_SEED_IMPL and EMA_TPU_SW_IMPL choose where greedy seeding and
locate run and which SW kernel scores.  ``count``, ``preproc``,
``index`` and ``samdiff`` follow ema_tpu/cli.py:171-286 on the port's own
host modules.

Multi-host runs (ema_tpu/cli.py:200-227, 314-321, 385-396): with
``--coordinator host:port --nprocs N --procid I`` each process joins a
``torch.distributed`` group over gloo (``parallel/distrib.
init_distributed``).  ``preproc`` then sums the barcode priors and read
totals across the processes and writes its buckets under
``<out>/host<I>``; ``align -x`` takes ``--shard/--nshards`` from the
topology and writes ``<out>.shard<I>of<N>``.  Without ``--coordinator``,
``--nprocs`` and ``--procid`` are ignored, as in the JAX package.  The
processes may share one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time

from ema_tpu_torch import config
from ema_tpu_torch import __version__


def _index_path(ref: str) -> str:
    return ref + ".emaidx.npz"


def _sharded_index_path(ref: str) -> str:
    return ref + ".emaidx.d"


def _load_or_build_index(ref: str):
    """The index saved beside ``ref`` (single or sharded), rebuilt and
    saved if it is missing or unreadable (ema_tpu/cli.py:32-68).  The
    files are the JAX package's: either package loads the other's."""
    from ema_tpu_torch.index import (MAX_SHARD_BASES, ReferenceIndex,
                                     ShardedIndex, build_and_save_sharded,
                                     build_index)
    from ema_tpu_torch.index.build import parse_fasta
    p = _index_path(ref)
    if os.path.exists(p):
        try:
            return ReferenceIndex.load(p)
        except Exception as e:      # stale format / truncated artifact
            sys.stderr.write(f"ema_tpu_torch: unusable index at {p} "
                             f"({e!r}); rebuilding\n")
            os.unlink(p)
    pd = _sharded_index_path(ref)
    if os.path.isdir(pd):
        try:
            idx = ShardedIndex.load(pd)
            if idx.n_shards == 0:
                raise ValueError("no shard files")
            return idx
        except Exception as e:
            sys.stderr.write(f"ema_tpu_torch: unusable index at {pd} "
                             f"({e!r}); rebuilding\n")
            shutil.rmtree(pd)
    sys.stderr.write(f"ema_tpu_torch: building index for {ref}...\n")
    contigs = parse_fasta(ref)
    total = sum(a.shape[0] for a in contigs.values())
    if total > MAX_SHARD_BASES:      # ~1 Gbp/shard cap, e.g. full GRCh38
        # n_workers=1: align may already hold a CUDA context and worker
        # threads, which fork() must not copy; run `index -r ref -j N`
        # beforehand for the parallel build
        idx = build_and_save_sharded(contigs, pd, n_workers=1)
    else:
        idx = build_index(contigs)
        idx.save(p)
    return idx


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


def _mi_shift(n_inputs: int) -> int:
    """Width of each -x bucket's MI namespace (ema_tpu/cli.py:488-490):
    the largest base, (n - 1) << shift, still fits SAM's int32 'i' tag
    (500 buckets -> 2^22 clouds each; 1000 -> 2^21)."""
    return max(31 - max(n_inputs - 1, 1).bit_length(), 10)


def _add_multi_host_args(ap, implies: str = "") -> None:
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: address host:port of process 0, "
                         "which the processes join over gloo" + implies)
    ap.add_argument("--nprocs", type=int, default=None,
                    help="multi-host: total number of processes")
    ap.add_argument("--procid", type=int, default=None,
                    help="multi-host: this process's id (0-based)")


def _run_coalesced_buckets(aligner, inputs, ns_of, mi_shift, part_path,
                           man, sort, chrom_names, is_hap, bc_len, met,
                           batch_size, do_bucket) -> None:
    """-x: align many small bucket files per batch (ema_tpu/cli.py:71-156).

    Whole buckets are read until about 4 chunks of pairs accumulate and
    aligned as one bc-sorted batch; each barcode group's lines go back to
    its bucket's part file.  A bucket's groups are whole and visited in
    bc order, so its MI ids (``ns_of[p] << mi_shift`` plus a per-bucket
    counter) do not depend on which buckets share the batch.  Buckets
    sharing a barcode (never true of preproc output) take the per-bucket
    path, keeping the reference's separate-group semantics.
    """
    from ema_tpu_torch import io as io_mod
    from ema_tpu_torch.core.batch import ReadBatch
    from ema_tpu_torch.parallel.distrib import sort_sam_lines

    todo = [p for p in inputs
            if not (man is not None and man.is_done(p)
                    and os.path.exists(part_path(p)))]
    target = 4 * max(batch_size, 1)
    i = 0
    while i < len(todo):
        t0 = time.time()
        group = []
        pairs_n = 0
        while i < len(todo) and (not group or pairs_n < target):
            rows = io_mod.read_special_rows(todo[i], is_hap, bc_len)
            group.append((todo[i], rows))
            pairs_n += len(rows[0])
            i += 1

        bc2bucket = {}
        conflict = False
        for p, rows in group:
            for b in set(rows[1]):
                if bc2bucket.setdefault(b, p) != p:
                    conflict = True
        if conflict:
            for p, _ in group:
                do_bucket(p)
            continue

        ids, bcs, s1, q1, s2, q2 = [], [], [], [], [], []
        for p, rows in group:
            ids += rows[0]
            bcs += rows[1]
            s1 += rows[2]
            q1 += rows[3]
            s2 += rows[4]
            q2 += rows[5]
        batch = ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)

        counters: dict = {}

        def alloc(bc, n_clouds):
            p = bc2bucket[bc]
            base = (ns_of[p] << mi_shift) + counters.get(p, 0)
            counters[p] = counters.get(p, 0) + n_clouds
            return base

        buf = {p: [] for p, _ in group}

        def sink(bc, glines):
            buf[bc2bucket[bc]].extend(glines)

        with met.stage("align", len(ids)):
            for _ in aligner.iter_batch_sam(batch, alloc, sink):
                pass
        dt = time.time() - t0
        for p, _ in group:
            body = buf[p]
            if sort:
                body = sort_sam_lines(body, chrom_names)
            pp = part_path(p)
            with open(pp + ".tmp", "w") as fh:
                fh.writelines(body)
            os.replace(pp + ".tmp", pp)
            if man is not None:
                man.mark_done(p, pp, len(body), dt / len(group))


def _align(rest) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch align")
    ap.add_argument("-r", dest="ref", required=True)
    ap.add_argument("-1", dest="fq1")
    ap.add_argument("-2", dest="fq2")
    ap.add_argument("-s", dest="fqx")
    ap.add_argument("-x", dest="multi", action="store_true")
    ap.add_argument("-o", dest="out")
    ap.add_argument("-R", dest="rg")
    ap.add_argument("-d", dest="dens", action="store_true")
    ap.add_argument("-p", dest="platform", default="10x")
    ap.add_argument("-i", dest="bx_index", default="1")
    ap.add_argument("-t", dest="threads", type=int, default=None,
                    help="in-flight chunks (1 disables overlap)")
    ap.add_argument("-j", dest="jobs", type=int, default=2,
                    help="concurrent bucket files with -x --no-coalesce "
                         "(the reference runs one OpenMP thread per input "
                         "file, main.c:396-406)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="-x: align each bucket file in its own batches "
                         "instead of coalescing small buckets")
    _add_multi_host_args(ap, " (implies --shard/--nshards from the "
                             "process topology)")
    ap.add_argument("--shard", type=int, default=None,
                    help="this host's shard id (0-based)")
    ap.add_argument("--nshards", type=int, default=None,
                    help="total hosts; buckets are hashed across them")
    ap.add_argument("--manifest", default=None,
                    help="JSONL progress manifest; completed buckets are "
                         "skipped on resume (-x mode)")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace to this directory")
    ap.add_argument("--sort", action="store_true",
                    help="coordinate-sort the output SAM body")
    ap.add_argument("--nobc", action="store_true",
                    help="no-barcode mode: plain paired alignment, no "
                         "linked-read tags")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default; exits 1 where "
                         "there is no card), cuda:N or cpu")
    ap.add_argument("--device-em", action="store_true",
                    help="run the cloud-EM iterations on the device")
    ap.add_argument("--seeding", choices=("greedy", "smem"), default=None,
                    help="seed finder: greedy maximal-suffix chop (on the "
                         "device or the host, see EMA_TPU_SEED_IMPL) or "
                         "exact SMEM enumeration with BWA re-seeding in "
                         "host C++ (smem, the default)")
    ap.add_argument("inputs", nargs="*")
    a = ap.parse_args(rest)

    n_modes = int(a.multi) + int(a.fqx is not None) + \
        int(a.fq1 is not None or a.fq2 is not None)
    if n_modes != 1:
        sys.stderr.write(
            "error: must specify *exactly one* of -1/-2, -s or -x\n")
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

    from ema_tpu_torch.utils.backend import resolve_device
    try:
        device = resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"error: {e}\n")
        return 1

    if a.coordinator is not None:
        # multi-host -x: one process per host; bucket shards default to
        # the process topology (buckets over hosts, batches over the
        # host's devices)
        from ema_tpu_torch.parallel.distrib import (init_distributed,
                                                    shard_path)
        try:
            pid, pcount = init_distributed(a.coordinator, a.nprocs,
                                           a.procid)
        except ValueError as e:
            sys.stderr.write(f"error: {e}\n")
            return 1
        if a.nshards is None:
            a.shard, a.nshards = pid, pcount
        if a.out and a.nshards > 1:
            a.out = shard_path(a.out, a.shard or 0, a.nshards)

    from ema_tpu_torch.core.samout import write_sam_header
    from ema_tpu_torch.index import ShardedIndex
    from ema_tpu_torch.utils.metrics import Metrics
    from ema_tpu_torch import io as io_mod
    from ema_tpu_torch.core.pipeline import Aligner, ShardedAligner
    from ema_tpu_torch.parallel.distrib import sort_sam_lines
    from ema_tpu_torch.utils.metrics import device_trace

    met = Metrics()
    with met.stage("index_load"):
        idx = _load_or_build_index(a.ref)
    aligner_params = config.DEFAULT_ALIGNER_PARAMS
    if a.seeding:
        aligner_params = dataclasses.replace(aligner_params,
                                             seeding=a.seeding)
    cfg = config.RunConfig(platform=profile, read_group=rg,
                           bx_index=a.bx_index, aligner=aligner_params,
                           apply_density_opt=a.dens,
                           inflight_chunks=(max(a.threads, 1)
                                            if a.threads else None),
                           device_em=True if a.device_em else None,
                           nobc=a.nobc)
    if isinstance(idx, ShardedIndex):
        aligner = ShardedAligner(idx, cfg, device=device)
    else:
        aligner = Aligner(idx, cfg, device=device)
    if os.environ.get("EMA_TPU_STAGE_TIMERS") == "1":
        aligner.metrics = met      # publish the host/device split
    header = write_sam_header(idx.names, idx.lengths, rg, __version__,
                              "ema_tpu_torch align " + " ".join(rest))
    is_hap = profile.name == "haplotag"
    # bc_len 0 (tru/cpt) stays 0: BX decodes to '' -> 'BX:Z:-1', the
    # reference's own output for these platforms
    bc_len = profile.bc_len
    pair_platform = "none" if a.nobc else profile.name

    def align_one_input(path_or_pair, out_fh, cloud_base=None) -> int:
        n = 0
        if path_or_pair[0] == "pair" and not a.sort:
            # streaming -1/-2: whole barcode groups flow from disk through
            # bounded flush batches straight to the writer
            groups = io_mod.iter_fastq_pair_groups(
                path_or_pair[1], path_or_pair[2], pair_platform)
            with met.stage("align"):
                for lines in aligner.align_stream(groups):
                    out_fh.writelines(lines)
                    n += len(lines)
            return n
        with met.stage("read_input"):
            if path_or_pair[0] == "special":
                batch = io_mod.read_special_fastq(path_or_pair[1], is_hap,
                                                  bc_len)
            else:
                batch = io_mod.read_fastq_pair(
                    path_or_pair[1], path_or_pair[2], pair_platform)
        with met.stage("align", len(batch.ids)):
            lines = aligner.align_batch_to_sam(batch, cloud_base)
        if a.sort:
            # -x: per-part sort, so the final pass is a streaming k-way
            # merge instead of an in-memory global sort
            lines = sort_sam_lines(lines, idx.names)
        with met.stage("write_output"):
            out_fh.writelines(lines)
        return len(lines)

    with device_trace(a.profile, device):
        if a.multi:
            _align_buckets(a, aligner, idx, header, met, align_one_input,
                           is_hap, bc_len)
        else:
            out = open(a.out, "w") if a.out else sys.stdout
            try:
                out.write(header)
                if a.fqx:
                    align_one_input(("special", a.fqx), out)
                else:
                    align_one_input(("pair", a.fq1, a.fq2), out)
            finally:
                if a.out:
                    out.close()
    met.report()
    return 0


def _align_buckets(a, aligner, idx, header, met, align_one_input, is_hap,
                   bc_len) -> None:
    """-x: many buckets; shard across hosts, track progress, write
    per-bucket parts, concatenate (or merge, with --sort) at the end
    (ema_tpu/cli.py:475-550)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ema_tpu_torch.utils.manifest import RunManifest
    from ema_tpu_torch.parallel.distrib import (buckets_for_host,
                                                merge_sorted_streams)

    inputs = list(a.inputs)
    # deterministic per-bucket MI namespaces, keyed by the bucket's
    # position in the *full* input list, so ids stay unique across host
    # shards and byte-identical on resume
    ns_of = {p: i for i, p in enumerate(inputs)}
    mi_shift = _mi_shift(len(inputs))
    if a.nshards:
        inputs = buckets_for_host(inputs, a.shard or 0, a.nshards)
    man = RunManifest(a.manifest) if a.manifest else None
    parts_dir = (a.out or "ema_out.sam") + ".parts"
    os.makedirs(parts_dir, exist_ok=True)
    man_lock = threading.Lock()

    def part_path(p: str) -> str:
        return os.path.join(parts_dir, os.path.basename(p) + ".sam")

    def do_bucket(p: str) -> str:
        part = part_path(p)
        with man_lock:
            done = (man is not None and man.is_done(p)
                    and os.path.exists(part))
        if done:
            return part
        t0 = time.time()
        with open(part + ".tmp", "w") as fh:
            n = align_one_input(("special", p), fh,
                                cloud_base=ns_of[p] << mi_shift)
        os.replace(part + ".tmp", part)
        if man is not None:
            with man_lock:
                man.mark_done(p, part, n, time.time() - t0)
        return part

    parts = [part_path(p) for p in inputs]
    if a.no_coalesce or len(inputs) <= 1:
        jobs = max(1, min(a.jobs, len(inputs) or 1))
        if jobs == 1:
            for p in inputs:
                do_bucket(p)
        else:
            with ThreadPoolExecutor(max_workers=jobs) as bx:
                list(bx.map(do_bucket, inputs))
    else:
        _run_coalesced_buckets(
            aligner, inputs, ns_of, mi_shift, part_path, man, a.sort,
            idx.names, is_hap, bc_len, met, aligner.cfg.batch_size,
            do_bucket)
    out = open(a.out, "w") if a.out else sys.stdout
    try:
        if a.sort:
            # streaming k-way merge of the parts, sorted when written
            merge_sorted_streams(out, parts, idx.names, header)
        else:
            out.write(header)
            for part in parts:
                with open(part) as fh:
                    out.writelines(fh)
    finally:
        if a.out:
            out.close()


def _count(rest) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch count", add_help=False)
    ap.add_argument("-w", dest="wl")
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("-p", dest="haplotag", action="store_true")
    a = ap.parse_args(rest)
    if not a.wl and not a.haplotag:
        sys.stderr.write("error: specify barcode whitelist with -w\n")
        return 1
    from ema_tpu_torch.preproc.count import count
    stats = count(a.wl, a.out, sys.stdin.buffer, is_haplotag=a.haplotag)
    sys.stderr.write(f":: Reads with OK barcode: {stats['nice']} out of "
                     f"{stats['total']}\n:: Ignored {stats['ignored']} "
                     "reads\n")
    return 0


def _preproc(rest) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch preproc",
                                 add_help=False)
    ap.add_argument("-w", dest="wl")
    ap.add_argument("-n", dest="nbuckets", type=int, default=500)
    ap.add_argument("-h", dest="h2", action="store_true")
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("-b", dest="bx", action="store_true")
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("-p", dest="haplotag", action="store_true")
    _add_multi_host_args(ap)
    ap.add_argument("inputs", nargs="*")
    a = ap.parse_args(rest)
    if not a.wl and not a.haplotag:
        sys.stderr.write("error: specify barcode whitelist with -w\n")
        return 1
    if not a.inputs:
        sys.stderr.write("warning: no input files specified; "
                         "nothing to do\n")
        return 0
    distributed = a.coordinator is not None
    out_dir = a.out
    if distributed:
        # one process per host; each host streams its own FASTQ chunk and
        # local count outputs, sums the priors and totals across the
        # processes so that bucket routing is globally consistent, and
        # writes its bucket files under a per-host subdirectory
        # (concatenating the host files of one bucket index yields the
        # exact logical bucket of a single-process run)
        from ema_tpu_torch.parallel.distrib import init_distributed
        try:
            pid, _ = init_distributed(a.coordinator, a.nprocs, a.procid)
        except ValueError as e:
            sys.stderr.write(f"error: {e}\n")
            return 1
        out_dir = os.path.join(a.out, f"host{pid:02d}")
    from ema_tpu_torch.preproc.correct import correct
    stats = correct(a.wl, a.inputs, out_dir, sys.stdin.buffer,
                    do_h2=a.h2, do_bx_format=a.bx,
                    n_buckets=a.nbuckets, is_haplotag=a.haplotag,
                    n_threads=max(a.threads, 1),
                    distributed=distributed)
    sys.stderr.write(
        f":: Stats: no change: {stats['nochange']}\n"
        f"         no barcode: {stats['nobucket']}\n"
        f"       H1-corrected: {stats['h1']}\n"
        f"       H2-corrected: {stats['h2']}\n")
    return 0


def _index(rest) -> int:
    ap = argparse.ArgumentParser(prog="ema_tpu_torch index", add_help=False)
    ap.add_argument("-r", dest="ref", required=True)
    ap.add_argument("-o", dest="out")
    ap.add_argument("--shard-bases", type=int, default=None,
                    help="force contig-sharded indexing with this shard "
                         "size (auto beyond ~2^30 bases: both strands of a "
                         "shard must fit int32 rows)")
    ap.add_argument("-j", dest="workers", type=int, default=None,
                    help="parallel shard-build processes (default: one "
                         "per shard up to cpu count)")
    ap.add_argument("--from-bwa", action="store_true",
                    help="build from an existing `bwa index` "
                         "(<ref>.pac/.ann/.amb) instead of parsing the "
                         "FASTA (reference: bwa_idx_load, bwabridge.c:79)")
    a = ap.parse_args(rest)
    from ema_tpu_torch.index import (MAX_SHARD_BASES, build_and_save_sharded,
                                     build_index)
    from ema_tpu_torch.index.build import parse_fasta
    if a.from_bwa:
        from ema_tpu_torch.index.bwa_import import (import_bwa_index,
                                                    load_bwa_contigs)
        if (os.path.exists(a.ref + ".bwt") and os.path.exists(a.ref + ".sa")
                and not a.shard_bases):
            # complete BWA index present: consume the prebuilt FM-index
            # directly, with no suffix-array construction (bwa_idx_load
            # semantics, bwabridge.c:77-96)
            import_bwa_index(a.ref).save(a.out or _index_path(a.ref))
            return 0
        contigs = load_bwa_contigs(a.ref)
    else:
        contigs = parse_fasta(a.ref)
    total = sum(arr.shape[0] for arr in contigs.values())
    if a.shard_bases or total > MAX_SHARD_BASES:
        build_and_save_sharded(
            contigs, a.out or _sharded_index_path(a.ref),
            max_shard_bases=a.shard_bases or MAX_SHARD_BASES,
            n_workers=a.workers)
    else:
        build_index(contigs).save(a.out or _index_path(a.ref))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    mode, rest = argv[0], argv[1:]
    if mode == "align":
        return _align(rest)
    if mode == "count":
        return _count(rest)
    if mode == "preproc":
        return _preproc(rest)
    if mode == "index":
        return _index(rest)
    if mode == "samdiff":
        from ema_tpu_torch.utils.samdiff import main as samdiff_main
        return samdiff_main(rest)
    sys.stderr.write(f"error: unrecognized mode {mode!r} (count, preproc, "
                     "index, align, samdiff, help)\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
