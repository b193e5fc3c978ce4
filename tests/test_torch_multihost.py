"""The port's multi-host layer against the JAX package's single-process
runs, on the CPU (tests/test_multihost.py and tests/test_distrib.py on
the port).

Two OS processes join a ``torch.distributed`` group over gloo on
127.0.0.1, behind chip_smoke.py's import finder (which refuses jax,
jaxlib and ema_tpu), and run the port's distributed ``preproc`` and
``align -x --coordinator``.  The parent asserts that ``allreduce_counts``
sums across the processes, that the per-host bucket files concatenate to
the JAX package's single-process ``correct`` output byte for byte, and
that the two processes' SAM shards hold the JAX package's single-process
``align -x`` records (MI masked, as tests/test_multihost.py:130-150
compares them).  Every comparison is exact.
"""

from __future__ import annotations

import io
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

from ema_tpu import cli as jax_cli
from ema_tpu.preproc import correct as jax_correct
from ema_tpu.preproc import count as jax_count
from ema_tpu_torch.parallel import distrib
from simulate import rand_genome, simulate_pairs, to_str
from test_oracle_preproc import make_dataset, write_wl
from torch_handover import jax_native_built  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    import chip_smoke
    chip_smoke.refuse_reference_imports()
    import numpy as np
    from ema_tpu_torch import cli
    from ema_tpu_torch.parallel.distrib import (allreduce_counts,
                                                init_distributed)

    mode, coord, procid, outdir = sys.argv[1:5]
    rest = sys.argv[5:]
    multi = ["--coordinator", coord, "--nprocs", "2", "--procid", procid]
    if mode == "preproc":
        pid, n = init_distributed(coord, 2, int(procid))
        assert (pid, n) == (int(procid), 2), (pid, n)
        np.save(f"{outdir}/allreduce{pid}.npy",
                allreduce_counts(np.arange(5, dtype=np.int64) + 10 * pid))
        np.save(f"{outdir}/allreduce_f{pid}.npy", allreduce_counts(
            np.array([0.1, 1e16, 2.5, -3.0]) * (pid + 1)))
        fq, wl, cnt = rest

        class Stdin:
            buffer = open(fq, "rb")
        sys.stdin = Stdin
        rc = cli.main(["preproc", "-w", wl, "-o", outdir, "-n", "4", "-h",
                       *multi, cnt])
    else:
        ref, *buckets = rest
        rc = cli.main(["align", "-r", ref, "--device", "cpu", "-x", *multi,
                       "-o", f"{outdir}/out.sam", *buckets])
    loaded = chip_smoke.reference_modules_loaded()
    assert not loaded, loaded
    raise SystemExit(rc)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _two_processes(mode, per_proc_args, timeout=600) -> None:
    """Run the worker in ``mode`` as processes 0 and 1 of one gloo group;
    ``per_proc_args[i]`` = (outdir, *rest) of process i."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, mode, coord, str(i),
         *map(str, per_proc_args[i])], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err.decode()[-3000:]


def test_two_process_distributed_preproc(tmp_path):
    """tests/test_multihost.py:153-217 on the port: each process counts
    its half of the FASTQ; the two distributed ``preproc`` processes'
    bucket files, concatenated per bucket, equal the JAX package's
    single-process ``correct`` fed both count outputs."""
    wl, fq = make_dataset(seed=11, n_wl=200, n_pairs=400)
    wl_path = write_wl(tmp_path, wl)
    lines = fq.decode().splitlines(keepends=True)
    mid = (len(lines) // 16) * 8
    chunks = ["".join(lines[:mid]).encode(), "".join(lines[mid:]).encode()]
    fq_paths, prefixes = [], []
    for i, c in enumerate(chunks):
        p = tmp_path / f"chunk{i}.fq"
        p.write_bytes(c)
        fq_paths.append(p)
        pref = tmp_path / f"cnt{i}"
        jax_count.count(str(wl_path), str(pref), io.BytesIO(c))
        prefixes.append(str(pref) + ".ema-ncnt")

    single = tmp_path / "single"
    jax_correct.correct(str(wl_path), prefixes, str(single), io.BytesIO(fq),
                        do_h2=True, n_buckets=4)

    _two_processes("preproc", [(tmp_path, fq_paths[i], wl_path, prefixes[i])
                               for i in range(2)])
    # the counts were summed across the processes, in rank order
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"allreduce{i}.npy"),
            np.arange(5) + (np.arange(5) + 10))
        f = np.array([0.1, 1e16, 2.5, -3.0])
        np.testing.assert_array_equal(
            np.load(tmp_path / f"allreduce_f{i}.npy"),
            np.stack([f, 2 * f]).sum(axis=0))
    for name in [f"ema-bin-{b:03d}" for b in range(4)] + ["ema-nobc"]:
        merged = b"".join((tmp_path / f"host{i:02d}" / name).read_bytes()
                          for i in range(2))
        assert merged == (single / name).read_bytes(), name
    assert sum(len((single / f"ema-bin-{b:03d}").read_bytes())
               for b in range(4)) > 0


def _records(path):
    out = {}
    for ln in open(path):
        if ln.startswith("@"):
            continue
        f = ln.rstrip("\n").split("\t")
        # MI is a per-bucket namespace: compared elsewhere as a bijection
        out[(f[0], int(f[1]) & 0xC0)] = (f[1], f[2], f[3], f[4], f[5], f[9])
    return out


def test_two_process_distributed_align(tmp_path):
    """tests/test_multihost.py:77-150 on the port: two ``align -x
    --coordinator`` processes take their bucket shards from the process
    topology; their shard outputs together hold the JAX package's
    single-process records."""
    rng = np.random.default_rng(6)
    gs = to_str(rand_genome(rng, 120_000))
    ref = tmp_path / "ref.fa"
    ref.write_text(">c1\n" + "".join(gs[i:i + 70] + "\n"
                                     for i in range(0, len(gs), 70)))
    ids, bc_strs, bcs, s1, q1, s2, q2, truth = simulate_pairs(
        rng, gs, n_barcodes=6, frags_per_bc=(1, 2), pairs_per_frag=(6, 10))
    uniq = sorted(set(bc_strs))
    buckets = []
    for b in range(4):
        p = tmp_path / f"ema-bin-{b:03d}"
        with open(p, "w") as f:
            for i in range(len(ids)):
                if uniq.index(bc_strs[i]) % 4 == b:
                    f.write(f"{bc_strs[i]} @{ids[i]} {s1[i]} {q1[i]} "
                            f"{s2[i]} {q2[i]}\n")
        buckets.append(str(p))

    single = tmp_path / "single.sam"
    # also writes the index beside ref.fa, which both workers then load
    assert jax_cli.main(["align", "-r", str(ref), "-x", "-o", str(single),
                         *buckets]) == 0
    dirs = [tmp_path / f"host{i}" for i in range(2)]
    for d in dirs:
        d.mkdir()
    _two_processes("align", [(dirs[i], ref, *buckets) for i in range(2)])
    got = {}
    for i, d in enumerate(dirs):
        shards = sorted(n for n in os.listdir(d) if n.endswith(".sam"))
        assert shards == [f"out.shard{i:02d}of02.sam"], shards
        got.update(_records(d / shards[0]))
    want = _records(single)
    assert got == want and len(want) == 2 * len(ids)


def test_init_distributed_without_a_coordinator():
    """No coordinator and no group: (0, 1), as jax.process_index() and
    jax.process_count() give in one process; a coordinator without the
    topology is refused before anything is joined."""
    import pytest
    import torch.distributed as dist

    assert distrib.init_distributed() == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="number of processes"):
        distrib.init_distributed("127.0.0.1:1", None, 0)
    assert not dist.is_initialized()


def test_allreduce_counts_single_process():
    """tests/test_distrib.py:27 on the port: identity in one process."""
    from ema_tpu.parallel.distrib import allreduce_counts as jax_allreduce

    for c in (np.arange(10, dtype=np.int64), np.linspace(0.0, 1.0, 7)):
        got = distrib.allreduce_counts(c)
        assert got is c
        np.testing.assert_array_equal(got, jax_allreduce(c))
