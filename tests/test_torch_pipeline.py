"""The port's align path (ema_tpu_torch) against the JAX package, on CPU.

On the CPU the port scores with the plain PyTorch SW and runs EM on the
host; its SAM must still be byte-identical to the JAX package's.  The
same paths run on the card in chip_smoke.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GOLDEN, golden_sam
from ema_tpu import config
from ema_tpu.core import pipeline as jax_pipeline
from ema_tpu.index import build_index
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.core.pipeline import Aligner, orient_device
from ema_tpu_torch.index.device import to_device_state
from simulate import rand_genome, simulate_pairs, to_str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_orientation_matches_jax_and_host():
    rng = np.random.default_rng(2)
    R, L = 40, 60
    lens = rng.integers(0, L + 1, R).astype(np.int32)
    codes = np.full((R, L), 4, np.uint8)
    for r in range(R):                    # mixed read lengths, N bases
        codes[r, :lens[r]] = rng.integers(0, 5, lens[r])
    got, got_lens = orient_device(torch.from_numpy(codes),
                                  torch.from_numpy(lens))
    want, want_lens = jax_pipeline._orient_device(jnp.asarray(codes),
                                                  jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    # the host orientation of ema_tpu/core/pipeline.py:403-413
    pos = lens[:, None] - 1 - np.arange(L)[None, :]
    src = np.take_along_axis(codes, np.maximum(pos, 0), axis=1)
    rc = np.where(pos >= 0, np.where(src < 4, 3 - np.minimum(src, 3), 4),
                  4).astype(np.uint8)
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([codes, rc], axis=0))


def test_device_state_preserves_text():
    rng = np.random.default_rng(3)
    idx = build_index({"a": rand_genome(rng, 5000),
                       "b": rand_genome(rng, 700)})
    text = to_device_state(idx, torch.device("cpu"))
    assert text.dtype == torch.uint8
    np.testing.assert_array_equal(text.numpy(), idx.text)


def test_golden_sam_cpu():
    with open(GOLDEN) as f:
        want = f.read()
    assert golden_sam(torch.device("cpu")) == want


@pytest.mark.parametrize("sw_impl", ["banded16", "tier64", "scan",
                                     "native"])
def test_golden_sam_cpu_every_scorer(sw_impl):
    """Whichever SW scorer the Aligner is given, the golden world gives
    tests/golden/expected.sam byte for byte."""
    from ema_tpu_torch.ops.sw import CALLS, reset_counts

    with open(GOLDEN) as f:
        want = f.read()
    reset_counts()
    assert golden_sam(torch.device("cpu"), sw_impl) == want
    used = {s for s, c in CALLS.items() if c.value}
    # tier64: chained corridors go packed, rescue windows (~680) banded
    assert used == {"banded16": {"banded16"}, "tier64": {"packed", "banded"},
                    "scan": {"scan"}, "native": set()}[sw_impl]


def test_sam_equals_jax_on_repeat_world():
    """The repeat world of tests/test_pipeline.py:129 (2 Mbp, three
    repeat families, 80 barcodes): both packages must emit the same SAM
    lines (the JAX package with its native SW and jitted EM, the port
    with the plain PyTorch SW and host EM)."""
    rng = np.random.default_rng(41)
    G = 2_000_000
    genome = rand_genome(rng, G)
    unit_len = G // 2500
    for fam in range(3):
        src = int(rng.integers(0, G - unit_len))
        unit = genome[src:src + unit_len].copy()
        for c in range(8):
            at = int(rng.integers(0, G - unit_len))
            genome[at:at + unit_len] = unit
    idx = build_index({"chr1": genome})
    pairs = simulate_pairs(
        rng, to_str(genome), n_barcodes=80, frags_per_bc=(2, 3),
        pairs_per_frag=(15, 25), frag_len=30_000, read_len=100,
        err=0.003)
    ids, _, bcs, s1, q1, s2, q2, _ = pairs
    want = jax_pipeline.Aligner(idx).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2))
    got = Aligner(idx, device="cpu").align_batch_to_sam(
        ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2))
    assert len(got) >= 2 * len(ids)
    assert got == want


def test_long_reads_equal_jax():
    """Two pairs of 600 bp reads, one mate found only by mate rescue
    through a 1183-lane corridor (chip_smoke.long_read_world): the
    port's SAM equals the JAX package's."""
    from chip_smoke import long_read_world

    genome, pairs = long_read_world()
    idx = build_index({"c": genome})
    want = jax_pipeline.Aligner(idx).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs))
    got = Aligner(idx, device="cpu").align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert len(got) == 4 and all(ln.split("\t")[5] != "*" for ln in got)
    assert got == want


def test_scalar_emission_path_equals_jax():
    """bx_index != "1" takes the per-group scalar emitter (_emit_group);
    on the golden world it must match the JAX package's."""
    from chip_smoke import golden_world

    contigs, _, pairs = golden_world()
    idx = build_index(contigs)
    cfg = config.RunConfig(batch_size=512, seed=7, bx_index="2")
    want = jax_pipeline.Aligner(idx, cfg).align_batch_to_sam(
        jax_pipeline.ReadBatch.from_pairs(*pairs))
    got = Aligner(idx, cfg, device="cpu").align_batch_to_sam(
        ReadBatch.from_pairs(*pairs))
    assert any("BX:Z:" in ln and "-2" in ln for ln in got)
    assert got == want


def test_aligner_refuses_what_is_not_ported():
    idx = build_index({"a": rand_genome(np.random.default_rng(4), 2000)})
    with pytest.raises(ValueError, match="device EM"):
        Aligner(idx, config.RunConfig(device_em=True), device="cpu")
    greedy = config.RunConfig(aligner=config.AlignerParams(seeding="greedy"))
    with pytest.raises(ValueError, match="greedy"):
        Aligner(idx, greedy, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Aligner(idx, device="cuda")


_NO_JAX_SCRIPT = r"""
import os, sys
import numpy as np
from ema_tpu.index.build import build_index
from ema_tpu_torch.core.batch import ReadBatch
from ema_tpu_torch.core.pipeline import Aligner
from chip_smoke import simulate

sim = simulate()
tmp = sys.argv[1]
rng = np.random.default_rng(8)
genome = sim.rand_genome(rng, 40_000)
gs = sim.to_str(genome)
ids, bc_strs, bcs, s1, q1, s2, q2, _ = sim.simulate_pairs(
    rng, gs, n_barcodes=2, pairs_per_frag=(3, 6), frag_len=10_000)
idx = build_index({"c": genome})
lines = Aligner(idx, device="cpu").align_batch_to_sam(
    ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2))
assert lines, "no SAM lines"
os.environ["EMA_TPU_SW_IMPL"] = "scan"
scan = Aligner(idx, device="cpu")
assert scan.sw_impl == "scan"
assert scan.align_batch_to_sam(
    ReadBatch.from_pairs(ids, bcs, s1, q1, s2, q2)) == lines
del os.environ["EMA_TPU_SW_IMPL"]
ref = os.path.join(tmp, "ref.fa")
with open(ref, "w") as f:
    f.write(">c\n" + gs + "\n")
bucket = os.path.join(tmp, "bucket.txt")
with open(bucket, "w") as f:
    for row in zip(bc_strs, ids, s1, q1, s2, q2):
        f.write(" ".join(row) + "\n")
from ema_tpu_torch.cli import main
out = os.path.join(tmp, "out.sam")
assert main(["align", "-r", ref, "-s", bucket, "-o", out,
             "--device", "cpu"]) == 0
with open(out) as f:
    recs = [ln for ln in f if not ln.startswith("@")]
assert sorted(recs) == sorted(lines), "CLI and library SAM differ"
assert "jax" not in sys.modules, "jax was imported"
print("NO_JAX_OK", len(recs))
"""


def test_align_and_cli_never_import_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT,
                        str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
