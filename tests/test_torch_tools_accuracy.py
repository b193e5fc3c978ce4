"""The port's accuracy tools (ema_tpu_torch/tools/measure_accuracy.py,
chain_recall.py, diagnose_mapq.py) against the JAX package's on the same
small worlds, on the CPU: their results equal field for field, the
timings and the device fields masked.
"""

import os
import sys

import numpy as np

from ema_tpu_torch.tools import chain_recall, diagnose_mapq, measure_accuracy
from test_torch_tools import (DEVICE_FIELDS, ROOT,  # noqa: F401
                              one_thread_each, run_jax_tool, run_twin)
from torch_handover import jax_native_built  # noqa: F401 (autouse)

TIMINGS = {"align_wall_s", "pairs_per_sec"}


def test_measure_accuracy_equals_jax(tmp_path, capsys):
    """The repeat-family world of varying divergence at 500 kbp: the same
    shares at truth, proper pairs and mapq calibration bins."""
    small = ["--genome", "500000", "--pairs", "3000"]
    want = run_jax_tool(tmp_path, "tools/measure_accuracy.py",
                        [*small, "--out", str(tmp_path / "acc.json")])
    got = run_twin(measure_accuracy, ["--device", "cpu", *small], capsys)
    assert set(got) == set(want) - {"platform"} | DEVICE_FIELDS
    for k in set(want) - TIMINGS - {"platform", "what"}:
        assert got[k] == want[k], k
    assert got["at_truth_pct_of_mapped"] >= 98
    assert sum(b["n"] for b in got["mapq_calibration"].values()) \
        == got["primary_records"]


def test_chain_recall_equals_jax():
    """build_world and measure_recall on a 1 Mbp world: the same world
    array for array and the same recall payload, both tools scoring their
    brute-force loci with their own copy of the native banded scorer."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import chain_recall as jax_cr
    finally:
        sys.path.pop(0)
    want_world = jax_cr.build_world(np.random.default_rng(5), 1_000_000,
                                    2_000)
    genome, fams, sim = chain_recall.build_world(
        np.random.default_rng(5), 1_000_000, 2_000)
    np.testing.assert_array_equal(genome, want_world[0])
    assert fams == want_world[1]
    assert sim[:2] == want_world[2][:2] and sim[3:] == want_world[2][3:]
    want = jax_cr.measure_recall(*want_world)
    got = chain_recall.measure_recall(genome, fams, sim, device="cpu")
    assert "error" not in got and got["eligible_loci"] > 100
    assert got == want


def test_diagnose_mapq_terms_equal_jax(tmp_path, capsys):
    """The exact-repeat world at 500 kbp: the spy reaches the calls of
    final_mapq (a term for every mate at least), and the term counts,
    bins and candidate statistics equal the JAX tool's; the spy is gone
    after the run."""
    small = ["--genome", "500000", "--pairs", "3000"]
    want = run_jax_tool(tmp_path, "tools/diagnose_mapq.py", small)
    assert list((tmp_path / "jax").glob("MAPQ_DIAG_r*.json"))
    got = run_twin(diagnose_mapq, ["--device", "cpu", *small], capsys)
    assert set(got) == set(want) | DEVICE_FIELDS
    for k in set(want) - {"what"}:
        assert got[k] == want[k], k
    assert got["records"] >= 2 * got["n_pairs"]
    assert got["final_decomposition"]["mapq_0_9"]["n"] > 0
    from ema_tpu_torch.core import score
    assert score.final_mapq.__name__ == "final_mapq"     # restored
