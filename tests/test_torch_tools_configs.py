"""The port's config tools and CLI drive (ema_tpu_torch/tools/
bench_configs.py, bench_config5.py, verify_drive.py) against the JAX
package's, on the CPU and at small sizes: each runs the port's real CLI
(``python -m ema_tpu_torch.cli``) in subprocesses.
"""

import os
import re

from ema_tpu_torch.tools import bench_config5, bench_configs, verify_drive
from test_torch_tools import (DEVICE_FIELDS, ROOT,  # noqa: F401
                              one_thread_each, run_jax_tool, run_twin)
from torch_handover import jax_native_built  # noqa: F401 (autouse)


def _jax_payload_fields(rel, start) -> set:
    """The keys of the JSON payload a JAX tool builds as a dict literal
    whose first line matches ``start``."""
    src = open(os.path.join(ROOT, rel)).read()
    body = src[src.index(start):]
    body = body[:re.search(r"^\s*\}\)?\s*$", body, flags=re.M).start()]
    return set(re.findall(r'^\s+"(\w+)":', body, flags=re.M))


def test_bench_configs_config4_as_jax(tmp_path, capsys):
    """config4 (align -x -d over many buckets): the JAX tool's fields,
    less platform; both count every pair's records."""
    small = ["--genome", "300000", "--pairs", "1200", "--buckets", "20"]
    want = run_jax_tool(tmp_path, "tools/bench_configs.py",
                        ["config4", *small])
    assert list((tmp_path / "jax").glob("BENCH_CONFIG4_r*.json"))
    got = run_twin(bench_configs, ["config4", "--device", "cpu", *small],
                   capsys)
    assert set(got) == set(want) - {"platform"} | DEVICE_FIELDS
    assert got["n_pairs"] == want["n_pairs"]
    assert got["metric"] == want["metric"]


def test_bench_configs_config3_fields(capsys):
    """config3 (align -1/-2): the JAX tool's fields, less platform, and
    the warm run's stage table."""
    want = _jax_payload_fields("tools/bench_configs.py",
                               'write_artifact("CONFIG3", {')
    got = run_twin(bench_configs, ["config3", "--device", "cpu", "--genome",
                                   "300000", "--pairs", "1200"], capsys)
    assert set(got) == want - {"platform"} | DEVICE_FIELDS
    assert "align" in got["stages_warm"]


def test_bench_config5_two_processes_equal_one(capsys):
    """config5: two align -x --sort processes of one gloo group, merged,
    give the single process's records (the twin asserts it before it
    reports a time); the JAX tool's fields, less platform and round."""
    want = _jax_payload_fields("tools/bench_config5.py", "out = {")
    got = run_twin(bench_config5, ["--device", "cpu", "--genome", "300000",
                                   "--barcodes", "20", "--buckets", "4"],
                   capsys)
    assert set(got) == want - {"platform", "round"} | DEVICE_FIELDS
    assert got["n_pairs"] > 500 and got["n_buckets"] == 4


def test_verify_drive_passes(capsys):
    """count -> preproc -> index -> align through the port's CLI: every
    record at its truth, with the JAX tool's counts."""
    src = open(os.path.join(ROOT, "tools", "verify_drive.py")).read()
    counts = re.findall(r"(\w+)=\{", src[src.index('print(f"records='):])
    got = run_twin(verify_drive, ["--device", "cpu"], capsys)
    assert set(counts) == {"records", "primary", "at_truth", "proper",
                           "missing_tags"}
    assert set(counts) <= set(got)
    assert got["ok"] and got["primary"] == 2 * got["n_pairs"]
    assert got["at_truth_pct"] >= 98 and got["proper_pct"] >= 98
