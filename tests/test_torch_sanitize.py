"""The host side of chip_smoke.py's sanitizer phases, on the CPU.

``phase_sanitize`` launches every instantiation of the five kernels under
compute-sanitizer's four tools and under the card's own checks (a fenced
and poisoned allocator, schedule-fuzzed builds of the SW kernels);
``phase_stream_sanitize`` runs the main path under torch's stream
sanitizer.  Neither runs here.  These tests hold what they are built
from: the launch list read back from the kernels' launch tables (every
instantiation the five .cu files name is launched once), the sets'
shapes (odd N, segments past N, windows off both ends of the text, tail
rows, alignments that cross warps) and their saved file, the report
parser on canned compute-sanitizer output, what a refusal is logged
with, the kernel filter, and the sanitizer's propagation to worker
threads.
"""

from __future__ import annotations

import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as smoke
from ema_tpu_torch.ops import probe
from ema_tpu_torch.ops.sw import (BANDED_CLASS_EDGES, KERNEL_SYMBOL, MAX_READ,
                                  plan_class_launches)

CSRC = Path(__file__).resolve().parents[1] / "ema_tpu_torch" / "ops" / "csrc"


def _body(name, fn):
    return (CSRC / f"{name}.cu").read_text().split(f"{fn}(")[-1]


def _class_table(name, macro, small_first):
    """corridor class -> (small call's form, large call's form) of the
    launch table of ``<name>_launch``."""
    table = {}
    for line in _body(name, f"int {name}_launch").splitlines():
        if f"{macro}(" not in line or "#define" in line:
            continue
        edge = re.search(r"max_wl <= (\d+)", line)
        forms = [tuple(map(int, f)) for f in
                 re.findall(rf"{macro}\((\d+), (\d+), (\d+)\)", line)]
        pair = (forms[0], forms[-1]) if small_first else (forms[-1],
                                                          forms[0])
        table[int(edge.group(1)) if edge else BANDED_CLASS_EDGES[-1]] = pair
    return table


def _batch_table():
    """group -> ((the longest read, rows a thread) of each form) of
    sw_batch.cu's launch_form; the last 32-thread form takes reads to the
    kernel's kMaxRows."""
    src = (CSRC / "sw_batch.cu").read_text()
    assert re.search(r"kMaxRows = 32 \* 32;", src)
    table = {}
    body = src.split("bool launch_form(")[1].split("\n}\n")[0]
    for line in body.splitlines():
        m = re.search(r"launch<(\d+), (\d+)>", line)
        if not m:
            continue
        rows = re.search(r"rows <= (\d+)", line)
        table.setdefault(int(m.group(2)), []).append(
            (int(rows.group(1)) if rows else 32 * 32, int(m.group(1))))
    return {g: tuple(v) for g, v in table.items()}


def _probe_instantiations():
    src = (CSRC / "alu_probe.cu").read_text()
    unrolls = [int(u) for u, v in re.findall(r"case (\d+): launch<(\d+)>",
                                             src) if u == v]
    forms = sorted({int(f) for f in re.findall(
        r"alu_probe_kernel<UNROLL, (\d)>", src)})
    return {(u, f) for u in unrolls for f in forms}


def test_tables_read_back_from_the_sources():
    """The forms the sanitize drive asks for are the launch tables of the
    sources, class by class and group by group."""
    assert _class_table("sw_banded", "SW_FORM", True) == smoke.SAN_BANDED
    assert _class_table("sw_banded16", "SW_CLASS", False) == \
        smoke.SAN_BANDED16
    assert tuple(smoke.SAN_BANDED) == BANDED_CLASS_EDGES
    packed = [tuple(map(int, f)) for f in re.findall(
        r"launch<(\d+), (\d+)>\(t,",
        _body("sw_banded_packed", "int sw_banded_packed_launch"))]
    assert packed == [smoke.SAN_PACKED[8], smoke.SAN_PACKED[16]]
    assert _batch_table() == smoke.SAN_BATCH
    # the byte and the mask form are template arguments of these two only
    for name in ("sw_banded", "sw_batch"):
        src = (CSRC / f"{name}.cu").read_text()
        assert re.search(rf"{name}_kernel<[^>]*, true>", src)
        assert re.search(rf"{name}_kernel<[^>]*, false>", src)
    for name in ("sw_banded16", "sw_banded_packed"):
        assert "bool BYTE" not in (CSRC / f"{name}.cu").read_text()


def _source_instantiations() -> set:
    out = set()
    for edge, pair in smoke.SAN_BANDED.items():
        out |= {("sw_banded", f, s) for f in pair for s in ("byte", "mask")}
    for pair in smoke.SAN_BANDED16.values():
        out |= {("sw_banded16", f, "byte") for f in pair}
    out |= {("sw_banded_packed", f, "byte") for f in smoke.SAN_PACKED.values()}
    for g, forms in smoke.SAN_BATCH.items():
        out |= {("sw_batch", (r, g), s) for _, r in forms
                for s in ("byte", "mask")}
    out |= {("alu_probe", uf, None) for uf in _probe_instantiations()}
    return out


def test_launch_list_reaches_every_instantiation_once():
    """sanitize_launches holds one launch of every instantiation the five
    sources name (36 + 12 + 2 + 18 + 18), and each launch's group, class
    or longest read selects that form in the launch table."""
    launches = smoke.sanitize_launches()
    got = [(s["kernel"], s["form"], s.get("scoring")) for s in launches]
    assert len(got) == len(set(got)) == 86
    assert set(got) == _source_instantiations()
    edges = (0,) + BANDED_CLASS_EDGES
    for s in launches:
        if s["kernel"] in ("sw_banded", "sw_banded16"):
            table = (smoke.SAN_BANDED if s["kernel"] == "sw_banded"
                     else smoke.SAN_BANDED16)
            assert table[s["edge"]][0 if s["group"] == 32 else 1] == \
                s["form"]
        elif s["kernel"] == "sw_banded_packed":
            assert smoke.SAN_PACKED[s["group"]] == s["form"]
        elif s["kernel"] == "sw_batch":
            forms = smoke.SAN_BATCH[s["group"]]
            k = [r for _, r in forms].index(s["form"][0])
            lo = forms[k - 1][0] if k else 0
            assert lo < s["rows"] <= min(forms[k][0], MAX_READ)
        else:
            assert s["unroll"] in probe.UNROLLS
            assert probe.FORMS.index(s["probe_form"]) == s["form"][1]
    assert {s["edge"] for s in launches if "edge" in s} <= set(edges)


@pytest.fixture(scope="module")
def sets():
    return smoke.sanitize_sets()


def test_sets_hold_their_edges(sets):
    """Every SW set: odd N, a part-warp form's last warp holds a segment
    past N, windows off both ends of the text, tail rows, corridors in the
    launch's class (one at its widest), and a text whose length puts its
    last byte against the fence."""
    assert len(sets) == 87
    for spec, c, want in sets:
        if spec["kernel"] == "alu_probe":
            assert c["x"].shape == (smoke.SAN_PROBE["n"],)
            assert smoke.SAN_PROBE["n"] % 128, "a part-filled last block"
            continue
        n = c["text"].shape[0]
        N = c["owners"].shape[0]
        assert n % 4 == 0 and want.shape == (N, 4)
        assert N % 2 == 1
        lo, ln = c["win_lo"].numpy(), c["win_len"].numpy()
        assert lo[0] < 0 and lo[-1] + ln[-1] > n
        if spec.get("sorted"):
            _, spans = plan_class_launches(c["wl"], int(c["wl"].min()),
                                           int(c["wl"].max()))
            assert [e for e, _, _ in spans] == [32, 4096]
            continue
        segw = spec["form"][1]
        if segw < 32:
            assert N == 32 // segw + 1
        rl = c["olens"].numpy()[:N].astype(np.int64)
        wl = c["wl"].numpy().astype(np.int64)
        if spec["kernel"] == "sw_batch":
            assert int(c["olens"].max()) == spec["rows"]
            continue
        assert ln[1] < rl[1] + wl[1] - 1, "candidate 1 has tail rows"
        assert wl.max() == spec["edge"]
        # the base entering the last lane reaches the text's last base and
        # the column past it while the last candidate's rows run
        lanes = int(np.prod(spec["form"])) * (
            2 if spec["kernel"] == "sw_banded16" else 1)
        rows = min(rl[-1], ln[-1])
        assert lo[-1] + lanes < n <= lo[-1] + lanes + rows - 1
        if spec["kernel"] != "sw_banded_packed":
            below = (0,) + BANDED_CLASS_EDGES
            assert wl.min() > below[below.index(spec["edge"]) - 1]


def test_saved_sets_load_as_made(sets, tmp_path, monkeypatch):
    """``save_sanitize_sets`` (what the sanitize drive runs where its SETS
    file is missing) writes every launch's inputs and plain output to a
    new directory, and they load back equal."""
    monkeypatch.setattr(smoke, "sanitize_sets", lambda: sets)
    path = tmp_path / "new" / "sets.pt"
    specs = smoke.save_sanitize_sets(str(path))
    back = torch.load(path)
    assert specs == [s for s, _, _ in sets] == [s for s, _, _ in back]
    for (_, c, want), (_, c2, want2) in zip(sets, back):
        assert c.keys() == c2.keys()
        assert all(torch.equal(c[k], c2[k]) for k in c)
        assert torch.equal(want, want2)


def test_several_warp_sets_cross_warps(sets):
    """In a several-warp form's set, candidate 1's best cell (under the
    byte scoring) lies on lane ``cross``, warp 1's first, which its read
    reaches from warp 0's last lane: the hand-overs through shared memory
    carry the alignment."""
    n = 0
    for spec, c, want in sets:
        form = spec["form"]
        if (spec["kernel"] not in ("sw_banded", "sw_banded16")
                or spec.get("sorted") or form[2] == 1
                or spec["scoring"] != "byte"):
            continue
        per_lane = 2 if spec["kernel"] == "sw_banded16" else 1
        cross = per_lane * form[0] * 32
        score, _, qe, ref_end = want[1].tolist()
        assert ref_end - qe == cross, (spec, want[1])
        assert score > smoke.SAN_READ // 2
        n += 1
    assert n == 12


CANNED = {
    "memcheck_clean": ("memcheck", "========= COMPUTE-SANITIZER\n"
                       "SANITIZE-DRIVE-OK {}\n"
                       "========= ERROR SUMMARY: 0 errors\n",
                       ("clean", 0)),
    "memcheck_errors": ("memcheck", "========= Invalid __global__ read of "
                        "size 1 bytes\n=========     at sw_banded_kernel"
                        "\n========= ERROR SUMMARY: 3 errors\n",
                        ("errors", 3)),
    "initcheck_one": ("initcheck", "========= ERROR SUMMARY: 1 error\n",
                      ("errors", 1)),
    "racecheck_clean": ("racecheck", "========= RACECHECK SUMMARY: 0 "
                        "hazards displayed (0 errors, 0 warnings)\n",
                        ("clean", 0)),
    "racecheck_hazard": ("racecheck", "========= RACECHECK SUMMARY: 1 "
                         "hazard displayed (1 error, 0 warnings)\n",
                         ("errors", 1)),
    "racecheck_warning": ("racecheck", "========= RACECHECK SUMMARY: 2 "
                          "hazards displayed (0 errors, 2 warnings)\n",
                          ("errors", 2)),
    "refused": ("synccheck", "========= COMPUTE-SANITIZER\n========= "
                "Error: Device not supported. Please refer to the "
                "\"Supported Devices\" section of the sanitizer "
                "documentation\n=========\n========= Target application "
                "returned an error\n========= ERROR SUMMARY: 1 error\n",
                ("refused", None)),
}


@pytest.mark.parametrize("case", sorted(CANNED))
def test_report_parser_reads_canned_reports(case):
    tool, text, (status, errors) = CANNED[case]
    rep = smoke.sanitizer_report(text, tool)
    assert (rep["status"], rep["errors"]) == (status, errors)
    if status == "refused":
        assert rep["line"].startswith("Device not supported")


@pytest.mark.parametrize("text", [
    "", "========= COMPUTE-SANITIZER\nSANITIZE-DRIVE-OK {}\n",
    "========= ERROR SUMMARY: 0 errors\n========= ERROR SUMMARY: 2 "
    "errors\n",
    "========= ERROR SUMM", "========= RACECHECK SUMMARY: 0 hazards"],
    ids=["empty", "no_summary", "two_summaries", "cut", "cut_racecheck"])
def test_report_parser_refuses_what_it_cannot_read(text):
    tool = "racecheck" if "RACECHECK" in text else "memcheck"
    with pytest.raises(ValueError, match="summary"):
        smoke.sanitizer_report(text, tool)


def test_filters_name_every_kernel():
    """One kernel filter per __global__ function of the five sources,
    and no other."""
    args = smoke.sanitizer_filters()
    assert args[::2] == ["--kernel-name"] * 5
    names = [a.split("=", 1)[1] for a in args[1::2]]
    assert sorted(names) == sorted([*KERNEL_SYMBOL.values(),
                                    probe.KERNEL_SYMBOL])
    sources = {**{s: k for k, s in KERNEL_SYMBOL.items()},
               probe.KERNEL_SYMBOL: "alu_probe"}
    for name in names:
        src = (CSRC / f"{sources[name]}.cu").read_text()
        assert re.search(rf"__global__ void[^;{{]*\n?\s*{name}\(", src), name


def test_compute_sanitizer_is_found_or_refused(tmp_path, monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="compute-sanitizer not found"):
        smoke.compute_sanitizer()
    for rel in ("extras/compute-sanitizer/compute-sanitizer",
                "bin/compute-sanitizer"):
        tool = tmp_path / rel
        tool.parent.mkdir(parents=True, exist_ok=True)
        tool.write_text("#!/bin/sh\n")
        tool.chmod(0o755)
        assert smoke.compute_sanitizer() == str(tool)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError):
        smoke.compute_sanitizer()


def test_refusal_context_names_tool_driver_and_kernel(tmp_path,
                                                      monkeypatch):
    """A refusal is logged with the tool's version, the driver, nvcc and
    the kernel; a command that is missing is said to be."""
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    tool = tmp_path / "bin" / "compute-sanitizer"
    tool.parent.mkdir()
    tool.write_text("#!/bin/sh\necho header\necho Version 2025.2.1.0\n")
    tool.chmod(0o755)
    text = smoke.sanitizer_refusal_context(str(tool))
    assert text.startswith("compute-sanitizer Version 2025.2.1.0; driver ")
    assert "nvcc (not found)" in text
    assert f"kernel {os.uname().sysname} " in text


def test_fuzz_points_precede_every_shared_memory_hand_over():
    """The schedule fuzzing sits before every write of the several-warp
    forms' shared state and before the read of the next warp's row state,
    and exists only under the define chip_smoke.py builds it with."""
    common = (CSRC / "sw_common.cuh").read_text()
    assert f"#ifdef {smoke.FUZZ_DEFINE[2:]}" in common
    for name in ("sw_banded", "sw_banded16"):
        lines = (CSRC / f"{name}.cu").read_text().splitlines()
        hand_overs = [k for k, line in enumerate(lines)
                      if re.search(r"sh_(bnd\[wc\]\[0\]|agg\[[^\]]*\]"
                                   r"(\[0\])? *=|best\[wc\] =|"
                                   r"bnd\[wc \+ 1\]\[0\])", line)]
        assert len(hand_overs) == 4, name
        for k in hand_overs:
            assert any("sw::fuzz_delay(" in lines[j]
                       for j in range(k - 3, k)), (name, lines[k])


def test_stream_sanitizer_follows_worker_threads(monkeypatch):
    """_sanitize_every_thread enters the dispatch mode in threads started
    after it (a thread pool's workers see it) and serialises the mode's
    launch bookkeeping."""
    monkeypatch.setattr(threading.Thread, "run", threading.Thread.run)
    calls = []

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []
            self.event_handler = SimpleNamespace(
                _handle_kernel_launch=lambda *a: calls.append(a) or [])

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(threading.current_thread().name)
            return func(*args, **(kwargs or {}))

    mode = Mode()
    checked = smoke._sanitize_every_thread(mode)
    with ThreadPoolExecutor(max_workers=2) as ex:
        out = list(ex.map(lambda i: int((torch.ones(4) * i).sum()),
                          range(4)))
    assert out == [0, 4, 8, 12]
    assert len(mode.ops) >= 4 * 3          # ones, mul, sum per call
    assert all(name.startswith("ThreadPoolExecutor") for name in mode.ops)
    assert mode.event_handler._handle_kernel_launch(1, 2) == []
    assert calls == [(1, 2)] and checked == {"MainThread": 1}
