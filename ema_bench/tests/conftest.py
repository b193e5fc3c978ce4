"""Fixtures of the benchmark's own tests: a bench root at a tiny size,
built from files alone, and the one marker of tests that need a card.

    python -m pytest ema_bench/tests -q            # CPU; card tests skip
    python -m pytest ema_bench/tests -q -m card    # on the card
"""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_GENOME = {"length": 4_000_000, "repeat_families": 3,
               "repeat_copies": 4, "repeat_unit_bp": [3000, 5000]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run with -m card on the card")
    return torch.cuda.get_device_name(0)


def make_tiny_root(dst: str) -> str:
    """A bench root under ``dst``: the repository's BENCHMARK.json and
    data files, and a tiny copy of each configuration and traffic mix
    with a cell ``tiny-<cell>`` for each cell, added as files."""
    here = os.path.join(dst, "ema_bench")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "ema_bench", d),
                        os.path.join(here, d))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in list(bench["workloads"]):
        c = json.load(open(os.path.join(here, "configs",
                                        w["config"] + ".json")))
        c["name"] = "tiny-" + c["name"]
        c["genome"].update(TINY_GENOME)
        c["check_sample_records"] = 200
        # a tiny run has 20-30 records in exact repeat copies, so their
        # share off the truth swings by 20 points between seeds
        c["limits"]["em_off_truth_pct"] = 50.0
        if "aligner" in c:
            c["aligner"]["flush_pairs"] = 1024
            c["check_group_share"] = 1.0
        json.dump(c, open(os.path.join(here, "configs",
                                       c["name"] + ".json"), "w"))
        t = json.load(open(os.path.join(here, "traffic",
                                        w["traffic"] + ".json")))
        t["name"] = "tiny-" + t["name"]
        t["pool_pairs"] = 3072 if "buckets_per_call" not in t else 2400
        # one molecule a barcode, so that a barcode covers about the share
        # of the tiny genome (1.2%) that ten cover of the cell's (0.8%),
        # and 30-40 pairs, so that the EM's gate still opens
        t["molecules"] = [1, 1]
        t["pairs_per_molecule"] = [30, 40]
        t["whitelist_decoys"] = 100
        json.dump(t, open(os.path.join(here, "traffic",
                                       t["name"] + ".json"), "w"))
        bench["workloads"].append(dict(w, name="tiny-" + w["name"],
                                       config=c["name"], traffic=t["name"]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append("tiny-" + w["name"])
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


# each platform's ``reads`` keys (EMA src/techs.c): barcode bases, or for
# integer barcodes the range they are drawn from (a TruSeq SLR plate's
# 384 wells)
PLATFORM_READS = {"10x": {"bc_len": 16}, "dbs": {"bc_len": 20},
                  "tellseq": {"bc_len": 18}, "haplotag": {"bc_len": 12},
                  "tru": {"bc_len": 0, "bc_range": [1, 384]},
                  "cpt": {"bc_len": 0, "bc_range": [1, 384]}}


def add_platform_cell(root: str, platform: str) -> str:
    """A tiny stream cell ``tiny-<platform>`` under a tiny root, added as
    files: the tiny stream configuration with the platform and its
    barcodes, on the tiny ``linked-wgs`` mix.  Returns the cell's name."""
    here = os.path.join(root, "ema_bench")
    name = "tiny-" + platform
    c = json.load(open(os.path.join(here, "configs",
                                    "tiny-tenx-chr20-stream.json")))
    c["name"] = name
    c["platform"] = platform
    c["reads"].pop("bc_range", None)
    c["reads"].update(PLATFORM_READS[platform])
    json.dump(c, open(os.path.join(here, "configs", name + ".json"), "w"))
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    if all(w["name"] != name for w in bench["workloads"]):
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": "tiny-linked-wgs", "chips": 1,
                                   "why": f"a tiny {platform} stream cell"})
        json.dump(bench, open(path, "w"))
    return name


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("bench")))
