"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
with its cells shrunk to a size the CPU runs in a second, and the
manifest that names them."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ctrbench import run as bench  # noqa: E402

#: the shrunk sizes: vocabulary, widths and rows (the layout stays)
TINY = {"vocab": 4096, "factor_dim": 8, "hidden": 64, "batch": 512,
        "pool_rows": 4096}


def shrink_config(cfg):
    k = TINY["factor_dim"]
    cfg["vocab"], cfg["factor_dim"] = TINY["vocab"], k
    for t in cfg["tables"].values():
        if t["dim"] > 1:
            t["dim"] = k
    if cfg["dense_layers"]:
        fields = cfg["layout"]["fields"]
        cfg["hidden"] = TINY["hidden"]
        cfg["dense_layers"] = [[fields * k, TINY["hidden"]],
                               [TINY["hidden"], 1]]
    return cfg


def shrink_traffic(t):
    t.update(batch=TINY["batch"], pool_rows=TINY["pool_rows"],
             warmup_steps=1, profiled_warmup_steps=1, profiled_steps=3)
    return t


def _rewrite(path, fn):
    with open(path) as f:
        data = fn(json.load(f))
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture
def tiny(tmp_path):
    """``(root, manifest)``: a shrunk copy of the benchmark's folder and
    the repository's manifest."""
    root = str(tmp_path / "ctrbench")
    shutil.copytree(bench.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in os.listdir(os.path.join(root, "configs")):
        _rewrite(os.path.join(root, "configs", name), shrink_config)
    for name in os.listdir(os.path.join(root, "traffic")):
        _rewrite(os.path.join(root, "traffic", name), shrink_traffic)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    return root, manifest


def cells(manifest):
    return [w["name"] for w in manifest["workloads"]]


def run_tiny(root, manifest, workload, trace=False, seed=7):
    import time

    import torch

    cell = bench.Cell(manifest, workload, root=root)
    return bench.run_cell(cell, seed, 0.2, trace, torch.device("cpu"),
                          time.time())
