"""Import isolation and the manifest's shape: no module of the benchmark
imports JAX or the JAX package (top-level names compared whole: the
port's name begins with the JAX package's), the references import nothing
of the port, and every name the manifest gives has its file."""

import ast
import json
import os
import re

import pytest

from conftest import REPO
from ctrbench import run as bench

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lightctr_tpu"}
HERE = bench.HERE


def _modules():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_in_the_benchmark(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_references_import_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "lightctr_tpu_torch" not in set(
                _imports(os.path.join(ref, f))), f


def _manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_names_and_files():
    m = _manifest()
    assert m["command"][:3] == ["python3", "-m", "ctrbench.run"]
    assert m["paths"] == ["ctrbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(HERE, "reference",
                                           f"{c['name']}.py"))
        assert os.path.exists(os.path.join(HERE, "systems",
                                           f"{cfg['model']}.py"))
    for w in m["workloads"]:
        assert len(w["why"]) <= 200
        for kind, name in (("traffic", w["traffic"]),
                           ("limits", w["name"])):
            assert os.path.exists(os.path.join(HERE, kind, f"{name}.json"))
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25


@pytest.mark.parametrize("metric", [x["name"]
                                    for x in _manifest()["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    """A reader file with ``read`` alone: the metric's layer, unit and
    ``moves`` are the manifest's."""
    m = {x["name"]: x for x in _manifest()["per_layer"]}[metric]
    reader = bench.load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                               "reader")
    assert callable(reader.read)
    for attr in ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES"):
        assert not hasattr(reader, attr), attr
    assert m["moves"] in {x["name"] for x in _manifest()["end_to_end"]}
