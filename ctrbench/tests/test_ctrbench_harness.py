"""The harness on the CPU rehearsal path, at a tiny size: every cell's
result line, cells found by name from files, and the refusals."""

import json
import os
import shutil
import sys

import pytest
import torch

from conftest import REPO, cells, run_tiny
from ctrbench import run as bench

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)
CELLS = cells(MANIFEST)
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(tiny, workload, trace):
    root, manifest = tiny
    out = run_tiny(root, manifest, workload, trace=trace)
    keys = list(out)
    assert keys[:5] == list(REQUIRED)
    assert keys[-1] == "checks"
    assert ("breakdown" in out) == trace
    assert set(keys) == set(REQUIRED) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    want = (bench.Cell(manifest, workload).per_layer if trace
            else bench.Cell(manifest, workload).end_to_end)
    units = {m["name"]: m["unit"] for m in want}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if not trace:
        # every end-to-end metric of the cell, from the host's clock
        assert set(out["metrics"]) == set(units)
        assert out["metrics"]["setup_s"]["value"] > 0
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        for rows in out["breakdown"].values():
            assert len(rows) <= 10
    dev = out["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_added_files_are_found_and_run(tiny):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files (and manifest entries) run without an edit to any file
    that was there."""
    root, manifest = tiny
    shutil.copy(os.path.join(root, "configs", "fm-criteo.json"),
                os.path.join(root, "configs", "fm-small.json"))
    with open(os.path.join(root, "configs", "fm-small.json")) as f:
        cfg = json.load(f)
    cfg.update(name="fm-small", vocab=2048)
    with open(os.path.join(root, "configs", "fm-small.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(root, "reference", "fm-criteo.py"),
                os.path.join(root, "reference", "fm-small.py"))
    with open(os.path.join(root, "traffic", "b65536.json")) as f:
        mix = json.load(f)
    mix.update(name="flat", batch=256)
    mix["ids"] = dict(mix["ids"], exponent=0.0)
    with open(os.path.join(root, "traffic", "flat.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "metrics", "host.calls_per_s.py"), "w") as f:
        f.write('def read(summary):\n'
                '    w = summary["window"]\n'
                '    return w["steps"] / w["wall_s"]\n')
    name = "fm-small.flat"
    shutil.copy(os.path.join(root, "limits", "fm-criteo.b65536.json"),
                os.path.join(root, "limits", f"{name}.json"))
    manifest["configs"].append(dict(manifest["configs"][0], name="fm-small",
                                    file="ctrbench/configs/fm-small.json"))
    manifest["workloads"].append({"name": name, "config": "fm-small",
                                  "traffic": "flat", "chips": 1,
                                  "why": "uniform ids"})
    manifest["per_layer"].append({
        "name": "host.calls_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "host", "moves": "examples_per_s",
        "workloads": [name]})
    manifest["end_to_end"][0].setdefault("workloads", []).append(name) \
        if "workloads" in manifest["end_to_end"][0] else None
    out = run_tiny(root, manifest, name, trace=True)
    assert out["correct"] is True
    assert out["metrics"]["host.calls_per_s"]["value"] > 0
    e2e = run_tiny(root, manifest, name)
    assert "examples_per_s" in e2e["metrics"]
    assert "step_ms_p95" not in e2e["metrics"]


def test_flat_ids_touch_more_rows(tiny):
    """The generator reads its id distribution from the mix: exponent 0
    draws each field's values uniformly, which touches more rows than the
    skewed default; the same seed gives the same pool."""
    import numpy as np

    from ctrbench import generate

    root, manifest = tiny
    cell = bench.Cell(manifest, CELLS[0], root=root)
    skew = generate.make_pool(cell.traffic, cell.config, 3, "cpu")
    flat = generate.make_pool(
        dict(cell.traffic, ids=dict(cell.traffic["ids"], exponent=0.0)),
        cell.config, 3, "cpu")
    n_cat = cell.config["layout"]["categorical"]
    rows = cell.traffic["batch"] // 4
    assert np.unique(flat["fids"][:rows, :n_cat]).size > \
        np.unique(skew["fids"][:rows, :n_cat]).size
    again = generate.make_pool(cell.traffic, cell.config, 3, "cpu")
    for k in skew:
        assert np.array_equal(skew[k], again[k])


def test_each_field_keeps_its_own_rows():
    """At the cells' size each categorical field's ids stay in a range of
    its own, at most its published number of values wide; the numeric
    fields' ids lie past them all; the table is filled, not exceeded."""
    import numpy as np

    from ctrbench import generate

    cell = bench.Cell(MANIFEST, CELLS[0])
    cfg, mix = cell.config, cell.traffic
    cards = mix["ids"]["cardinalities"]
    n_cat = cfg["layout"]["categorical"]
    n_num = cfg["layout"]["fields"] - n_cat
    rows = generate.field_rows(cards, cfg["vocab"] - n_num)
    assert sum(rows) + n_num <= cfg["vocab"]
    assert sum(rows) + n_num > 0.99 * cfg["vocab"]
    pool = generate.make_pool(dict(mix, pool_rows=8192), cfg, 2**31 + 9,
                              "cpu")
    base = np.concatenate([[0], np.cumsum(rows)])
    for j, card in enumerate(cards):
        col = pool["fids"][:, j]
        assert col.min() >= base[j] and col.max() < base[j + 1]
        assert rows[j] <= card
    assert (pool["fids"][:, n_cat:] >= base[-1]).all()


def test_exponent_matches_the_count10_feature_figure():
    """The mix's exponent puts about 0.999 M values at an expected count
    of 10 or more over Criteo-Kaggle's 45,840,617 rows (AutoInt's 998,960
    features kept after a count-10 threshold)."""
    import numpy as np

    mix = bench.Cell(MANIFEST, CELLS[0]).traffic["ids"]
    s, kept = mix["exponent"], 0
    for n in mix["cardinalities"]:
        edges = np.arange(1, n + 2, dtype=np.float64)
        cdf = (edges ** (1 - s) - 1) / ((n + 1.0) ** (1 - s) - 1)
        kept += int((45_840_617 * np.diff(cdf) >= 10).sum())
    assert abs(kept - 998_960) < 0.02 * 998_960


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    rc = bench.main(["--workload", CELLS[0], "--seed", str(2**31 + 5),
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import lightctr_tpu_torch  # noqa: F401  the port's name starts alike

    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench.forbidden_modules() == ["jax"]
