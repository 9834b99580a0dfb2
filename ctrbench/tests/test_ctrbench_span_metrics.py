"""The per-layer metrics that read the program's phase spans: each reader
on a synthetic summary, and the traced CPU rehearsal of every cell, where
each of them but the input wait (a wait for a card's stream) reads."""

import json
import os

import pytest

from conftest import REPO, cells, run_tiny
from ctrbench import run as bench

#: metric -> the span it reads
SPAN_METRICS = {
    "input.wait_ms_per_step": "trainer/input_wait",
    "host.dedup_gather_ms_per_step": "sparse_tables/dedup_gather",
    "host.forward_ms_per_step": "trainer/forward",
    "host.backward_ms_per_step": "trainer/backward",
    "host.optimizer_ms_per_step": "trainer/optimizer",
    "host.record_span_ms_per_step": "trainer/record",
}
#: the spans a CPU run has: no card, so no wait before a pageable put
ON_THE_CPU = sorted(set(SPAN_METRICS) - {"input.wait_ms_per_step"})

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)


def _reader(metric):
    return bench.load_module(
        os.path.join(bench.HERE, "metrics", f"{metric}.py"), "reader")


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_reader_is_its_span_per_step(metric):
    read = _reader(metric).read
    other = {"trainer/input": [0.5, 20], "trainer/exec": [0.7, 20]}
    spans = dict(other, **{SPAN_METRICS[metric]: [0.025, 20]})
    assert read({"profiled": {"spans": spans, "steps": 20}}) == \
        pytest.approx(1.25)
    # the parent commit's trace: the span absent, the metric left out
    assert read({"profiled": {"spans": other, "steps": 20}}) is None
    assert read({"profiled": {"spans": spans, "steps": 0}}) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_manifest_entry(metric):
    m = {x["name"]: x for x in MANIFEST["per_layer"]}[metric]
    assert m["source"] == "program_span" and m["unit"] == "ms"
    assert m["moves"] == "examples_per_s" and m["better"] == "lower"
    assert m["workloads"] == cells(MANIFEST)


@pytest.mark.parametrize("workload", cells(MANIFEST))
def test_traced_rehearsal_reads_the_phase_spans(tiny, workload):
    root, manifest = tiny
    out = run_tiny(root, manifest, workload, trace=True)
    assert out["correct"] is True
    got = out["metrics"]
    for metric in ON_THE_CPU:
        assert got[metric]["value"] > 0, metric
    assert "input.wait_ms_per_step" not in got
    # the metric that reads the record as a difference of spans still reads
    assert got["host.record_ms_per_step"]["value"] > 0
