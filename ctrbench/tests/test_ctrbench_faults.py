"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped (the CPU rehearsal path), the rest
of a run driven, once for each fault a training cell can have."""

import copy
import json
import os

import pytest

from conftest import REPO, cells, run_tiny
from ctrbench import run as bench

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = cells(json.load(_f))


def state_unchanged(trainer):
    """The step runs on copies and hands back the state it was given."""
    step = trainer._step

    def frozen(params, opt_state, batch):
        _, _, loss, health = step(copy.deepcopy(params),
                                  copy.deepcopy(opt_state), batch)
        return params, opt_state, loss, health

    trainer._step = frozen
    return trainer


def half_batch(trainer):
    """Half of each batch left out: the step's mean is over the rest."""
    put = trainer._put

    def first_half(batch, **kw):
        n = len(batch["labels"]) // 2
        return put({k: v[:n] for k, v in batch.items()}, **kw)

    trainer._put = first_half
    return trainer


def plant(monkeypatch, fault):
    """Every trainer a system adapter builds goes through ``fault``."""
    load = bench.Cell.module

    def module(self, kind, name):
        mod = load(self, kind, name)
        if kind == "systems":
            build = mod.build
            mod.build = lambda *a, **kw: fault(build(*a, **kw))
        return mod

    monkeypatch.setattr(bench.Cell, "module", module)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tiny, workload, fault, monkeypatch):
    root, manifest = tiny
    plant(monkeypatch, fault)
    out = run_tiny(root, manifest, workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
