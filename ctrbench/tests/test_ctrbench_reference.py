"""Each configuration's plain reference against lightctr_tpu_torch on the
CPU at a tiny size: the program's first steps through ``train_step`` and
the reference's from the same parameters and rows agree to float32
round-off; the control and the planted faults do not."""

import json
import os

import pytest
import torch

from conftest import REPO, cells
from ctrbench import check
from ctrbench import run as bench

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)
CELLS = cells(MANIFEST)
#: the program and the reference on the CPU sum in float32, in orders
#: that differ: every number stays under this
ROUND_OFF = 1e-5


def _setup(root, manifest, workload):
    cell = bench.Cell(manifest, workload, root=root)
    train = cell.module("loops", cell.traffic["loop"])
    st = train.setup(cell, 11, torch.device("cpu"))
    ref = train.reference(cell, st, torch.device("cpu"), "exact")
    return cell, train, st, ref


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(tiny, workload):
    root, manifest = tiny
    cell, _, st, ref = _setup(root, manifest, workload)
    values = check.readings(st["prog"], ref, st["params0"])
    assert set(values) == set(check.NUMBERS)
    for name, v in values.items():
        assert v < ROUND_OFF, (name, v)
    # the steps moved every leaf, and the losses are the steps'
    assert len(ref["losses"]) == cell.traffic["check_steps"]
    for k, p in ref["params"].items():
        assert not torch.equal(p, st["params0"][k]), k


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cells_limits(tiny, workload):
    """The reference put in the program's place in the configuration's
    lower precision (bfloat16 for FM, TF32 for Wide&Deep) fails at least
    one of the cell's limits."""
    root, manifest = tiny
    cell, train, st, ref = _setup(root, manifest, workload)
    side = train.reference(cell, st, torch.device("cpu"), "control")
    judged = check.judge(check.readings(side, ref, st["params0"]),
                         cell.limits)
    assert not all(c["ok"] for c in judged.values()), judged


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from ctrbench.reference import common

    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)])
    got = common.round_tf32(x)
    # representable, a tie to even (down), a tie to even (up), below half
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0]
