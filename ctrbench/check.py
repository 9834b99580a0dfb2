"""The comparison that decides ``correct`` for a training cell.

The program's first steps (the set-up's, through the window's own
``train_step`` on rows that all differ) are held against the plain
reference's same steps from the same parameters and rows:

  loss_gap    the worst step's |loss - reference loss| / |reference loss|;
  grad_gap    the first gradient's norm, as the optimizer got it (the
              square root of Adagrad's accumulator after one step), by
              the worst leaf: |norm - reference norm| over the larger of
              the reference's norm of that leaf and of the median leaf;
  change_gap  the same gap of the norm of each leaf's change over the
              steps (the state step 4 starts from), of the median leaf:
              by the worst leaf it swings from seed to seed with the
              round-off of one leaf's later steps (PERF.md); leaves whose
              reference gradient is under a thousandth of the median
              leaf's are left out (they move by round-off alone);
  accum_diff  the norm of the difference of the accumulators after one
              step over the larger of the reference's norm of that leaf
              and of the median leaf: the number that tells a lower
              precision from this one, where the gaps of norms average
              rounding away.

Each number has a limit of its own, set from the program's readings over
many seeds and from the control's and the planted faults'
(``limits/<workload>.json``; ``PERF.md`` gives the readings).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "accum_diff")

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of ``change_gap``
NOUGHT = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def _host(tree: Dict) -> Dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def readings(prog: Dict, ref: Dict, params0: Dict,
             detail: bool = False) -> Dict:
    """The four numbers (with ``detail``, also each leaf's under
    ``leaves``).  ``prog`` and ``ref`` each hold ``losses`` (one a
    step), ``accum1`` (the accumulators after the first step) and
    ``params`` (after the last); ``params0`` the parameters both began
    from.  Flat leaf names; tensors on any device."""
    p_acc, r_acc = _host(prog["accum1"]), _host(ref["accum1"])
    p_par, r_par = _host(prog["params"]), _host(ref["params"])
    p0 = _host(params0)
    leaves = sorted(r_acc)
    missing = set(leaves) ^ set(p_acc)
    if missing:
        raise KeyError(f"leaves on one side only: {sorted(missing)}")
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf

    def sqrt_sum(t):
        return math.sqrt(max(float(t.to(torch.float64).sum()), 0.0))

    g_p = {k: sqrt_sum(p_acc[k]) for k in leaves}
    g_r = {k: sqrt_sum(r_acc[k]) for k in leaves}
    g_med = statistics.median(g_r.values())
    grad_gap = max(abs(g_p[k] - g_r[k]) / max(g_r[k], g_med, 1e-30)
                   for k in leaves)

    moved = [k for k in leaves if g_r[k] >= NOUGHT * g_med]
    c_p = {k: _norm(p_par[k].to(torch.float64) - p0[k].to(torch.float64))
           for k in moved}
    c_r = {k: _norm(r_par[k].to(torch.float64) - p0[k].to(torch.float64))
           for k in moved}
    c_med = statistics.median(c_r.values())
    c_gap = {k: abs(c_p[k] - c_r[k]) / max(c_r[k], c_med, 1e-30)
             for k in moved}
    change_gap = statistics.median(c_gap.values())

    a_r = {k: _norm(r_acc[k]) for k in leaves}
    a_med = statistics.median(a_r.values())
    accum_diff = max(
        _norm(p_acc[k].to(torch.float64) - r_acc[k].to(torch.float64))
        / max(a_r[k], a_med, 1e-30) for k in leaves)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap,
           "change_gap": change_gap, "accum_diff": accum_diff}
    if detail:
        out["change_gap_worst_leaf"] = max(c_gap.values())
        out["leaves"] = {k: {
            "grad": [g_p[k], g_r[k]], "change": [c_p.get(k), c_r.get(k)],
            "accum_diff": _norm(p_acc[k].to(torch.float64)
                                - r_acc[k].to(torch.float64)) / a_r[k]
            if a_r[k] > 0 else None} for k in leaves}
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{name: {"value", "limit", "ok"}}`` in ``NUMBERS``' order; a
    number that is not finite fails."""
    out = {}
    for name in NUMBERS:
        v, lim = values[name], float(limits[name])
        out[name] = {"value": v, "limit": lim,
                     "ok": bool(math.isfinite(v) and v <= lim)}
    return out
