"""The readings a cell's limits for ``correct`` are set from, in one
process: the program's check steps over many seeds, and, on some of them,
the control and the planted faults, each the reference put in the
program's place.

    python3 -m ctrbench.control --workload fm-criteo.b65536 \\
        --seeds 101-112 --faults 3 [--witness]

For each seed the set-up is the run's own (``loops/train.setup``: the
parameters, the pool, the trainer and its first steps through
``train_step``), then ``check.readings`` of the program against the
reference.  On the first ``--faults`` seeds the reference also runs as the
control (the configuration's lower precision: bfloat16 for FM, TF32 for
Wide&Deep), with half of each batch left out (the mean over the rest),
and with its state left unchanged, each read against the reference.  No
window runs: training's readings need none.  It takes the card, as the
run does.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from ctrbench import check
from ctrbench.run import CHECKOUT, Cell

FAULT_MODES = ("control", "half", "frozen")


def seed_list(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def readings(cell: Cell, seed: int, device, faults: bool,
             witness: bool = False) -> dict:
    import torch

    train = cell.module("loops", cell.traffic["loop"])
    st = train.setup(cell, seed, device)
    st["trainer"] = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = train.reference(cell, st, device, "exact")
    rec = {"seed": seed,
           "program": check.readings(st["prog"], ref, st["params0"],
                                     detail=True)}
    if witness:
        # a second witness: the reference again in float64, against which
        # both the program and the float32 reference are read
        st64 = dict(st, params0={k: v.double()
                                 for k, v in st["params0"].items()})
        ref64 = train.reference(cell, st64, device, "exact")
        rec["program_vs_f64"] = check.readings(st["prog"], ref64,
                                               st64["params0"], detail=True)
        rec["reference_vs_f64"] = check.readings(ref, ref64, st64["params0"],
                                                 detail=True)
    if faults:
        for mode in FAULT_MODES:
            side = train.reference(cell, st, device, mode)
            rec[mode] = check.readings(side, ref, st["params0"],
                                       detail=True)
    return rec


def summarize(records) -> dict:
    """The program's largest reading of each number (the lower reading)
    and the smallest of the control's and of each fault's."""
    out = {"program_max": {}, "seeds": len(records)}
    for n in check.NUMBERS:
        out["program_max"][n] = max(r["program"][n] for r in records)
    for mode in FAULT_MODES:
        got = [r[mode] for r in records if mode in r]
        if got:
            out[f"{mode}_min"] = {n: min(g[n] for g in got)
                                  for n in check.NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112,7")
    ap.add_argument("--faults", type=int, default=3,
                    help="read the control and the faults on this many of "
                    "the first seeds")
    ap.add_argument("--witness", action="store_true",
                    help="also read both sides against a float64 reference")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ctrbench.control: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        cell = Cell(json.load(f), args.workload)
    records = []
    for i, seed in enumerate(seed_list(args.seeds)):
        t0 = time.perf_counter()
        rec = readings(cell, seed, torch.device("cuda"), i < args.faults,
                       args.witness)
        rec["workload"] = args.workload
        rec["seconds"] = time.perf_counter() - t0
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summarize(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
