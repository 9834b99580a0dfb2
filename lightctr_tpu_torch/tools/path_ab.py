"""A/B of two checkouts' host-bound paths on one card: the ring attention
call, the data-parallel steps and the one-card training steps.

Each root named on the command line is a checkout of the repo (the tree
under test, or a parent unpacked with ``git archive``).  For each, in the
order given, a fresh process imports that checkout's ``chip_smoke.py``,
builds its kernels and spawns its own rank functions, so the numbers time
that checkout's code at ``chip_smoke.py``'s shapes:

  ``ring_rank``  ring attention over a ``seq`` ring of 2 gloo ranks on the
                 card, (2, 4096, 8, 64) bf16 causal; rank 0's median call
                 of three (host clock, synchronised);
  ``dp_rank``    FM at Criteo width trained over 2 gloo ranks on the card,
                 its three runs (exact, 8-bit dynamic range, 8-bit with
                 EF) at the smoke's steps; each run's steady step on each
                 rank (steps 4 onward);
  ``train``      the train phase's two trainers on one card, health feed
                 off, 20 steps each: ``SparseTableCTRTrainer`` and
                 ``CTRTrainer(fused_adagrad=True)``; the steady step (steps
                 4 onward, synchronised) and its median host launch time.

Step times on this path move between hosts by more than the change under
test, so compare roots only within one run, in an order such as parent,
change, change, parent.  One JSON line a root on stdout, then a summary
line with each root's medians on rank 0.

    python -m lightctr_tpu_torch.tools.path_ab ROOT [ROOT ...]
"""

from __future__ import annotations

import statistics
import sys

from lightctr_tpu_torch.tools import ab_roots

#: what runs in each root's process (argv: root), at chip_smoke's seed 0
_CHILD = r"""
import json, os, shutil, sys, tempfile, time
root, seed = sys.argv[1], 0
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from lightctr_tpu_torch.core.mesh import spawn_world
from lightctr_tpu_torch.native import bindings
from lightctr_tpu_torch.ops import sparse_kernels as sk
if not torch.cuda.is_available():
    sys.exit("path_ab: CUDA is not available")
sk.build_all()
bindings.available()
tmp = tempfile.mkdtemp(prefix="path_ab_")
try:
    t = time.perf_counter()
    spawn_world(cs.ring_rank, cs.RING_WORLD, "gloo",
                deadline_s=cs.DP_DEADLINE_S, args=(tmp, seed))
    ring_s = time.perf_counter() - t
    ring = [torch.load(os.path.join(tmp, f"ring{r}.pt"))["step_ms"]
            for r in range(cs.RING_WORLD)]
    steps = {name: n for name, _, n in cs.DP_RUNS}
    spawn_world(cs.dp_rank, cs.DP_WORLD, "gloo",
                deadline_s=cs.DP_DEADLINE_S,
                args=(tmp, seed, "cuda", steps))
    dp = {name: [] for name in steps}
    for r in range(cs.DP_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            recs = json.load(f)
        for name, rec in recs.items():
            dp[name].append(1e3 * rec["steady_wall_s"] / rec["steady_steps"])
finally:
    shutil.rmtree(tmp, ignore_errors=True)
import numpy as np
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import fm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
rng = np.random.default_rng(seed + 2)
n = 20
data = cs.criteo_rows(np, rng, n * cs.TRAIN_BATCH)
batches = [{k: v[i * cs.TRAIN_BATCH:(i + 1) * cs.TRAIN_BATCH]
            for k, v in data.items()} for i in range(n)]
params = cs.train_params(np, seed)
cfg = TrainConfig(learning_rate=cs.LR, lambda_l2=cs.LAMBDA_L2)
train = {}
for name in ("sparse", "fused"):
    p = fm.params_from_numpy(params, "cuda")
    if name == "sparse":
        tr = SparseTableCTRTrainer(p, fm.logits, cfg,
                                   sparse_tables={"w": ["fids"],
                                                  "v": ["fids"]},
                                   fused_fn=fm.logits_with_l2, device="cuda")
    else:
        tr = CTRTrainer(p, fm.logits, cfg, fused_fn=fm.logits_with_l2,
                        fused_adagrad=True, device="cuda")
    tr.health = None
    _, _, wall, host = cs.run_steps(torch, tr, batches)
    train[name] = {"step_ms": 1e3 * wall / (n - cs.WARMUP_STEPS),
                   "host_launch_ms": 1e3 * host}
    del tr, p
    torch.cuda.empty_cache()
print(json.dumps({"root": root, "ring_call_ms": ring,
                  "ring_world_seconds": ring_s, "dp_steps": steps,
                  "dp_step_ms": dp, "train": train}), flush=True)
"""


def run_root(root: str) -> dict:
    """Time ``root``'s ring call and dp steps in a process of its own."""
    return ab_roots.run_root("path_ab", _CHILD, root)


def summarize(recs: list) -> dict:
    """One root's medians on rank 0."""
    return {"ring_call_ms_rank0": statistics.median(
                r["ring_call_ms"][0] for r in recs),
            "dp_step_ms_rank0": {
                name: statistics.median(r["dp_step_ms"][name][0]
                                        for r in recs)
                for name in recs[0]["dp_step_ms"]},
            "train": {
                name: {k: statistics.median(r["train"][name][k]
                                            for r in recs)
                       for k in ("step_ms", "host_launch_ms")}
                for name in recs[0]["train"]}}


def main(argv=None) -> int:
    return ab_roots.main(__doc__, run_root, summarize, argv)


if __name__ == "__main__":
    sys.exit(main())
