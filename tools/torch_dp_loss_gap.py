"""FM at Criteo width trained data-parallel over 2 ranks by both packages on
the CPU, on ``chip_smoke.py``'s data and runs: the JAX package's
``SparseTableCTRTrainer`` on a 2-device CPU mesh and the port's on a
spawned 2-rank gloo world (``chip_smoke.dp_rank`` with the plain versions).
Prints one JSON object: each package's losses per run and each coded run's
final-loss gap to the exact run at the same step.

    python -m tools.torch_dp_loss_gap [--steps 10] [--seed 0]

It shows what the coded exchanges do to the loss at this width in the
reference itself, beside the port.  CPU only, a few minutes.
"""

from __future__ import annotations

from lightctr_tpu.utils.devicecheck import pin_cpu_platform

pin_cpu_platform(2)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from lightctr_tpu import TrainConfig  # noqa: E402
from lightctr_tpu.core.mesh import MeshSpec, make_mesh  # noqa: E402
from lightctr_tpu.models import fm  # noqa: E402
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer  # noqa: E402
from lightctr_tpu_torch.core.mesh import spawn_world  # noqa: E402


def jax_losses(seed: int, steps: int) -> dict:
    batches, _ = cs.dp_data(np, seed)
    params = cs.train_params(np, seed)
    mesh = make_mesh(MeshSpec(data=cs.DP_WORLD))
    out = {}
    for name, kw, _ in cs.DP_RUNS:
        tr = SparseTableCTRTrainer(
            {k: jnp.asarray(v) for k, v in params.items()}, fm.logits,
            TrainConfig(learning_rate=cs.LR, lambda_l2=cs.LAMBDA_L2),
            sparse_tables={"w": ["fids"], "v": ["fids"]},
            fused_fn=fm.logits_with_l2, mesh=mesh, **kw)
        tr.health = None
        out[name] = [float(tr.train_step(b)) for b in batches[:steps]]
    return out


def port_losses(seed: int, steps: int) -> dict:
    with tempfile.TemporaryDirectory() as d:
        spawn_world(cs.dp_rank, cs.DP_WORLD, "gloo", deadline_s=3600,
                    timeout_s=600,
                    args=(d, seed, "cpu",
                          {name: steps for name, _, _ in cs.DP_RUNS}))
        with open(os.path.join(d, "rank0.json")) as f:
            return {k: v["losses"] for k, v in json.load(f).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = {"world": cs.DP_WORLD, "batch": cs.TRAIN_BATCH, "vocab": cs.VOCAB,
           "factor_dim": cs.DIM, "steps": args.steps, "device": "cpu"}
    for pkg, fn in (("jax", jax_losses), ("port", port_losses)):
        losses = fn(args.seed, args.steps)
        res[pkg] = {
            "losses": losses,
            "final_loss_gap_vs_exact": {
                name: abs(v[-1] - losses["exact"][-1])
                for name, v in losses.items() if name != "exact"}}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
