"""Rank programs of the port's two-level exchange tests, run in spawned
worlds.

A host of the hierarchical exchange is one ``torch.distributed`` group of
``local_n`` ranks.  ``tests/test_torch_hier.py`` starts two worlds of
:data:`WORLD` gloo ranks on the CPU (host 0 and host 1, each through
``lightctr_tpu_torch.core.mesh.spawn_world``) against reduce shards that
the test process hosts; for every case of :data:`HIER_CASES` each world
cuts a group of the case's ``local_n`` ranks, whose ranks build the same
trainer (the same constructor call, ``hier_exchange=`` a client of the
case's shards) and step it on their host's half of one batch.  Each rank
saves what it computed as ``host<h>_rank<r>.pt``.

Spawn re-imports this module in every child, so it imports neither JAX nor
the JAX package (``tests/test_torch_imports.py`` checks).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
from lightctr_tpu_torch.dist.hier import HierExchangeClient
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.obs import MetricsRegistry

TABLES = {"w": ["fids"], "v": ["fids"]}
#: ranks a host world holds: the largest ``local_n`` of the cases
WORLD = 4
#: a host world's deadline; a hang fails in this many seconds
DEADLINE_S = 150.0

#: name -> the case: ranks a host, the client's codec and chunk rows, the
#: reduce shards' package (the test process hosts them) and count, steps,
#: FM width, rows of the two hosts' batch together, ids a row, learning
#: rate, the batch seed, and whether host 0's ids are skewed onto local
#: owner 0 (the local reduce-scatter's overflow)
HIER_CASES = {
    "r2": dict(local_n=2, codec="f32", chunk_rows=None, shards="port",
               n_shards=2, steps=4, f=512, dim=8, rows=256, nnz=4,
               lr=0.1, seed=0, skew=False),
    "r4": dict(local_n=4, codec="f32", chunk_rows=None, shards="jax",
               n_shards=2, steps=4, f=512, dim=8, rows=256, nnz=4,
               lr=0.1, seed=0, skew=False),
    "q8": dict(local_n=2, codec="q8_ef", chunk_rows=None, shards="jax",
               n_shards=2, steps=4, f=512, dim=8, rows=256, nnz=4,
               lr=0.1, seed=0, skew=False),
    "qs": dict(local_n=2, codec="q8_ef", chunk_rows=16, shards="port",
               n_shards=2, steps=4, f=512, dim=8, rows=256, nnz=4,
               lr=0.1, seed=0, skew=False),
    "fb": dict(local_n=4, codec="f32", chunk_rows=None, shards="port",
               n_shards=1, steps=3, f=2048, dim=16, rows=1024, nnz=8,
               lr=0.05, seed=1, skew=True),
}

#: the lone case: host 0 alone against shards that wait for two hosts, a
#: short pull timeout — rank 0's pull must fail, and every rank with it
LONE = dict(local_n=2, n_shards=1, f=64, dim=4, rows=32, nnz=4,
            pull_timeout_s=1.0)


def fm_batch(seed, n_rows, f, nnz, skew_local_n=None):
    """tests/test_hier_exchange.py's FM batch (ids in [1, f), unit values,
    alternating labels), from a numpy seed; ``skew_local_n`` moves the
    first half's ids onto multiples of it (local owner 0)."""
    rng = np.random.default_rng(seed)
    fids = rng.integers(1, f, size=(n_rows, nnz)).astype(np.int32)
    if skew_local_n:
        half = n_rows // 2
        fids[:half] = (np.maximum(fids[:half] // skew_local_n, 1)
                       * skew_local_n).astype(np.int32)
    return {
        "fids": fids, "fields": np.zeros_like(fids),
        "vals": np.ones((n_rows, nnz), np.float32),
        "mask": np.ones((n_rows, nnz), np.float32),
        "labels": (np.arange(n_rows) % 2).astype(np.float32),
    }


def fm_params(f, dim, seed=0):
    """FM's init (W zero, V ~ N(0, 1/k)) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"w": np.zeros(f, np.float32),
            "v": (rng.standard_normal((f, dim)) / np.sqrt(dim)).astype(
                np.float32)}


def case_batch(case):
    return fm_batch(case["seed"], case["rows"], case["f"], case["nnz"],
                    case["local_n"] if case["skew"] else None)


def host_half(batch, host_id):
    n = len(batch["labels"]) // 2
    return {k: v[host_id * n:(host_id + 1) * n] for k, v in batch.items()}


def _np(x):
    return x.detach().cpu().numpy().copy()


def _trainer(case, mesh, client, registry):
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(fm_params(case["f"], case["dim"]), "cpu"),
        tfm.logits, TrainConfig(learning_rate=case["lr"]),
        sparse_tables=TABLES, fused_fn=tfm.logits_with_l2, mesh=mesh,
        hier_exchange=client)
    tr.health = None
    tr.telemetry = registry
    return tr


def _run_case(case, rank, host_id, addrs):
    group = dist.new_group(list(range(case["local_n"])))
    if rank >= case["local_n"]:
        return None
    mesh = make_mesh(MeshSpec(data=case["local_n"]), device="cpu",
                     group=group)
    client = HierExchangeClient(addrs, host_id=host_id, n_hosts=2,
                                codec=case["codec"],
                                chunk_rows=case["chunk_rows"])
    reg = MetricsRegistry()
    try:
        tr = _trainer(case, mesh, client, reg)
        half = host_half(case_batch(case), host_id)
        losses = [float(tr.train_step(half)) for _ in range(case["steps"])]
        out = {
            "losses": np.asarray(losses, np.float64),
            "w": _np(tr.params["w"]), "v": _np(tr.params["v"]),
            "policy": dict(tr.exchange_policy),
            "local_policy": dict(tr.hier_local_policy),
            "fb_local_policy": dict(tr._hier_fb_local_policy),
            "wire_model_bytes": int(sum(tr.exchange_bytes_per_step.values())
                                    + tr._hier_wire_dense_bytes),
            "bytes_per_step": dict(tr.exchange_bytes_per_step),
            "socket_bytes": int(client.bytes_sent + client.bytes_received),
            "connected": client.connected,
            "carry_mass": float(client.carry_mass()),
            "carry_max": {t: float(c.max_abs())
                          for t, c in client._carry.items()},
            "id_saved": int(client.shared_id_saved_bytes),
            "chunk_pushes": int(client.chunk_pushes_total),
            "chunk_rows": int(client.chunk_rows_total),
            "chunk_capacity": int(client.chunk_capacity_rows_total),
            "snapshot": reg.snapshot(),
            "plan": tr._hier_local_plan(half),
            "fits": tr._rs_batch_fits(half, tr._hier_local_plan(half)),
        }
    finally:
        client.close()
    return out


def _run_lone(rank, addrs):
    case = LONE
    group = dist.new_group(list(range(case["local_n"])))
    if rank >= case["local_n"]:
        return None
    mesh = make_mesh(MeshSpec(data=case["local_n"]), device="cpu",
                     group=group)
    client = HierExchangeClient(addrs, host_id=0, n_hosts=2,
                                pull_timeout_s=case["pull_timeout_s"])
    try:
        tr = SparseTableCTRTrainer(
            tfm.params_from_numpy(fm_params(case["f"], case["dim"]), "cpu"),
            tfm.logits, TrainConfig(learning_rate=0.1),
            sparse_tables=TABLES, fused_fn=tfm.logits_with_l2, mesh=mesh,
            hier_exchange=client)
        tr.health = None
        batch = fm_batch(5, case["rows"], case["f"], case["nnz"])
        v0 = _np(tr.params["v"])
        try:
            tr.train_step(host_half(batch, 0))
            err = None
        except Exception as e:  # what each rank raised
            err = f"{type(e).__name__}: {e}"
        return {"error": err, "v_moved": bool(
            (_np(tr.params["v"]) != v0).any()),
                "connected": client.connected}
    finally:
        client.close()


def hier_rank(rank, world, host_id, out_dir, addrs_by_case):
    """Every case of :data:`HIER_CASES` on this host (then, on host 0, the
    lone case of :data:`LONE`); saves ``{case: results}``."""
    out = {}
    for name, case in HIER_CASES.items():
        addrs = [tuple(a) for a in addrs_by_case[name]]
        out[name] = _run_case(case, rank, host_id, addrs)
    if host_id == 0:
        out["lone"] = _run_lone(rank,
                                [tuple(a) for a in addrs_by_case["lone"]])
    torch.save(out, os.path.join(out_dir, f"host{host_id}_rank{rank}.pt"))


def hier_repeat_step_rank(rank, world, out_dir, addrs):
    """One step of the two-level exchange (one host of ``world`` ranks on
    this rank's card, the fp32 wire: a coded wire's EF carries live in the
    client and the shards, outside the trainer's state) run twice from
    the same state: a fresh
    trainer steps one batch, its state is copied, it steps a second batch,
    the copy is restored and it steps the second batch again.  Saves the
    tables and accumulators after each of the two runs as
    ``host0_rank<r>.pt``."""
    from lightctr_tpu_torch.optim.updaters import tree_map

    mesh = make_mesh(MeshSpec(data=world))
    torch.cuda.set_device(mesh.device)
    client = HierExchangeClient([tuple(a) for a in addrs], host_id=0,
                                n_hosts=1)
    try:
        tr = SparseTableCTRTrainer(
            tfm.params_from_numpy(fm_params(4096, 32), mesh.device),
            tfm.logits, TrainConfig(learning_rate=0.1, lambda_l2=0.001),
            sparse_tables=TABLES, fused_fn=tfm.logits_with_l2, mesh=mesh,
            hier_exchange=client)
        tr.health = None
        tr.train_step(fm_batch(0, 128, 4096, 39))
        saved = tree_map(torch.clone, (tr.params, tr.opt_state))
        runs = []
        for _ in range(2):
            tr.params, tr.opt_state = tree_map(torch.clone, saved)
            tr.train_step(fm_batch(1, 128, 4096, 39))
            runs.append({k: _np(t) for k, t in (
                ("w", tr.params["w"]), ("v", tr.params["v"]),
                ("accum_w", tr.opt_state["accum"]["w"]),
                ("accum_v", tr.opt_state["accum"]["v"]))})
    finally:
        client.close()
    torch.save(runs, os.path.join(out_dir, f"host0_rank{rank}.pt"))
