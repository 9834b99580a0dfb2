"""Rank programs of the port's multi-rank tests, run in spawned worlds.

``tests/test_torch_collectives.py``, ``tests/test_torch_dp_trainer.py``
and ``tests/test_torch_attention.py`` start one world of W gloo ranks on
the CPU per module (through the port's launcher,
``lightctr_tpu_torch.core.mesh.spawn_world``); every rank runs one of the
programs below, which builds the scenario inputs from a numpy seed and
saves what it computed as ``rank<r>.pt`` in the test's directory.  The
tests then hold rank 0's results against the JAX package on its 8-device
CPU mesh, and every rank's against rank 0's.

Spawn re-imports this module in every child, so it imports neither JAX nor
the JAX package (``tests/test_torch_imports.py`` checks).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh, shard_batch
from lightctr_tpu_torch.dist import collectives as tcoll
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.nn.ring_attention import ring_self_attention

TABLES = {"w": ["fids"], "v": ["fids"]}
#: one world's deadline; a hang fails in this many seconds
DEADLINE_S = 120.0


def fm_batch(seed, n=64, f=4096, nnz=6):
    """tests/test_sparse_exchange.py's FM batch, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "fids": rng.integers(0, f, size=(n, nnz)).astype(np.int32),
        "vals": rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32),
        "mask": np.ones((n, nnz), np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
    }


def fm_params(f, k, seed=0):
    """FM's init (W zero, V ~ N(0, 1/k)) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"w": np.zeros(f, np.float32),
            "v": (rng.standard_normal((f, k)) / np.sqrt(k)).astype(
                np.float32)}


def exchange_inputs(world, seed=0):
    """Per-rank payloads of the collective scenarios: heavy cross-rank id
    overlap, a sum-mode case with id-0 pads (one rank's real id 0), and a
    gradient tree for the ring."""
    rng = np.random.default_rng(seed)
    k, dim = 16, 5
    uids = rng.integers(0, 32, size=(world, k)).astype(np.int32)
    rows = rng.normal(size=(world, k, dim)).astype(np.float32)
    pad_uids = np.zeros((world, 8), np.int32)
    pad_rows = np.zeros((world, 8, 3), np.float32)
    pad_rows[0, 0] = 1.0
    for m in range(1, world):
        pad_uids[m, 0], pad_uids[m, 1] = 2 * m, 2 * m + 1
        pad_rows[m, 0], pad_rows[m, 1] = m, -m
    # deduped streams (sorted unique, padded with id 0) for the EF carry
    dd_uids = np.zeros((world, k), np.int32)
    for m in range(world):
        u = np.unique(rng.integers(1, 48, size=k))
        dd_uids[m, :u.size] = u
    dd_rows = (rng.normal(size=(world, k, dim)) * 0.8).astype(np.float32)
    dd_rows[dd_uids == 0] = 0.0
    dd_rows[:, 0] = rng.normal(size=(world, dim)).astype(np.float32)
    tree = [{"a": rng.normal(size=(world, 6, 3)).astype(np.float32),
             "b": rng.normal(size=(world, 7)).astype(np.float32)}
            for _ in range(3)]
    return {"uids": uids, "rows": rows, "pad_uids": pad_uids,
            "pad_rows": pad_rows, "dd_uids": dd_uids, "dd_rows": dd_rows,
            "tree": tree}


def _save(out_dir, rank, results):
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _np(x):
    return x.detach().cpu().numpy().copy()


def collectives_rank(rank, world, out_dir):
    """Every collective scenario on this rank's slice of
    :func:`exchange_inputs`."""
    mesh = make_mesh(MeshSpec(data=world), device="cpu")
    inp = exchange_inputs(world)
    t = {k: torch.from_numpy(v[rank]) for k, v in inp.items()
         if k != "tree"}
    out = {}
    gu, m = tcoll.sparse_all_reduce(mesh, t["uids"], t["rows"])
    out["exact"] = (_np(gu), _np(m))
    gu, m = tcoll.sparse_all_reduce(mesh, t["pad_uids"], t["pad_rows"],
                                    average=False)
    out["sum_pads"] = (_np(gu), _np(m))
    for bits, mode in ((16, "uniform"), (8, "normal")):
        gu, m = tcoll.sparse_all_reduce(mesh, t["uids"], t["rows"],
                                        compress_bits=bits,
                                        compress_range="dynamic",
                                        compress_mode=mode)
        out[f"coded{bits}"] = (_np(gu), _np(m))
    # a fixed-range 8-bit exchange with the EF carry, twice (the second
    # call compensates with the first call's clip remainder)
    res = tcoll.sparse_ef_residual_init(mesh, (48, 5))
    steps = []
    for _ in range(2):
        gu, m, res = tcoll.sparse_all_reduce(
            mesh, t["dd_uids"], t["dd_rows"], compress_bits=8,
            compress_range=1.0, compress_mode="uniform", residual=res)
        steps.append((_np(gu), _np(m), _np(res)))
    out["ef"] = steps
    # the ring: plain mean, and coded + EF over three calls
    trees = [{k: torch.from_numpy(v[rank]) for k, v in tr.items()}
             for tr in inp["tree"]]
    out["ring_plain"] = {k: _np(v) for k, v in
                         tcoll.ring_all_reduce(mesh, trees[0]).items()}
    out["psum"] = {k: _np(v) for k, v in
                   tcoll.psum_all_reduce(mesh, trees[0]).items()}
    for mode in ("uniform", "normal"):
        res = tcoll.ef_residual_init(mesh, trees[0])
        calls = []
        for tr in trees:
            red, res = tcoll.ring_all_reduce(
                mesh, tr, compress_bits=8, compress_range="dynamic",
                compress_mode=mode, residual=res)
            calls.append(({k: _np(v) for k, v in red.items()}, _np(res)))
        out[f"ring_ef_{mode}"] = calls
    _save(out_dir, rank, out)


# -- trainers ----------------------------------------------------------------

#: name -> (model width f, trainer kwargs): the scenarios of the trainer
#: world, each stepped over TRAINER_STEPS batches from one init
TRAINER_CASES = {
    "sparse_exact": (4096, {}),
    "dense_pick": (32, {}),
    "coded_dynamic": (4096, {"compress_bits": 8,
                             "compress_range": "dynamic"}),
    "coded_ef": (4096, {"compress_bits": 8}),
}
TRAINER_STEPS = 3
#: name -> kwargs of the CTRTrainer(mesh=...) cases
DENSE_CASES = {
    "dense_mean": {},
    "dense_fused": {"fused_adagrad": True},
    "dense_ring": {"compress_bits": 8, "compress_range": "dynamic"},
}
CFG = {"learning_rate": 0.1, "lambda_l2": 0.001}


def trainer_batches(f):
    return [fm_batch(10 + i, f=f) for i in range(TRAINER_STEPS)]


def trainers_rank(rank, world, out_dir, carry_path):
    """The hybrid sparse trainer in each of :data:`TRAINER_CASES`, the
    dense trainer with the plain mean and with the coded ring, and a
    restart from the JAX trainer's mesh state (``carry_path``)."""
    mesh = make_mesh(MeshSpec(data=world), device="cpu")
    cfg = TrainConfig(**CFG)
    out = {}
    for name, (f, kw) in TRAINER_CASES.items():
        tr = SparseTableCTRTrainer(
            tfm.params_from_numpy(fm_params(f, 4), "cpu"), tfm.logits, cfg,
            sparse_tables=TABLES, fused_fn=tfm.logits_with_l2, mesh=mesh,
            **kw)
        tr.health = None
        losses = [float(tr.train_step(b)) for b in trainer_batches(f)]
        out[name] = {"loss": losses, "w": _np(tr.params["w"]),
                     "v": _np(tr.params["v"]),
                     "accum_v": _np(tr.opt_state["accum"]["v"]),
                     "policy": dict(tr.exchange_policy),
                     "bytes": dict(tr.exchange_bytes_per_step)}
    for name, kw in DENSE_CASES.items():
        tr = CTRTrainer(tfm.params_from_numpy(fm_params(512, 4), "cpu"),
                        tfm.logits, cfg, fused_fn=tfm.logits_with_l2,
                        mesh=mesh, **kw)
        tr.health = None
        losses = list(tr.fit_fullbatch_scan(fm_batch(20, f=512), 4))
        held = fm_batch(21, n=40, f=512)
        out[name] = {"loss": losses, "w": _np(tr.params["w"]),
                     "v": _np(tr.params["v"]),
                     "proba": tr.predict_proba(held),
                     "eval": tr.evaluate(held)}
    # a shape whose pick is the reduce-scatter exchange at 4 ranks (v at
    # vocab 1024, dim 32, 384 ids a rank): not ported, so the step raises
    # on every rank before any collective
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(fm_params(1024, 32), "cpu"), tfm.logits, cfg,
        sparse_tables=TABLES, fused_fn=tfm.logits_with_l2, mesh=mesh)
    tr.health = None
    try:
        out["rs_pick"] = {"loss": float(tr.train_step(
            fm_batch(40, n=64 * world, f=1024))), "error": None}
    except ValueError as e:
        out["rs_pick"] = {"loss": None, "error": str(e)}
    # the weight carry-over: continue from the JAX trainer's params and
    # mesh optimizer state (EF residuals included), one step
    carry = torch.load(carry_path, weights_only=False)
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(carry["params"], "cpu"), tfm.logits, cfg,
        sparse_tables=TABLES, fused_fn=tfm.logits_with_l2, mesh=mesh,
        **carry["kw"])
    tr.health = None
    tr.opt_state = tfm.opt_state_from_numpy(carry["state"], "cpu",
                                            rank=rank)
    loss = float(tr.train_step(carry["batch"]))
    out["carry"] = {"loss": loss, "w": _np(tr.params["w"]),
                    "v": _np(tr.params["v"]),
                    "sres_v": _np(tr.opt_state["sres"]["v"])}
    _save(out_dir, rank, out)


# -- ring attention -----------------------------------------------------------

#: [B, T, H, D] of the ring scenarios (tests/test_ring_attention.py's)
ATTN_SHAPE = (2, 32, 2, 8)
#: a sequence length no ring of 2 or 4 divides
ATTN_BAD_T = 33


def attention_inputs(seed=0):
    """q, k, v of :data:`ATTN_SHAPE` from a numpy seed, unit normal."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=ATTN_SHAPE).astype(np.float32) for _ in range(3)]


def attention_rank(rank, world, out_dir):
    """``ring_self_attention`` over a ``seq`` mesh of every rank: float32
    with and without the causal mask, bfloat16 causal (its blocks cross
    gloo as bytes), the indivisible-T error, and the refusal of a function
    that needs the ``data`` axis."""
    mesh = make_mesh(MeshSpec(seq=world), device="cpu")
    q, k, v = (torch.from_numpy(x) for x in attention_inputs())
    out = {"axis": mesh.axis}
    for causal in (False, True):
        out[f"causal{int(causal)}"] = _np(
            ring_self_attention(mesh, q, k, v, causal=causal))
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    got = ring_self_attention(mesh, *bf, causal=True)
    out["bf16_dtype"] = str(got.dtype)
    out["bf16_causal"] = _np(got.float())
    bad = torch.zeros((2, ATTN_BAD_T, 2, 8))
    try:
        ring_self_attention(mesh, bad, bad, bad)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        shard_batch(mesh, {"x": np.zeros(4 * world)})
        out["data_axis"] = None
    except ValueError as e:
        out["data_axis"] = str(e)
    _save(out_dir, rank, out)
