"""Rank programs of ``tests/test_torch_sharded.py``: parameters sharded over
ranks, run in one spawned world of 4 gloo ranks on the CPU.

Every rank builds three meshes over the same 4 ranks — ``MeshSpec(data=2,
embed=2)`` (the sharded layout), ``MeshSpec(data=4)`` (``zero_sharded``,
the exchanges) and ``MeshSpec(data=2, seq=2)`` (ring attention over the seq
view) — runs every scenario below from numpy inputs, and saves what it
computed as ``rank<r>.pt``.  The test holds rank 0's results (and each
rank's block) against the JAX package on a 4-device CPU mesh, and the
ranks against each other.

Spawn re-imports this module in every child, so it imports neither JAX nor
the JAX package (``tests/test_torch_imports.py`` checks).
"""

from __future__ import annotations

import os

import numpy as np
import torch

import torch_dp_worlds as dpw
from lightctr_tpu_torch import ckpt
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.mesh import (AXES, MeshSpec, embed_sharding,
                                          make_mesh, replicated, shard_batch)
from lightctr_tpu_torch.dist import collectives as tcoll
from lightctr_tpu_torch.embed import table as ttable
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models import widedeep as twidedeep
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.nn.ring_attention import ring_self_attention
from lightctr_tpu_torch.optim import updaters

WORLD = 4
SHARDED = MeshSpec(data=2, embed=2)
DATA = MeshSpec(data=WORLD)
DATA_SEQ = MeshSpec(data=2, seq=2)
DEADLINE_S = 120.0

#: the table of the layout and lookup cases, and an F no embed axis of 2
#: divides
TABLE_ROWS, TABLE_DIM, UNEVEN_ROWS = 64, 3, 65
#: ids a data index looks up (repeats and the real row 0 included)
LOOKUP_IDS = (7, 11)

#: the trainers' steps (the JAX tests' counts)
SHARDED_STEPS = 10      # test_sharded_trainer.py
CKPT_STEPS, RESUME_STEPS = 10, 5    # test_sharded_ckpt.py
ZERO_STEPS, ZERO_WD_STEPS = 15, 12  # test_zero_sharded.py
SPARSE_STEPS = 12       # test_sparse_trainer.py:103-149
CARRY_STEPS = 2
ZERO_F = 513            # odd: the flat length pads to a multiple of 4
EF_STEPS = 12           # test_compressed_ring.py's EF case


def _np(x):
    return x.detach().cpu().numpy().copy()


def _save(out_dir, rank, results):
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


# -- inputs (numpy, shared with the JAX side) ----------------------------------


def layout_batch():
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(8, 3)).astype(np.float32),
            "y": np.arange(8, dtype=np.int32)}


def lookup_ids(data_index):
    """[4, 5] ids of one data index: repeats, the real row 0, both
    blocks."""
    rng = np.random.default_rng(LOOKUP_IDS[data_index])
    ids = rng.integers(0, TABLE_ROWS, size=(4, 5)).astype(np.int32)
    ids[0, :2] = 0
    ids[1, 0] = ids[2, 3] = TABLE_ROWS - 1
    return ids


def lookup_table(dim=TABLE_DIM, seed=4):
    rng = np.random.default_rng(seed)
    shape = (TABLE_ROWS, dim) if dim else (TABLE_ROWS,)
    return rng.normal(size=shape).astype(np.float32)


def lookup_weights(data_index, dim=TABLE_DIM):
    rng = np.random.default_rng(20 + data_index)
    shape = (4, 5, dim) if dim else (4, 5)
    return rng.normal(size=shape).astype(np.float32)


def a2a_inputs(n=WORLD):
    """tests/test_all_to_all.py's payloads for a world of ``n`` from a
    numpy seed: [n, n, ...] stacks, row i this rank's outgoing blocks."""
    rng = np.random.default_rng(0)
    rows_per_shard, dim, k = 16, 3, 5
    table = rng.normal(size=(n * rows_per_shard, dim)).astype(np.float32)
    reqs = rng.integers(0, n * rows_per_shard, size=(n, n, k)).astype(
        np.int32)
    reqs = reqs % rows_per_shard + (np.arange(n)[None, :, None]
                                    * rows_per_shard)
    return {
        "transpose": rng.normal(size=(n, n, 3, 2)).astype(np.float32),
        "roundtrip": rng.normal(size=(n, n, 5)).astype(np.float32),
        "table": table, "reqs": reqs, "rows_per_shard": rows_per_shard,
        "coded": (rng.normal(size=(n, n, 6, 3)) * 0.2).astype(
            np.float32).clip(-1, 1),
        "tiny": (rng.normal(size=(n, n, 6, 3)) * 1e-3).astype(np.float32),
    }


def broadcast_tree(n=WORLD):
    """[n, ...] stacks: rank r's tree is slice r of every leaf."""
    rng = np.random.default_rng(8)
    return {"a": rng.normal(size=(n, 6)).astype(np.float32),
            "b": {"c": rng.integers(0, 100, size=(n, 2, 3)).astype(np.int32)}}


def ring_tree(scale, n=WORLD):
    """test_compressed_ring.py's [n, 501] gradient stack."""
    rng = np.random.default_rng(0)
    return {"g": (rng.normal(size=(n, 501)).astype(np.float32) * scale)}


def fm_batch(rng, n=64, f=512, nnz=6, lo=0):
    """test_zero_sharded.py's / test_sharded_ckpt.py's FM batch."""
    return {
        "fids": rng.integers(lo, f, size=(n, nnz)).astype(np.int32),
        "fields": np.zeros((n, nnz), np.int32),
        "vals": np.ones((n, nnz), np.float32),
        "mask": np.ones((n, nnz), np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
    }


def zero_batch():
    return fm_batch(np.random.default_rng(0), f=ZERO_F)


def ckpt_batch():
    return fm_batch(np.random.default_rng(1), f=128, nnz=4, lo=1)


def wd_batch():
    """test_zero_sharded.py's Wide&Deep batch (f 128, 4 fields, nnz 6)."""
    rng = np.random.default_rng(2)
    n, f, field_cnt, nnz = 64, 128, 4, 6
    fids = rng.integers(1, f, size=(n, nnz)).astype(np.int32)
    fields = rng.integers(0, field_cnt, size=(n, nnz)).astype(np.int32)
    mask = np.ones((n, nnz), np.float32)
    rep, rep_mask = twidedeep.field_representatives(fids, fields, mask,
                                                    field_cnt)
    return {"fids": fids, "fields": fields,
            "vals": np.ones((n, nnz), np.float32), "mask": mask,
            "labels": (rng.random(n) > 0.5).astype(np.float32),
            "rep_fids": rep, "rep_mask": rep_mask}


def wd_params(f=128, fields=4, d=8, hidden=16, seed=5):
    """Wide&Deep's init from a numpy seed (the JAX package's
    distributions), W and the biases non-zero so every term counts."""
    rng = np.random.default_rng(seed)

    def layer(n_in, n_out):
        return {"w": (rng.random((n_out, n_in)) - 0.5).astype(np.float32),
                "b": rng.normal(0, 0.1, n_out).astype(np.float32)}

    return {"w": rng.normal(0, 0.1, f).astype(np.float32),
            "embed": (rng.standard_normal((f, d)) / np.sqrt(d)).astype(
                np.float32),
            "fc1": layer(fields * d, hidden), "fc2": layer(hidden, 1)}


WD_CFG = {"learning_rate": 0.1}
ZERO_CFG = {"learning_rate": 0.1, "lambda_l2": 0.001}
WD_TABLES = {"w": ["fids"], "embed": ["rep_fids"]}


def wd_placements(mesh):
    return {"w": embed_sharding(mesh), "embed": embed_sharding(mesh),
            "fc1": {"w": replicated(mesh), "b": replicated(mesh)},
            "fc2": {"w": replicated(mesh), "b": replicated(mesh)}}


def fm_placements(mesh):
    return {"w": embed_sharding(mesh), "v": embed_sharding(mesh)}


def zero_params():
    return dpw.fm_params(ZERO_F, 4)


def ckpt_params():
    return dpw.fm_params(128, 4, seed=0)


def block_of(x):
    """(block, offset) of a ShardedTable leaf, the array and 0 of a
    replicated one."""
    if isinstance(x, ttable.ShardedTable):
        return _np(x.local), x.offset
    return _np(x), 0


def tree_blocks(tree, prefix=""):
    """{"fc1/w": (array, offset), ...} of a params or state tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_blocks(v, f"{prefix}{k}/"))
    elif isinstance(tree, tuple):
        for k, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            out.update(tree_blocks(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = block_of(tree)
    return out


# -- the scenarios ---------------------------------------------------------------


def _layout(se, rank):
    out = {"coords": se.coords(), "axis": se.axis, "groups": {}}
    for a in AXES:
        v = se.view(a)
        out["groups"][a] = [v.global_rank(i) for i in range(v.size)]
    out["shard_batch"] = {k: _np(v)
                          for k, v in shard_batch(se, layout_batch()).items()}
    gen = torch.Generator().manual_seed(5)
    t = ttable.init_table(gen, TABLE_ROWS, TABLE_DIM, mesh=se)
    whole = ttable.init_table(torch.Generator().manual_seed(5), TABLE_ROWS,
                              TABLE_DIM)
    out["init"] = {"block": _np(t.local), "offset": t.offset,
                   "num_rows": t.num_rows, "whole": _np(whole),
                   "gathered": _np(ttable.gather_table(t))}
    try:
        ttable.init_table(torch.Generator().manual_seed(5), UNEVEN_ROWS,
                          TABLE_DIM, mesh=se)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def _exchanges(dm, rank):
    inp = a2a_inputs()
    r = rank
    ex = tcoll.all_to_all_exchange
    out = {"transpose": _np(ex(dm, torch.from_numpy(inp["transpose"][r]))),
           "roundtrip": _np(ex(dm, ex(dm, torch.from_numpy(
               inp["roundtrip"][r]))))}
    try:
        ex(dm, torch.zeros((3, 2)))
        out["bad_shape"] = None
    except ValueError as e:
        out["bad_shape"] = str(e)
    # the PS pull: route the requests, serve the local rows, route back
    rps = inp["rows_per_shard"]
    shard = torch.from_numpy(inp["table"][r * rps:(r + 1) * rps])
    routed = ex(dm, torch.from_numpy(inp["reqs"][r]))
    served = shard[(routed % rps).long()]
    out["lookup"] = _np(ex(dm, served))
    coded = torch.from_numpy(inp["coded"][r])
    out["coded16"] = _np(ex(dm, coded, compress_bits=16))
    out["coded8"] = _np(ex(dm, coded, compress_bits=8))
    try:
        ex(dm, torch.zeros((WORLD, 2), dtype=torch.int32), compress_bits=8)
        out["int_payload"] = None
    except ValueError as e:
        out["int_payload"] = str(e)
    tiny = torch.from_numpy(inp["tiny"][r])
    out["tiny_fixed"] = _np(ex(dm, tiny, compress_bits=8, compress_range=1.0))
    out["tiny_dynamic"] = _np(ex(dm, tiny, compress_bits=8,
                                 compress_range="dynamic"))
    stacks = broadcast_tree()
    mine = {"a": torch.from_numpy(stacks["a"][r]),
            "b": {"c": torch.from_numpy(stacks["b"]["c"][r])}}
    got = tcoll.ring_broadcast(dm, mine)
    out["broadcast"] = {"a": _np(got["a"]), "c": _np(got["b"]["c"])}
    return out


def _compressed_ring(dm, rank):
    """test_compressed_ring.py's ring cases on this rank's row."""
    ring = tcoll.ring_all_reduce
    g = {"g": torch.from_numpy(ring_tree(0.1)["g"][rank])}
    out = {"exact": _np(ring(dm, g)["g"]),
           "int8": _np(ring(dm, g, compress_bits=8,
                            compress_range=1.0)["g"]),
           "int16": _np(ring(dm, g, compress_bits=16,
                             compress_range=1.0)["g"])}
    res = tcoll.ef_residual_init(dm, g)
    plain, ef = [], []
    for _ in range(EF_STEPS):
        plain.append(_np(ring(dm, g, compress_bits=8,
                              compress_range=1.0)["g"]))
        o, res = ring(dm, g, compress_bits=8, compress_range=1.0,
                      residual=res)
        ef.append(_np(o["g"]))
    out["plain_steps"], out["ef_steps"] = plain, ef
    one, _ = ring(dm, g, compress_bits=8, compress_range=1.0,
                  residual=tcoll.ef_residual_init(dm, g))
    out["ef_one"] = _np(one["g"])
    tiny = {"g": torch.from_numpy(ring_tree(1e-3)["g"][rank])}
    out["tiny_exact"] = _np(ring(dm, tiny)["g"])
    out["tiny_fixed"] = _np(ring(dm, tiny, compress_bits=8,
                                 compress_range=1.0)["g"])
    out["tiny_dynamic"] = _np(ring(dm, tiny, compress_bits=8,
                                   compress_range="dynamic")["g"])
    out["tiny_normal"] = _np(ring(dm, tiny, compress_bits=8,
                                  compress_range="dynamic",
                                  compress_mode="normal")["g"])
    return out


def _lookup(se):
    """The sharded pull and its gradient, for a [F, d] and an [F] table."""
    d_idx = se.view("data").rank
    ids = torch.from_numpy(lookup_ids(d_idx))
    out = {}
    for name, dim in (("rows", TABLE_DIM), ("flat", 0)):
        full = lookup_table(dim)
        t = ttable.shard_rows(full, se, device="cpu")
        leaf = t.local.clone().requires_grad_(True)
        got = ttable.lookup(t.with_local(leaf), ids)
        w = torch.from_numpy(lookup_weights(d_idx, dim))
        (got * w).sum().backward()
        out[name] = {"out": _np(got), "grad": _np(leaf.grad),
                     "offset": t.offset}
    return out


def _wd_sharded(se):
    """test_sharded_trainer.py: Wide&Deep's CTRTrainer with its tables
    row-sharded, SHARDED_STEPS full-batch steps, then evaluate and
    predict_proba."""
    cfg = TrainConfig(**WD_CFG)
    tr = CTRTrainer(_common.params_from_numpy(wd_params(), "cpu"),
                    twidedeep.logits, cfg, mesh=se,
                    param_shardings=wd_placements(se), device="cpu")
    tr.health = None
    batch = wd_batch()
    losses = tr.fit_fullbatch_scan(batch, SHARDED_STEPS)
    out = {"loss": np.asarray(losses), "params": tree_blocks(tr.params),
           "state": tree_blocks(tr.opt_state),
           "eval": tr.evaluate(batch), "proba": tr.predict_proba(batch)}
    tr.reset(_common.params_from_numpy(wd_params(), "cpu"))
    out["reset"] = {"params": tree_blocks(tr.params),
                    "state": tree_blocks(tr.opt_state)}
    return out


def _ckpt(se, rank, ckpt_dir):
    """test_sharded_ckpt.py: FM sharded, CKPT_STEPS steps, saved; a fresh
    sharded trainer restores and resumes RESUME_STEPS; a one-device
    trainer (on rank 0) restores the same files, and a one-device
    checkpoint restores into a sharded trainer."""
    import torch.distributed as dist

    cfg = TrainConfig(learning_rate=0.1)
    pl = fm_placements(se)
    batch = ckpt_batch()
    tr = CTRTrainer(_common.params_from_numpy(ckpt_params(), "cpu"),
                    tfm.logits, cfg, mesh=se, param_shardings=pl,
                    device="cpu")
    tr.health = None
    tr.fit_fullbatch_scan(batch, CKPT_STEPS)
    before = tr.evaluate(batch)
    sharded_dir = os.path.join(ckpt_dir, "sharded")
    ckpt.save(sharded_dir, CKPT_STEPS,
              {"params": tr.params, "opt_state": tr.opt_state})
    fresh = _common.params_from_numpy(dpw.fm_params(128, 4, seed=9), "cpu")
    tr2 = CTRTrainer(fresh, tfm.logits, cfg, mesh=se, param_shardings=pl,
                     device="cpu")
    tr2.health = None
    state = ckpt.restore(sharded_dir, like={"params": tr2.params,
                                            "opt_state": tr2.opt_state})
    tr2.params, tr2.opt_state = state["params"], state["opt_state"]
    after = tr2.evaluate(batch)
    resumed = tr2.fit_fullbatch_scan(batch, RESUME_STEPS)
    out = {"before": before, "after": after, "resumed": np.asarray(resumed),
           "restored_v": block_of(state["params"]["v"]),
           "is_sharded": isinstance(state["params"]["v"],
                                    ttable.ShardedTable)}
    # the same files into a one-device trainer (rank 0 alone)
    if rank == 0:
        one = CTRTrainer(fresh, tfm.logits, cfg, device="cpu")
        one.health = None
        st = ckpt.restore(sharded_dir, like={"params": one.params,
                                             "opt_state": one.opt_state})
        one.params, one.opt_state = st["params"], st["opt_state"]
        out["one_device_eval"] = one.evaluate(batch)
        out["one_device_v"] = _np(one.params["v"])
        ckpt.save(os.path.join(ckpt_dir, "one"), 3,
                  {"params": one.params, "opt_state": one.opt_state})
    dist.barrier()
    # and a one-device checkpoint into a sharded trainer
    tr3 = CTRTrainer(fresh, tfm.logits, cfg, mesh=se, param_shardings=pl,
                     device="cpu")
    tr3.health = None
    st = ckpt.restore(os.path.join(ckpt_dir, "one"),
                      like={"params": tr3.params, "opt_state": tr3.opt_state})
    tr3.params, tr3.opt_state = st["params"], st["opt_state"]
    out["back_eval"] = tr3.evaluate(batch)
    out["back_v"] = block_of(tr3.params["v"])
    return out


def _zero(dm):
    """test_zero_sharded.py's four cases on the data axis of 4."""
    cfg = TrainConfig(**ZERO_CFG)
    p = _common.params_from_numpy(zero_params(), "cpu")
    batch = zero_batch()
    plain = CTRTrainer(p, tfm.logits, cfg, fused_fn=tfm.logits_with_l2,
                       mesh=dm, device="cpu")
    zero = CTRTrainer(p, tfm.logits, cfg, fused_fn=tfm.logits_with_l2,
                      mesh=dm, zero_sharded=True, device="cpu")
    plain.health = zero.health = None
    out = {"plain_loss": plain.fit_fullbatch_scan(batch, ZERO_STEPS),
           "zero_loss": zero.fit_fullbatch_scan(batch, ZERO_STEPS),
           "zero_w": _np(zero.params["w"]), "zero_v": _np(zero.params["v"]),
           "plain_w": _np(plain.params["w"]),
           "plain_v": _np(plain.params["v"]),
           "zero_accum": _np(zero.opt_state.accum),
           "zero_pad": zero._zero_pad,
           "plain_state_bytes": sum(
               x.numel() * x.element_size()
               for x in updaters.tree_leaves(plain.opt_state))}
    refusals = {}
    for name, kw in (("compress_bits", {"compress_bits": 8}),
                     ("adam", {"optimizer": updaters.adam(0.1)})):
        try:
            CTRTrainer(p, tfm.logits, cfg, mesh=dm, zero_sharded=True,
                       device="cpu", **kw)
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    wd = CTRTrainer(_common.params_from_numpy(wd_params(), "cpu"),
                    twidedeep.logits, TrainConfig(**WD_CFG), mesh=dm,
                    zero_sharded=True, device="cpu")
    wd.health = None
    out["wd_loss"] = wd.fit_fullbatch_scan(wd_batch(), ZERO_WD_STEPS)
    return out


def _sparse(se):
    """test_sparse_trainer.py:103-149: Wide&Deep's sparse trainer with its
    tables row-sharded, SPARSE_STEPS full-batch steps; then the weight
    carry-over of the JAX init through the placements."""
    cfg = TrainConfig(**WD_CFG)
    pl = wd_placements(se)
    batch = wd_batch()
    tr = SparseTableCTRTrainer(
        _common.params_from_numpy(wd_params(), "cpu"), twidedeep.logits,
        cfg, sparse_tables=WD_TABLES, mesh=se, param_shardings=pl,
        device="cpu")
    tr.health = None
    losses = tr.fit_fullbatch_scan(batch, SPARSE_STEPS)
    out = {"loss": np.asarray(losses), "params": tree_blocks(tr.params),
           "accum": tree_blocks(tr.opt_state["accum"]),
           "eval": tr.evaluate(batch)}
    return out


def _carry(se, carry_path):
    """The weight carry-over: each rank takes its blocks of the JAX
    sparse trainer's params and state (after CARRY_STEPS steps) through the
    placements and steps once more."""
    carry = torch.load(carry_path, weights_only=False)
    pl = wd_placements(se)
    params = _common.params_from_numpy(carry["params"], "cpu", placements=pl)
    tr = SparseTableCTRTrainer(params, twidedeep.logits,
                               TrainConfig(**WD_CFG), sparse_tables=WD_TABLES,
                               mesh=se, param_shardings=pl, device="cpu")
    tr.health = None
    tr.opt_state = _common.opt_state_from_numpy(carry["state"], "cpu",
                                                placements=pl)
    loss = float(tr.train_step(carry["batch"]))
    return {"loss": loss, "params": tree_blocks(tr.params),
            "accum": tree_blocks(tr.opt_state["accum"]),
            "sharded": isinstance(params["embed"], ttable.ShardedTable)}


def _ring(sq):
    """Ring attention over the seq view of a data x seq mesh."""
    q, k, v = (torch.from_numpy(x) for x in dpw.attention_inputs())
    return {"causal": _np(ring_self_attention(sq, q, k, v, causal=True)),
            "seq_group": [sq.view("seq").global_rank(i) for i in range(2)]}


def sharded_rank(rank, world, out_dir, carry_path):
    """Every scenario on this rank (module docstring)."""
    se = make_mesh(SHARDED, device="cpu")
    dm = make_mesh(DATA, device="cpu")
    sq = make_mesh(DATA_SEQ, device="cpu")
    out = {"layout": _layout(se, rank), "exchanges": _exchanges(dm, rank),
           "ring_reduce": _compressed_ring(dm, rank), "lookup": _lookup(se),
           "wd_sharded": _wd_sharded(se),
           "ckpt": _ckpt(se, rank, os.path.join(out_dir, "ckpt")),
           "zero": _zero(dm), "sparse": _sparse(se),
           "carry": _carry(se, carry_path), "ring": _ring(sq)}
    _save(out_dir, rank, out)
