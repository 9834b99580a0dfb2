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

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh, shard_batch
from lightctr_tpu_torch.dist import collectives as tcoll
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import deepfm as tdeepfm
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models import widedeep as twidedeep
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


def convention_pairs(rng, n, vocab, k, dim, lo=1):
    """Per-rank (uids, rows) of the dedup convention (sorted unique ids,
    trailing slots id 0 with zero rows), tests/test_sparse_rs.py's."""
    uids = np.zeros((n, k), np.int32)
    rows = np.zeros((n, k, dim), np.float32)
    for m in range(n):
        u = np.unique(rng.integers(lo, vocab, size=k))
        uids[m, :u.size] = u
        rows[m, :u.size] = rng.normal(size=(u.size, dim))
    return uids, rows


def rs_cases(world, seed=1):
    """name -> (uids [W, K], rows [W, K, dim], kwargs) of the
    reduce-scatter scenarios called once (tests/test_sparse_rs.py's):
    the mean, a hot id pool merged in sum mode, id-0 pads beside a real
    id 0 under a bucket of 2, the 16-bit and 8-bit coded payloads, and a
    bucket overflow whose victim the stage-1 carry keeps."""
    rng = np.random.default_rng(seed)
    n = world
    cases = {}
    u, r = convention_pairs(rng, n, 256, 32, 5)
    cases["mean"] = (u, r, {"bucket_cap": 32,
                            "shard_cap": min(n * 32, 256 // n + 2)})
    u, r = convention_pairs(rng, n, 32, 16, 3)  # heavy overlap
    cases["dup_sum"] = (u, r, {"bucket_cap": 16, "shard_cap": n * 16,
                               "average": False})
    u = np.zeros((n, 8), np.int32)
    r = np.zeros((n, 8, 3), np.float32)
    r[0, 0] = 1.0  # rank 0: a real id-0 row, then padding
    for m in range(1, n):
        u[m, 0], u[m, 1] = 2 * m, 2 * m + 1
        r[m, 0], r[m, 1] = m, -m
    cases["pads_sum"] = (u, r, {"bucket_cap": 2, "shard_cap": 6,
                                "average": False})
    u, r = convention_pairs(rng, n, 128, 16, 4)
    for bits, mode in ((16, "uniform"), (8, "normal")):
        cases[f"coded{bits}"] = (u, r, {
            "bucket_cap": 16, "shard_cap": n * 16, "compress_bits": bits,
            "compress_range": "dynamic", "compress_mode": mode})
    # owners 1, 1, 1 at 2 and 4 ranks: uid 9 overflows a bucket of 2
    u = np.tile(np.array([1, 5, 9, 0], np.int32), (n, 1))
    r = 0.5 * np.ones((n, 4, 2), np.float32)
    r[:, 3] = 0.0
    cases["overflow_ef"] = (u, r, {
        "vocab": 32, "bucket_cap": 2, "shard_cap": 8, "compress_bits": 8,
        "compress_range": 1.0, "residual": True})
    return cases


#: name -> (per-rank spike value, dim, rounds, kwargs, carries) of the
#: EF drain scenarios (tests/test_sparse_rs.py's): one id an owner, the
#: spike in round 0 and zero rows after; ``carries`` names the EF carries
#: the calls thread (stage 1 ``residual``, stage 2 ``owner_residual``)
RS_EF_CASES = {
    "stage1": (2.5, 3, 8, {"average": True}, ("residual",)),
    "stage1_plain": (2.5, 3, 8, {"average": True}, ()),
    "stage2": (0.6, 3, 6, {"average": False}, ("owner_residual",)),
    "stage2_plain": (0.6, 3, 2, {"average": False}, ()),
    "both": (1.7, 2, 12, {"average": False},
             ("residual", "owner_residual")),
}
RS_EF_VOCAB = 32
RS_EF_KW = {"vocab": RS_EF_VOCAB, "compress_bits": 8, "compress_range": 1.0}
RS_EF_UIDS = np.array([1, 2, 7, 8, 0, 0], np.int32)


def rs_ef_rows(world, spike, dim):
    """The round-0 rows of an EF drain scenario: ``spike`` in the four
    real slots of every rank."""
    rows = np.zeros((world, RS_EF_UIDS.size, dim), np.float32)
    rows[:, :4] = spike
    return rows


def rs_ring_buckets(world):
    """[W, W, 3] buckets whose values name (sending rank, destination)."""
    src = np.arange(world).reshape(-1, 1, 1)
    dst = np.arange(world).reshape(1, -1, 1)
    return (100 * src + dst + np.zeros((1, 1, 3))).astype(np.float32)


def _rs_rank(mesh, rank, world):
    """The reduce-scatter scenarios on this rank."""
    out = {}
    for name, (u, r, kw) in rs_cases(world).items():
        kw = dict(kw)
        carry = kw.pop("residual", False)
        if carry:
            res = tcoll.sparse_ef_residual_init(
                mesh, (kw["vocab"],) + r.shape[2:])
            got = tcoll.sparse_reduce_scatter(
                mesh, torch.from_numpy(u[rank]), torch.from_numpy(r[rank]),
                residual=res, **kw)
        else:
            got = tcoll.sparse_reduce_scatter(
                mesh, torch.from_numpy(u[rank]), torch.from_numpy(r[rank]),
                **kw)
        out[name] = [_np(x) for x in got]
    uids = torch.from_numpy(RS_EF_UIDS)
    for name, (spike, dim, rounds, kw, carries) in RS_EF_CASES.items():
        state = {c: tcoll.sparse_ef_residual_init(mesh, (RS_EF_VOCAB, dim))
                 for c in carries}
        spike_rows = torch.from_numpy(rs_ef_rows(world, spike, dim)[rank])
        steps = []
        for t in range(rounds):
            rows = spike_rows if t == 0 else torch.zeros_like(spike_rows)
            got = tcoll.sparse_reduce_scatter(mesh, uids, rows, **RS_EF_KW,
                                              **kw, **state)
            state = dict(zip(carries, got[3:]))
            steps.append([_np(x) for x in got])
        out[f"ef_{name}"] = steps
    try:
        tcoll.sparse_reduce_scatter(
            mesh, torch.arange(1, 5, dtype=torch.int32),
            torch.ones((4, 2)), vocab=8, average=True, compress_bits=8,
            compress_range=1.0,
            owner_residual=tcoll.sparse_ef_residual_init(mesh, (8, 2)))
        out["owner_mean_error"] = None
    except ValueError as e:
        out["owner_mean_error"] = str(e)
    buckets = torch.from_numpy(rs_ring_buckets(world)[rank])
    out["ring"] = _np(tcoll._rs_ring_exchange(buckets, mesh, world))
    codes = buckets.to(torch.int32).to(torch.uint16)
    out["ring_u16"] = _np(tcoll._rs_ring_exchange(codes, mesh, world)
                          .to(torch.int32))
    return out


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
    out["rs"] = _rs_rank(mesh, rank, world)
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


def rs_pick_batches(world):
    """Two global batches of 64 rows a rank, 6 ids a row, at vocab 1024:
    with v's dim 32 the pick is the reduce-scatter at 4 ranks."""
    return [fm_batch(40 + i, n=64 * world, f=1024) for i in range(2)]


def rs_fm_batch(seed, n_rows, f, nnz):
    """tests/test_sparse_rs.py's FM batch (ids from 1, unit values)."""
    rng = np.random.default_rng(seed)
    return {
        "fids": rng.integers(1, f, size=(n_rows, nnz)).astype(np.int32),
        "vals": np.ones((n_rows, nnz), np.float32),
        "mask": np.ones((n_rows, nnz), np.float32),
        "labels": (rng.random(n_rows) > 0.5).astype(np.float32),
    }


#: the reduce-scatter trainer scenarios (tests/test_sparse_rs.py's):
#: vocab 2048, dim 16, 512 rows of 8 ids (``sparse_rs`` for v at 4
#: ranks), stepped RS_SCAN_STEPS full-batch epochs, then RS_FALLBACK_STEPS
#: train steps on a batch whose ids are all multiples of the world (one
#: owner: the reduce-scatter would overflow, so the step falls back)
RS_TRAINER = (2048, 16, 512, 8)
RS_SCAN_STEPS = 6
RS_FALLBACK_STEPS = 3
#: the EF scenario: vocab 4096, dim 64, 1024 rows of 8 ids, 8 bits
#: uniform at a fixed range of 0.05 with the carry and without; one spike
#: step (values x20, labels 1), then RS_EF_STEPS normal ones
RS_EF_TRAINER = (4096, 64, 1024, 8)
RS_EF_STEPS = 8
RS_EF_TRAINER_KW = {"compress_bits": 8, "compress_range": 0.05,
                    "compress_mode": "uniform"}
#: the EF carry's parity scenario: the same trainer with the carry at a
#: range of 1.0, whose table the JAX program builds bit for bit as its
#: eager build_table does (at 0.05 it does not), over RS_EF_STEPS // 2
#: normal steps (the spike step's gradients cancel terms of ~1e3, so
#: their codes follow the summation order)
RS_EF_PARITY_KW = dict(RS_EF_TRAINER_KW, compress_range=1.0)


def rs_skewed_batch(world):
    f, _, rows, nnz = RS_TRAINER
    b = rs_fm_batch(61, rows, f, nnz)
    b["fids"] = (np.maximum(b["fids"] // world, 1) * world).astype(np.int32)
    return b


def rs_ef_batches():
    """The EF scenario's spike and normal batches (same ids, labels 1)."""
    f, _, rows, nnz = RS_EF_TRAINER
    base = rs_fm_batch(62, rows, f, nnz)
    base["labels"] = np.ones(rows, np.float32)
    spike = dict(base, vals=20.0 * base["vals"])
    return spike, base


def _rs_trainers(mesh, world):
    """The reduce-scatter trainer scenarios on this rank."""
    out = {}
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(fm_params(1024, 32), "cpu"), tfm.logits,
        TrainConfig(**CFG), sparse_tables=TABLES,
        fused_fn=tfm.logits_with_l2, mesh=mesh)
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    losses = [float(tr.train_step(b)) for b in rs_pick_batches(world)]
    out["rs_pick"] = {"loss": losses, "w": _np(tr.params["w"]),
                      "v": _np(tr.params["v"]),
                      "accum_v": _np(tr.opt_state["accum"]["v"]),
                      "policy": dict(tr.exchange_policy),
                      "bytes": dict(tr.exchange_bytes_per_step),
                      "counters": tr.telemetry.snapshot()["counters"]}
    f, dim, rows, nnz = RS_TRAINER
    cfg = TrainConfig(learning_rate=0.1)
    params = fm_params(f, dim, seed=1)
    tr = SparseTableCTRTrainer(tfm.params_from_numpy(params, "cpu"),
                               tfm.logits, cfg, sparse_tables=TABLES,
                               mesh=mesh)
    tr.health = None
    batch = rs_fm_batch(60, rows, f, nnz)
    out["rs_scan"] = {
        "plan": {k: v[1] for k, v in tr._exchange_plan(batch).items()},
        "fits": tr._rs_batch_fits(batch, tr._exchange_plan(batch)),
        "loss": [float(x) for x in tr.fit_fullbatch_scan(batch,
                                                         RS_SCAN_STEPS)],
        "w": _np(tr.params["w"]), "v": _np(tr.params["v"]),
        "policy": dict(tr.exchange_policy)}
    tr = SparseTableCTRTrainer(tfm.params_from_numpy(params, "cpu"),
                               tfm.logits, cfg, sparse_tables=TABLES,
                               mesh=mesh)
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    batch = rs_skewed_batch(world)
    losses = [float(tr.train_step(batch)) for _ in range(RS_FALLBACK_STEPS)]
    out["rs_fallback"] = {
        "plan": {k: v[1] for k, v in tr._exchange_plan(batch).items()},
        "fits": tr._rs_batch_fits(batch, tr._exchange_plan(batch)),
        "loss": losses, "w": _np(tr.params["w"]), "v": _np(tr.params["v"]),
        "last_fallback": tr._last_step_fallback,
        "fallback_policy": dict(tr._fallback_policy),
        "policy": dict(tr.exchange_policy),
        "counters": tr.telemetry.snapshot()["counters"]}
    tr = SparseTableCTRTrainer(tfm.params_from_numpy(params, "cpu"),
                               tfm.logits, cfg, sparse_tables=TABLES,
                               mesh=mesh)
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    losses = tr.fit_fullbatch_scan(batch, RS_FALLBACK_STEPS)
    out["rs_fallback_scan"] = {
        "loss": [float(x) for x in losses], "w": _np(tr.params["w"]),
        "v": _np(tr.params["v"]),
        "counters": tr.telemetry.snapshot()["counters"]}
    f, dim, rows, nnz = RS_EF_TRAINER
    params = fm_params(f, dim)
    spike, normal = rs_ef_batches()
    for ef in (True, False):
        tr = SparseTableCTRTrainer(
            tfm.params_from_numpy(params, "cpu"), tfm.logits,
            TrainConfig(learning_rate=0.05), sparse_tables=TABLES,
            mesh=mesh, error_feedback=ef, **RS_EF_TRAINER_KW)
        tr.health = None
        losses = [float(tr.train_step(spike))]
        rec = {"plan": {k: v[1] for k, v in
                        tr._exchange_plan(spike).items()},
               "fits": tr._rs_batch_fits(spike, tr._exchange_plan(spike))}
        if ef:
            rec["res_after_spike"] = float(
                tr.opt_state["sres"]["v"].abs().max())
        losses += [float(tr.train_step(normal)) for _ in range(RS_EF_STEPS)]
        rec.update(loss=losses, v=_np(tr.params["v"]),
                   policy=dict(tr.exchange_policy))
        out[f"rs_ef{int(ef)}"] = rec
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(params, "cpu"), tfm.logits,
        TrainConfig(learning_rate=0.05), sparse_tables=TABLES, mesh=mesh,
        error_feedback=True, **RS_EF_PARITY_KW)
    tr.health = None
    losses = [float(tr.train_step(normal)) for _ in range(RS_EF_STEPS // 2)]
    out["rs_ef_parity"] = {"loss": losses, "w": _np(tr.params["w"]),
                           "v": _np(tr.params["v"]),
                           "sres_v": _np(tr.opt_state["sres"]["v"]),
                           "policy": dict(tr.exchange_policy)}
    return out


# -- the Wide&Deep family on a mesh ---------------------------------------------

#: the family's width in the worlds: vocab, fields, slots a row, factor
#: dim, hidden, DCN's crosses, global rows a step
FAMILY_SHAPE = dict(f=512, fields=4, nnz=5, d=8, hidden=16, n_cross=2,
                    rows=64)
FAMILY_STEPS = 3
#: kind -> the sparse trainer's tables (tests/test_deepfm_dcn.py:61)
FAMILY_TABLES = {"widedeep": {"w": ["fids"], "embed": ["rep_fids"]},
                 "deepfm": {"w": ["fids"], "embed": ["rep_fids"]},
                 "dcn": {"embed": ["rep_fids"]}}
#: name -> (kind, trainer, kwargs) of the family's mesh runs: the hybrid
#: exchange exact for every kind and 8-bit dynamic for DeepFM and DCN; the
#: plain gradient mean of CTRTrainer(mesh=...) for every kind and its
#: coded ring for DeepFM
FAMILY_CASES = {
    **{f"{k}_sparse_exact": (k, "sparse", {}) for k in FAMILY_TABLES},
    **{f"{k}_sparse_coded": (k, "sparse", {"compress_bits": 8,
                                           "compress_range": "dynamic"})
       for k in ("deepfm", "dcn")},
    **{f"{k}_dense_mean": (k, "dense", {}) for k in FAMILY_TABLES},
    "deepfm_dense_ring": ("deepfm", "dense", {"compress_bits": 8,
                                              "compress_range": "dynamic"}),
}


def family_logits(kind):
    """(logits, logits_with_l2 or None) of the port's ``kind``."""
    if kind == "widedeep":
        return twidedeep.logits, None
    if kind == "dcn":
        return tdeepfm.dcn_logits, tdeepfm.dcn_logits_with_l2
    return tdeepfm.logits, tdeepfm.logits_with_l2


def family_params(kind, seed=0):
    """The family's init (the JAX package's distributions) from a numpy
    seed, with W and the biases non-zero so every term counts."""
    s = FAMILY_SHAPE
    rng = np.random.default_rng(seed)
    f, d = s["f"], s["d"]
    x = s["fields"] * d

    def layer(n_in, n_out):
        return {"w": (rng.random((n_out, n_in)) - 0.5).astype(np.float32),
                "b": rng.normal(0, 0.1, n_out).astype(np.float32)}

    p = {"embed": (rng.standard_normal((f, d)) / np.sqrt(d)).astype(
        np.float32)}
    if kind == "dcn":
        p["cross_w"] = (rng.standard_normal((s["n_cross"], x))
                        / np.sqrt(x)).astype(np.float32)
        p["cross_b"] = rng.normal(0, 0.1, (s["n_cross"], x)).astype(
            np.float32)
        p["fc1"] = layer(x, s["hidden"])
        p["out"] = layer(x + s["hidden"], 1)
    else:
        p["w"] = rng.normal(0, 0.1, f).astype(np.float32)
        p["fc1"] = layer(x, s["hidden"])
        p["fc2"] = layer(s["hidden"], 1)
    return p


def family_batch(seed):
    """tests/test_deepfm_dcn.py's layout from a numpy seed (random fields,
    a partial mask) with the field-representative pair."""
    s = FAMILY_SHAPE
    rng = np.random.default_rng(seed)
    n, nnz = s["rows"], s["nnz"]
    fids = rng.integers(1, s["f"], size=(n, nnz)).astype(np.int32)
    fld = rng.integers(0, s["fields"], size=(n, nnz)).astype(np.int32)
    mask = (rng.random((n, nnz)) < 0.9).astype(np.float32)
    rep, rep_mask = twidedeep.field_representatives(fids, fld, mask,
                                                    s["fields"])
    return {"fids": fids, "fields": fld,
            "vals": rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32),
            "mask": mask, "labels": (rng.random(n) > 0.5).astype(np.float32),
            "rep_fids": rep, "rep_mask": rep_mask}


def family_batches():
    return [family_batch(70 + i) for i in range(FAMILY_STEPS)]


def flat_tree(tree, prefix=""):
    """{"fc1/w": array, ...} of a (nested) dict of tensors, copied."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def _family_trainers(mesh):
    """Each of :data:`FAMILY_CASES` on this rank over FAMILY_STEPS steps
    from one init: losses, every parameter and, for the hybrid exchange,
    the table accumulators, the pick and its bytes."""
    cfg = TrainConfig(**CFG)
    out = {}
    for name, (kind, trainer, kw) in FAMILY_CASES.items():
        logits, fused = family_logits(kind)
        p = _common.params_from_numpy(family_params(kind), "cpu")
        extra = {} if fused is None else {"fused_fn": fused}
        if trainer == "sparse":
            tr = SparseTableCTRTrainer(p, logits, cfg,
                                       sparse_tables=FAMILY_TABLES[kind],
                                       mesh=mesh, **extra, **kw)
        else:
            tr = CTRTrainer(p, logits, cfg, mesh=mesh, **extra, **kw)
        tr.health = None
        losses = [float(tr.train_step(b)) for b in family_batches()]
        rec = {"loss": losses, "params": flat_tree(tr.params)}
        if trainer == "sparse":
            rec.update(accum=flat_tree(tr.opt_state["accum"]),
                       policy=dict(tr.exchange_policy),
                       bytes=dict(tr.exchange_bytes_per_step))
        out["family_" + name] = rec
    return out


# -- the quality sketch on a mesh ----------------------------------------------

#: probability bins of the armed runs
QUALITY_BINS = 64
#: name -> (kind, trainer kwargs, batches(world), steps through
#: ``train_step``) of the armed runs, each the unarmed case of the same
#: name above stepped over the same batches with ``quality_bins`` set:
#: the hybrid exchange exact, 8-bit dynamic, the reduce-scatter pick (at 4
#: ranks) and its overflow fallback; CTRTrainer's mean and coded ring
QUALITY_CASES = {
    "sparse_exact": ("sparse", 4096, 4, TRAINER_CASES["sparse_exact"][1],
                     lambda w: trainer_batches(4096)),
    "coded_dynamic": ("sparse", 4096, 4, TRAINER_CASES["coded_dynamic"][1],
                      lambda w: trainer_batches(4096)),
    "rs_pick": ("sparse", 1024, 32, {}, rs_pick_batches),
    "rs_fallback": ("sparse_rs", RS_TRAINER[0], RS_TRAINER[1], {},
                    lambda w: [rs_skewed_batch(w)] * RS_FALLBACK_STEPS),
    "dense_mean": ("dense", 512, 4, DENSE_CASES["dense_mean"],
                   lambda w: [fm_batch(20, f=512)] * 4),
    "dense_ring": ("dense", 512, 4, DENSE_CASES["dense_ring"],
                   lambda w: [fm_batch(20, f=512)] * 4),
}


def _planes_trainers(mesh, world):
    """Each of :data:`QUALITY_CASES`' unarmed runs again with the resources
    and device planes armed (``resources=True, device_telemetry=True``),
    the health feed off: losses and tables, and the step's signature count
    and recorded analysis."""
    out = {}
    for name in QUALITY_CASES:
        out["planes_" + name] = _quality_case(
            mesh, world, name, resources=True, device_telemetry=True)
    return out


def _quality_case(mesh, world, name, **arm):
    kind, f, dim, kw, batches = QUALITY_CASES[name]
    if kind == "sparse_rs":
        params, cfg = fm_params(f, dim, seed=1), TrainConfig(
            learning_rate=0.1)
        extra = {}
    else:
        params, cfg = fm_params(f, dim), TrainConfig(**CFG)
        extra = {"fused_fn": tfm.logits_with_l2}
    p = tfm.params_from_numpy(params, "cpu")
    if kind == "dense":
        tr = CTRTrainer(p, tfm.logits, cfg, mesh=mesh, **arm, **extra, **kw)
    else:
        tr = SparseTableCTRTrainer(p, tfm.logits, cfg, sparse_tables=TABLES,
                                   mesh=mesh, **arm, **extra, **kw)
    tr.health = None
    losses = [float(tr.train_step(b)) for b in batches(world)]
    tr.flush_health()
    rec = {"loss": losses, "w": _np(tr.params["w"]),
           "v": _np(tr.params["v"]),
           "policy": dict(getattr(tr, "exchange_policy", {})),
           "fallback": getattr(tr, "_last_step_fallback", False)}
    if tr.quality is not None:
        rec.update(rows=tr.quality.total.rows.copy(),
                   updates=tr.quality.total.updates)
        tr.quality.close()
    if tr.resources is not None:
        tr.resources.poll()
        rec["signatures"] = tr.resources.snapshot()["fns"]["trainer_step"][
            "cache_entries"]
        rec["analyzed"] = tr.device_catalog.analyze()["trainer_step"][
            "available"]
        for c in (tr.resources, tr.device_catalog, tr.device_census):
            c.close()
    return rec


def _quality_trainers(mesh, world):
    """Each of :data:`QUALITY_CASES` armed with ``quality_bins``, the
    health feed off (the armed trainer drains its vector all the same):
    losses, tables and the tracker's total sketch rows."""
    return {"quality_" + name: _quality_case(mesh, world, name,
                                             quality_bins=QUALITY_BINS)
            for name in QUALITY_CASES}


def trainers_rank(rank, world, out_dir, carry_path):
    """The hybrid sparse trainer in each of :data:`TRAINER_CASES`, the
    dense trainer with the plain mean and with the coded ring, the
    reduce-scatter scenarios, the armed runs of :data:`QUALITY_CASES`
    (the quality sketch; the resources and device planes), and
    a restart from the JAX trainer's mesh
    state (``carry_path``)."""
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
    out.update(_rs_trainers(mesh, world))
    out.update(_family_trainers(mesh))
    out.update(_quality_trainers(mesh, world))
    out.update(_planes_trainers(mesh, world))
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
    with and without the causal mask, and the gradients of the sum of the
    output's squares in q, k and v (with the output of that differentiable
    call); bfloat16 causal (its blocks cross gloo as bytes), the
    indivisible-T error, and the refusal of a function that needs the
    ``data`` axis."""
    mesh = make_mesh(MeshSpec(seq=world), device="cpu")
    q, k, v = (torch.from_numpy(x) for x in attention_inputs())
    out = {"axis": mesh.axis}
    for causal in (False, True):
        out[f"causal{int(causal)}"] = _np(
            ring_self_attention(mesh, q, k, v, causal=causal))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = ring_self_attention(mesh, *leaves, causal=causal)
        (got ** 2).sum().backward()
        out[f"grad_out_causal{int(causal)}"] = _np(got)
        out[f"grads_causal{int(causal)}"] = [_np(x.grad) for x in leaves]
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


def repeat_step_rank(rank, world, out_dir):
    """One coded step (8 bits, measured range) of the hybrid trainer run
    twice from the same state on this rank's card: a fresh trainer steps
    one batch, its state is copied, it steps a second batch, the copy is
    restored and it steps the second batch again.  Saves the tables and
    accumulators after each of the two runs."""
    from lightctr_tpu_torch.optim.updaters import tree_map

    mesh = make_mesh(MeshSpec(data=world))
    torch.cuda.set_device(mesh.device)
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(fm_params(4096, 32), mesh.device), tfm.logits,
        TrainConfig(**CFG), sparse_tables=TABLES,
        fused_fn=tfm.logits_with_l2, mesh=mesh, compress_bits=8,
        compress_range="dynamic")
    tr.health = None
    tr.train_step(fm_batch(0, n=128, nnz=39))
    saved = tree_map(torch.clone, (tr.params, tr.opt_state))
    runs = []
    for _ in range(2):
        tr.params, tr.opt_state = tree_map(torch.clone, saved)
        tr.train_step(fm_batch(1, n=128, nnz=39))
        runs.append({k: _np(t) for k, t in (
            ("w", tr.params["w"]), ("v", tr.params["v"]),
            ("accum_w", tr.opt_state["accum"]["w"]),
            ("accum_v", tr.opt_state["accum"]["v"]))})
    _save(out_dir, rank, runs)
