"""The port's FFM and NFM (``models/ffm.py``, ``models/nfm.py``) against
the JAX package on the CPU, mirroring tests/test_ffm_nfm.py: FFM's
field-bucketed forward against the literal pairwise oracle
(train_ffm_algo.cpp:62-70), the mask, training, NFM's structure and its
bi-interaction oracle, ``densify`` with ``make_dense_logits``; then each
model's ``logits_with_l2`` and its gradients held to the JAX package's
from the JAX init carried across, and ``lookup``'s backward on FFM's 3-D
table bit for bit against ``jax.grad`` of ``jnp.take``.

Tolerances: the forwards and gradients at rtol 1e-5 (sums in another
order; NFM's sigmoid has no approximation of tanh's kind); the oracle and
the dense-form parity at the JAX tests' own bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.models import ffm as jffm
from lightctr_tpu.models import nfm as jnfm
from lightctr_tpu.ops import losses as jlosses
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import ffm as tffm
from lightctr_tpu_torch.models import nfm as tnfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.ops import losses as tlosses

TOL = dict(rtol=1e-5, atol=1e-6)


def sparse_batch(rng, n=32, f=200, field_cnt=6, nnz=5):
    """tests/test_ffm_nfm.py's batch."""
    return {
        "fids": rng.integers(1, f, size=(n, nnz)).astype(np.int32),
        "fields": rng.integers(0, field_cnt, size=(n, nnz)).astype(np.int32),
        "vals": rng.random((n, nnz)).astype(np.float32),
        "mask": np.ones((n, nnz), np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
    }


def tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def carried(jparams):
    """The JAX init as the port's tensors."""
    return _common.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def test_ffm_logits_vs_pairwise_oracle():
    rng = np.random.default_rng(0)
    f, field_cnt, k = 100, 5, 3
    batch = sparse_batch(rng, n=8, f=f, field_cnt=field_cnt, nnz=6)
    gen = torch.Generator().manual_seed(1)
    params = tffm.init(gen, f, field_cnt, k)
    got = tffm.logits(params, tb(batch)).numpy()
    W, V = params["w"].numpy(), params["v"].numpy()
    n, p = batch["fids"].shape
    want = np.zeros(n, np.float64)
    for i in range(n):
        for a in range(p):
            want[i] += W[batch["fids"][i, a]] * batch["vals"][i, a]
        for a in range(p):
            for b in range(a + 1, p):
                fa, fb = batch["fids"][i, a], batch["fids"][i, b]
                fla, flb = batch["fields"][i, a], batch["fields"][i, b]
                want[i] += (np.dot(V[fa, flb], V[fb, fla])
                            * batch["vals"][i, a] * batch["vals"][i, b])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_ffm_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = tffm.init(gen, 4000, 5, 8)
    assert p["w"].shape == (4000,) and not p["w"].any()
    assert p["v"].shape == (4000, 5, 8) and p["v"].dtype == torch.float32
    assert abs(float(p["v"].std()) - 1 / np.sqrt(8)) < 0.01


def test_ffm_respects_mask():
    rng = np.random.default_rng(1)
    f, field_cnt, k = 50, 4, 2
    params = tffm.init(torch.Generator().manual_seed(0), f, field_cnt, k)
    b1 = sparse_batch(rng, n=4, f=f, field_cnt=field_cnt, nnz=3)
    b2 = {
        "fids": np.concatenate([b1["fids"], np.full((4, 2), 7, np.int32)], 1),
        "fields": np.concatenate([b1["fields"],
                                  np.full((4, 2), 2, np.int32)], 1),
        "vals": np.concatenate([b1["vals"],
                                np.full((4, 2), 9.9, np.float32)], 1),
        "mask": np.concatenate([b1["mask"], np.zeros((4, 2), np.float32)], 1),
        "labels": b1["labels"],
    }
    z1 = tffm.logits(params, tb(b1)).numpy()
    z2 = tffm.logits(params, tb(b2)).numpy()
    np.testing.assert_allclose(z1, z2, rtol=1e-5, atol=1e-6)


def test_ffm_trains():
    rng = np.random.default_rng(2)
    batch = sparse_batch(rng, n=128, f=300, field_cnt=5, nnz=6)
    params = tffm.init(torch.Generator().manual_seed(0), 300, 5, 4)
    tr = CTRTrainer(params, tffm.logits, TrainConfig(learning_rate=0.1),
                    l2_fn=tffm.l2_penalty, device="cpu")
    tr.health = None
    hist = tr.fit(batch, epochs=40)
    assert hist["loss"][-1] < hist["loss"][0] * 0.8


def test_nfm_structure_and_training():
    rng = np.random.default_rng(3)
    batch = sparse_batch(rng, n=128, f=300, field_cnt=5, nnz=6)
    params = tnfm.init(torch.Generator().manual_seed(0), 300, 4, hidden=16)
    assert params["fc1"]["w"].shape == (16, 4)
    assert params["fc2"]["w"].shape == (1, 16)
    bi = tnfm.bi_interaction(params, tb(batch)).numpy()
    V = params["v"].numpy()
    vx = V[batch["fids"]] * (batch["vals"] * batch["mask"])[..., None]
    want = 0.5 * (vx.sum(1) ** 2 - (vx ** 2).sum(1))
    np.testing.assert_allclose(bi, want, rtol=1e-4, atol=1e-5)
    tr = CTRTrainer(params, tnfm.logits, TrainConfig(learning_rate=0.1),
                    l2_fn=tnfm.l2_penalty, device="cpu")
    tr.health = None
    hist = tr.fit(batch, epochs=40, batch_size=32)
    assert hist["loss"][-1] < hist["loss"][0]


def field_unique_batch(seed=3):
    """tests/test_ffm_nfm.py's dense-form batch: each fid in one field."""
    rng = np.random.default_rng(seed)
    F, Fl, n, p = 40, 5, 12, 6
    feat_field = rng.integers(0, Fl, size=F)
    fids = rng.integers(0, F, size=(n, p)).astype(np.int32)
    return {"fids": fids, "fields": feat_field[fids].astype(np.int32),
            "vals": rng.normal(size=(n, p)).astype(np.float32),
            "mask": (rng.random((n, p)) > 0.25).astype(np.float32),
            "labels": (rng.random(n) > 0.5).astype(np.float32)}, F, Fl


def test_ffm_dense_formulation_parity():
    """The dense form equals the sparse one on a field-unique batch, and
    so do their gradients (in permuted space); ``densify`` is the JAX
    package's exactly."""
    sparse, F, Fl = field_unique_batch()
    jparams = jffm.init(jax.random.PRNGKey(0), F, Fl, 3)
    params = carried(jparams)
    z_s, l2_s = tffm.logits_with_l2(params, tb(sparse))
    dense, perm, slices = tffm.densify(sparse, F, Fl)
    jdense, jperm, jslices = jffm.densify(sparse, F, Fl)
    np.testing.assert_array_equal(perm, jperm)
    assert slices == jslices
    for k in ("x", "x2", "cnt", "labels"):
        np.testing.assert_array_equal(dense[k], jdense[k])
    pp = {"w": params["w"][perm], "v": params["v"][perm]}
    fused = tffm.make_dense_logits(slices)
    z_d, l2_d = fused(pp, tb(dense))
    np.testing.assert_allclose(z_s.numpy(), z_d.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(l2_s), float(l2_d), rtol=1e-5)

    def grads(fn, p, batch):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        z, l2 = fn(leaves, tb(batch))
        loss = tlosses.logistic_loss(z, torch.from_numpy(batch["labels"]),
                                     reduction="mean") + 0.01 * l2
        loss.backward()
        return {k: v.grad.numpy() for k, v in leaves.items()}

    g_s = grads(tffm.logits_with_l2, params, sparse)
    g_d = grads(fused, pp, dense)
    for k in ("w", "v"):
        np.testing.assert_allclose(g_s[k][perm], g_d[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the dense form against the JAX package's, from the same params
    jz, jl2 = jffm.make_dense_logits(jslices)(
        {"w": jparams["w"][jperm], "v": jparams["v"][jperm]}, jb(jdense))
    np.testing.assert_allclose(z_d.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(float(l2_d), float(jl2), **TOL)


def test_ffm_densify_refuses_what_jax_refuses():
    sparse, F, Fl = field_unique_batch()
    bad = dict(sparse, fields=sparse["fields"].copy())
    bad["fields"][0, 0] = (bad["fields"][0, 0] + 1) % Fl
    bad["mask"] = np.ones_like(bad["mask"])
    for mod in (tffm, jffm):
        with pytest.raises(ValueError, match="two different fields"):
            mod.densify(bad, F, Fl)
        with pytest.raises(ValueError, match="field out of range"):
            mod.densify(dict(sparse, fields=sparse["fields"] + Fl), F, Fl)


def _loss_grads_port(fn, params, batch, lam=0.01):
    leaves = _common.tree_copy(params)
    from lightctr_tpu_torch.models.ctr_trainer import (grads_of,
                                                        leaves_requiring_grad)

    leaves = leaves_requiring_grad(leaves)
    z, l2 = fn(leaves, tb(batch))
    loss = tlosses.logistic_loss(z, torch.from_numpy(batch["labels"]),
                                 reduction="mean") + lam * l2
    loss.backward()
    return z.detach().numpy(), float(l2.detach()), grads_of(leaves)


def _loss_grads_jax(fn, params, batch, lam=0.01):
    z, l2 = fn(params, jb(batch))

    def loss(p):
        zz, ll = fn(p, jb(batch))
        return jlosses.logistic_loss(zz, jnp.asarray(batch["labels"]),
                                     reduction="mean") + lam * ll

    return np.asarray(z), float(l2), jax.grad(loss)(params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


@pytest.mark.parametrize("model", ["ffm", "nfm"])
def test_logits_with_l2_and_gradients_match_jax(model):
    """From the JAX init carried across (W made non-zero, a partial mask):
    logits, the touched-row L2 and the gradient of every leaf of
    mean logloss + 0.01 * L2 within rtol 1e-5."""
    rng = np.random.default_rng(4)
    batch = sparse_batch(rng, n=48, f=120, field_cnt=6, nnz=7)
    batch["mask"] = (rng.random(batch["mask"].shape) < 0.85).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    if model == "ffm":
        jp = jffm.init(key, 120, 6, 4)
        jfn, tfn = jffm.logits_with_l2, tffm.logits_with_l2
    else:
        jp = jnfm.init(key, 120, 4, hidden=8)
        jfn, tfn = jnfm.logits_with_l2, tnfm.logits_with_l2
    jp = dict(jp, w=jnp.asarray(rng.normal(0, 0.1, 120).astype(np.float32)))
    zt, lt, gt = _loss_grads_port(tfn, carried(jp), batch)
    zj, lj, gj = _loss_grads_jax(jfn, jp, batch)
    np.testing.assert_allclose(zt, zj, **TOL)
    np.testing.assert_allclose(lt, lj, **TOL)
    gt, gj = _flat(gt), _flat(gj)
    assert sorted(gt) == sorted(gj)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], err_msg=k, **TOL)


def test_lookup_backward_on_a_3d_table_matches_jax_take_bit_for_bit():
    """FFM's v is [V, Fl, k]: a lookup row is Fl*k floats (312 at the
    Criteo layout's 39 fields and k 8).  The forward equals ``jnp.take``
    and the table's gradient of sum(rows * c) equals ``jax.grad`` of the
    same through ``jnp.take`` bit for bit (slot-order sums), with heavy
    duplicates."""
    rng = np.random.default_rng(6)
    table = rng.normal(size=(300, 39, 8)).astype(np.float32)
    ids = (rng.random((32, 39)) ** 4 * 300).astype(np.int32)
    c = rng.normal(size=ids.shape + (39, 8)).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_()
    got = lookup(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        got.detach().numpy(), np.asarray(jnp.take(jnp.asarray(table),
                                                  jnp.asarray(ids), axis=0)))
    (got * torch.from_numpy(c)).sum().backward()
    jgrad = jax.grad(lambda t: jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0)
                                       * c))(jnp.asarray(table))
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(jgrad))


@pytest.mark.parametrize("model", ["ffm", "nfm"])
def test_ctr_trainer_trajectory_matches_jax(model):
    """Eight full-batch Adagrad steps of ``CTRTrainer`` over each model's
    ``logits_with_l2`` from the JAX init: losses and parameters at the
    trainers' bound (rtol 2e-5 / atol 2e-6)."""
    from lightctr_tpu import TrainConfig as JConfig
    from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer

    rng = np.random.default_rng(7)
    batch = sparse_batch(rng, n=64, f=150, field_cnt=5, nnz=6)
    key = jax.random.PRNGKey(8)
    if model == "ffm":
        jp, jfn, tfn = jffm.init(key, 150, 5, 4), jffm, tffm
    else:
        jp, jfn, tfn = jnfm.init(key, 150, 4, hidden=8), jnfm, tnfm
    cfg = dict(learning_rate=0.1, lambda_l2=0.001)
    jt = JCTRTrainer(jp, jfn.logits, JConfig(**cfg),
                     fused_fn=jfn.logits_with_l2)
    tt = CTRTrainer(carried(jp), tfn.logits, TrainConfig(**cfg),
                    fused_fn=tfn.logits_with_l2, device="cpu")
    jt.health = tt.health = None
    lj = np.asarray(jt.fit_fullbatch_scan(batch, 8))
    lt = tt.fit_fullbatch_scan(batch, 8)
    np.testing.assert_allclose(lt, lj, rtol=2e-5, atol=2e-6)
    assert lt[-1] < lt[0]
    want, got = _flat(jt.params), _flat(tt.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
