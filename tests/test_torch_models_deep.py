"""The port's Wide&Deep family (``nn/dense``, ``models/widedeep``,
``models/deepfm``) and ``ops/quantize.lowbit_quantize`` against the JAX
package on the CPU, from the JAX package's own init (carried across as
numpy) and numpy inputs from a seed.

Tolerances: where the path goes through ``tanh`` (the MLP's ``fc1``),
rtol 1e-4 / atol 2e-4, the JAX package's own bound for XLA's CPU tanh
against numpy (ROADMAP §C, "In the reference"); FM-style terms, the cross
network and the L2 penalties, which have no tanh, at the trainers'
cross-framework bound rtol 2e-5 / atol 2e-6 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.models import deepfm as jdeepfm
from lightctr_tpu.models import widedeep as jwidedeep
from lightctr_tpu.nn import dense as jdense
from lightctr_tpu.ops import quantize as jquantize
from lightctr_tpu.optim import updaters as jupdaters
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import deepfm as tdeepfm
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models import widedeep as twidedeep
from lightctr_tpu_torch.nn import dense as tdense
from lightctr_tpu_torch.ops import quantize as tquantize

F, FIELDS, NNZ, D, HIDDEN, N = 256, 4, 5, 8, 16, 48
TANH_TOL = dict(rtol=1e-4, atol=2e-4)
TOL = dict(rtol=2e-5, atol=2e-6)

#: kind -> (JAX init, JAX logits_with_l2 or None, port counterparts)
KINDS = {
    "widedeep": (jwidedeep.init, jwidedeep.logits, None,
                 twidedeep.logits, None),
    "deepfm": (jdeepfm.init, jdeepfm.logits, jdeepfm.logits_with_l2,
               tdeepfm.logits, tdeepfm.logits_with_l2),
    "dcn": (lambda key, f, fl, d, hidden: jdeepfm.dcn_init(
        key, f, fl, d, n_cross=2, hidden=hidden), jdeepfm.dcn_logits,
        jdeepfm.dcn_logits_with_l2, tdeepfm.dcn_logits,
        tdeepfm.dcn_logits_with_l2),
}


def family_batch(seed=0, n=N, f=F, fields=FIELDS, nnz=NNZ):
    """tests/test_deepfm_dcn.py's batch layout with random values and a
    partial mask, plus the field-representative pair."""
    rng = np.random.default_rng(seed)
    fids = rng.integers(1, f, size=(n, nnz)).astype(np.int32)
    fld = rng.integers(0, fields, size=(n, nnz)).astype(np.int32)
    mask = (rng.random((n, nnz)) < 0.9).astype(np.float32)
    rep, rep_mask = jwidedeep.field_representatives(fids, fld, mask, fields)
    return {"fids": fids, "fields": fld,
            "vals": rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32),
            "mask": mask, "labels": (rng.random(n) > 0.5).astype(np.float32),
            "rep_fids": rep, "rep_mask": rep_mask}


def family_params(kind, seed=1):
    """The JAX package's init of ``kind`` as numpy, with W and the biases
    made non-zero so every term counts."""
    p = KINDS[kind][0](jax.random.PRNGKey(seed), F, FIELDS, D, hidden=HIDDEN)
    p = jax.tree_util.tree_map(np.asarray, p)
    rng = np.random.default_rng(seed)
    if "w" in p:
        p["w"] = rng.normal(0, 0.1, F).astype(np.float32)
    for layer in ("fc1", "fc2", "out"):
        if layer in p:
            p[layer]["b"] = rng.normal(0, 0.1, p[layer]["b"].shape).astype(
                np.float32)
    if "cross_b" in p:
        p["cross_b"] = rng.normal(0, 0.1, p["cross_b"].shape).astype(
            np.float32)
    return p


def jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -- nn/dense ----------------------------------------------------------------


@pytest.mark.parametrize("act", [None, "tanh", "mask"])
def test_dense_apply_matches_jax(act):
    rng = np.random.default_rng(2)
    p = jax.tree_util.tree_map(
        np.asarray, jdense.init(jax.random.PRNGKey(0), 12, 7))
    p["b"] = rng.normal(size=7).astype(np.float32)
    x = rng.normal(size=(9, 12)).astype(np.float32)
    mask = (rng.random(7) > 0.3).astype(np.float32)
    kw_j, kw_t, tol = {}, {}, TOL
    if act == "tanh":
        kw_j, kw_t, tol = {"activation": jnp.tanh}, {
            "activation": torch.tanh}, TANH_TOL
    elif act == "mask":
        kw_j = {"dropout_mask": jnp.asarray(mask), "keep_prob": 0.7}
        kw_t = {"dropout_mask": torch.from_numpy(mask), "keep_prob": 0.7}
    want = np.asarray(jdense.apply(jtree(p), jnp.asarray(x), **kw_j))
    got = tdense.apply(_common.params_from_numpy(p, "cpu"),
                       torch.from_numpy(x), **kw_t).numpy()
    np.testing.assert_allclose(got, want, **tol)


def test_dense_init_and_dropout_mask_follow_the_jax_contract():
    """The bits differ between jax.random and torch.Generator; the
    contract holds: shapes, U(-0.5, 0.5) weights (fan_in scaled), zero
    bias, a 0/1 mask at about keep_prob, the same draws from one seed."""
    g = torch.Generator().manual_seed(0)
    p = tdense.init(g, 300, 40)
    j = jdense.init(jax.random.PRNGKey(0), 300, 40)
    assert p["w"].shape == j["w"].shape and p["b"].shape == j["b"].shape
    assert float(p["w"].min()) >= -0.5 and float(p["w"].max()) < 0.5
    assert abs(float(p["w"].mean())) < 0.01 and not p["b"].any()
    s = tdense.init(torch.Generator().manual_seed(0), 300, 40,
                    scale="fan_in")
    torch.testing.assert_close(s["w"], p["w"] / np.sqrt(300.0))
    with pytest.raises(ValueError, match="unknown scale"):
        tdense.init(g, 3, 2, scale="he")
    m = tdense.sample_dropout_mask(torch.Generator().manual_seed(3), 4000,
                                   0.8)
    assert m.shape == (4000,) and set(m.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(m.mean()) - 0.8) < 0.03
    torch.testing.assert_close(
        m, tdense.sample_dropout_mask(torch.Generator().manual_seed(3),
                                      4000, 0.8))


# -- models ------------------------------------------------------------------


def test_field_representatives_bit_for_bit():
    fids = np.asarray([[10, 11, 12, 0], [20, 21, 0, 0]], np.int32)
    fields = np.asarray([[0, 0, 2, 0], [1, 1, 0, 0]], np.int32)
    mask = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    rep, rep_mask = twidedeep.field_representatives(fids, fields, mask, 3)
    # first fid per field wins (distributed_algo_abst.h:210-215)
    assert rep[0, 0] == 10 and rep_mask[0, 0] == 1
    assert rep[0, 2] == 12 and rep_mask[0, 2] == 1
    assert rep_mask[0, 1] == 0
    assert rep[1, 1] == 20 and rep_mask[1, 1] == 1
    assert rep_mask[1, 2] == 0
    rng = np.random.default_rng(4)
    fids = rng.integers(0, 1000, size=(200, 9)).astype(np.int32)
    fields = rng.integers(-1, 7, size=(200, 9)).astype(np.int32)
    mask = (rng.random((200, 9)) < 0.8).astype(np.float32)
    for got, want in zip(
            twidedeep.field_representatives(fids, fields, mask, 6),
            jwidedeep.field_representatives(fids, fields, mask, 6)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_init_trees_match_the_jax_trees():
    """Each kind's init: the JAX tree's structure, shapes and dtypes, and
    its distributions (embed ~ N(0, 1/D), W zero, biases zero)."""
    g = torch.Generator().manual_seed(0)
    for mod_t, fn_t, fn_j in (
            (twidedeep, twidedeep.init, jwidedeep.init),
            (tdeepfm, tdeepfm.dcn_init, jdeepfm.dcn_init)):
        tp = fn_t(g, 4096, FIELDS, D, hidden=HIDDEN)
        jp = fn_j(jax.random.PRNGKey(0), 4096, FIELDS, D, hidden=HIDDEN)
        jshapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                         jp)
        tshapes = {k: ({kk: (tuple(vv.shape), str(vv.dtype).split(".")[1])
                        for kk, vv in v.items()} if isinstance(v, dict)
                       else (tuple(v.shape), str(v.dtype).split(".")[1]))
                   for k, v in tp.items()}
        assert tshapes == jshapes
        assert abs(float(tp["embed"].std()) - 1 / np.sqrt(D)) < 0.01
        assert not tp["fc1"]["b"].any()
    assert tdeepfm.init is twidedeep.init
    assert not tdeepfm.dcn_init(g, 64, 2, 4)["cross_b"].any()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_logits_and_l2_match_jax(kind):
    _, jl, jl2, tl, tl2 = KINDS[kind]
    p, b = family_params(kind), family_batch(3)
    tp = _common.params_from_numpy(p, "cpu")
    want = np.asarray(jl(jtree(p), jtree(b)))
    got = tl(tp, tbatch(b))
    assert got.shape == want.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, **TANH_TOL)
    if jl2 is not None:
        jz, jr = jl2(jtree(p), jtree(b))
        tz, tr = tl2(tp, tbatch(b))
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TANH_TOL)
        np.testing.assert_allclose(float(tr), float(jr), **TOL)
        np.testing.assert_array_equal(tz.numpy(), got.numpy())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gradients_match_jax_grad(kind):
    """The gradient of sum(logits) (plus 0.01 * l2 where the kind has it)
    w.r.t. every leaf, tables included (their backward is the lookup's
    slot-order merge), against ``jax.grad``."""
    _, jl, jl2, tl, tl2 = KINDS[kind]
    p, b = family_params(kind, seed=5), family_batch(6)

    def jloss(params):
        if jl2 is None:
            return jnp.sum(jl(params, jtree(b)))
        z, r = jl2(params, jtree(b))
        return jnp.sum(z) + 0.01 * r

    want = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(jtree(p)))
    leaves = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    if tl2 is None:
        loss = torch.sum(tl(leaves, tbatch(b)))
    else:
        z, r = tl2(leaves, tbatch(b))
        loss = torch.sum(z) + 0.01 * r
    loss.backward()
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, g in flat_w:
        node = leaves
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.grad.numpy(), g, err_msg=str(path),
                                   **TANH_TOL)


def test_field_embeddings_and_cross_network_match_jax():
    p, b = family_params("dcn"), family_batch(7)
    tp = _common.params_from_numpy(p, "cpu")
    want = np.asarray(jdeepfm._field_embeddings(jtree(p), jtree(b)))
    emb = tdeepfm._field_embeddings(tp, tbatch(b))
    np.testing.assert_array_equal(emb.numpy(), want)
    x0 = emb.reshape(N, -1)
    got = tdeepfm.cross_network(x0, tp["cross_w"], tp["cross_b"])
    want = jdeepfm.cross_network(jnp.asarray(x0.numpy()),
                                 jnp.asarray(p["cross_w"]),
                                 jnp.asarray(p["cross_b"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_network_numpy_oracle():
    """tests/test_deepfm_dcn.py's oracle: the rank-1 formula by hand, for
    one layer and two stacked."""
    rng = np.random.default_rng(0)
    B, d = 5, 12
    x0 = rng.normal(size=(B, d)).astype(np.float32)
    w = rng.normal(size=(2, d)).astype(np.float32)
    b = rng.normal(size=(2, d)).astype(np.float32)
    x1 = x0 * (x0 @ w[0])[:, None] + b[0][None, :] + x0
    x2 = x0 * (x1 @ w[1])[:, None] + b[1][None, :] + x1
    t = [torch.from_numpy(a) for a in (x0, w, b)]
    np.testing.assert_allclose(
        tdeepfm.cross_network(t[0], t[1][:1], t[2][:1]).numpy(), x1,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdeepfm.cross_network(*t).numpy(), x2,
                               rtol=1e-5, atol=1e-5)


def test_make_batch_adds_the_rep_pair():
    from lightctr_tpu_torch.data.sparse import SparseDataset

    b = family_batch(8, n=6)
    ds = SparseDataset(fids=b["fids"], fields=b["fields"], vals=b["vals"],
                       mask=b["mask"], labels=b["labels"],
                       feature_cnt=F, field_cnt=FIELDS)
    out = twidedeep.make_batch(ds, b["rep_fids"], b["rep_mask"])
    assert set(out) == {"fids", "fields", "vals", "mask", "labels",
                        "rep_fids", "rep_mask"}
    np.testing.assert_array_equal(out["rep_fids"], b["rep_fids"])


# -- weights carried across ----------------------------------------------------


def test_nested_params_and_opt_state_from_numpy():
    p = family_params("deepfm")
    tp = _common.params_from_numpy(p, "cpu")
    assert tfm.params_from_numpy is _common.params_from_numpy
    assert set(tp) == set(p) and set(tp["fc1"]) == {"w", "b"}
    np.testing.assert_array_equal(tp["fc1"]["w"].numpy(), p["fc1"]["w"])
    state = jax.tree_util.tree_map(
        np.asarray, jupdaters.adagrad(0.1).init(jtree(p)))
    ts = tfm.opt_state_from_numpy(state, "cpu")
    assert set(ts.accum["fc2"]) == {"w", "b"}
    sparse = {"dense": jax.tree_util.tree_map(
        np.asarray, jupdaters.adagrad(0.1).init(
            {k: jnp.asarray(v) if not isinstance(v, dict) else jtree(v)
             for k, v in p.items() if k not in ("w", "embed")})),
        "accum": {"w": np.ones(F, np.float32),
                  "embed": np.ones((F, D), np.float32)}}
    ts = _common.opt_state_from_numpy(sparse, "cpu")
    assert set(ts["dense"].accum) == {"fc1", "fc2"}
    assert ts["dense"].accum["fc1"]["w"].shape == p["fc1"]["w"].shape


# -- ops/quantize.lowbit_quantize ------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2])
def test_lowbit_quantize_matches_jax(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(64, 33)).astype(np.float32)
    x[0, :3] = 0.0
    jc, jd = jquantize.lowbit_quantize(jnp.asarray(x), bits=bits)
    tc, td = tquantize.lowbit_quantize(torch.from_numpy(x), bits=bits)
    assert tc.dtype == torch.uint8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    with pytest.raises(ValueError, match="1 or 2 bits"):
        tquantize.lowbit_quantize(torch.from_numpy(x), bits=3)
