"""The port's optimizers (``lightctr_tpu_torch.optim``) against the JAX
package's on the same trees, on the CPU: every optimizer of the JAX
registry a few steps on a dict tree and on a three-field NamedTuple (the
trees of ``tests/test_optim.py`` and ``tests/test_optim_pytree.py``),
rtol 1e-6 / atol 1e-7; the composable extras; the registry."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import optim as joptim
from lightctr_tpu_torch import optim as toptim

RTOL, ATOL = 1e-6, 1e-7

#: every optimizer of the JAX registry (lightctr_tpu/optim/updaters.py),
#: with the arguments each test builds it with
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1},
    "adagrad": {"learning_rate": 0.1},
    "rmsprop": {"learning_rate": 0.1, "ema_rate": 0.9},
    "adadelta": {"momentum": 0.9},
    "adam": {"learning_rate": 0.1},
    "ftrl": {},
    "dcasgd": {"learning_rate": 0.1, "lambda_dc": 2.0},
    "dcasgda": {"learning_rate": 0.1},
}


class Params(NamedTuple):
    w: object
    b: object
    e: object


def dict_tree(rng):
    return {"a": rng.normal(size=(7, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=5).astype(np.float32)}}


def namedtuple_tree(rng):
    return Params(w=rng.normal(size=(2, 3)).astype(np.float32),
                  b=rng.normal(size=3).astype(np.float32),
                  e=rng.normal(size=4).astype(np.float32))


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got_l = toptim.updaters.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def run_both(name, kw, params, grads_seq, params_moved=None):
    """Step both packages' ``name`` over ``grads_seq`` from ``params``;
    returns (torch params, jax params, torch state, jax state)."""
    jtx, ttx = joptim.get(name, **kw), toptim.get(name, **kw)
    jp, tp = to_jax(params), to_torch(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads_seq:
        ju, js = jtx.update(to_jax(g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = ttx.update(to_torch(g), ts, tp)
        tp = toptim.apply_updates(tp, tu)
    return tp, jp, ts, js


@pytest.mark.parametrize("tree", ["dict", "namedtuple"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name, tree):
    """Five steps of each optimizer on the same tree and gradients: the
    params and every state leaf within rtol 1e-6 / atol 1e-7 (Adam's
    bias correction as the JAX function computes it, in float32), and the
    updates keep the tree's structure."""
    rng = np.random.default_rng(3)
    make = dict_tree if tree == "dict" else namedtuple_tree
    params = make(rng)
    grads = [jax.tree_util.tree_map(lambda a: (3 * rng.normal(
        size=a.shape)).astype(np.float32), params) for _ in range(5)]
    tp, jp, ts, js = run_both(name, OPTIMIZERS[name], params, grads)
    if tree == "namedtuple":
        assert isinstance(tp, Params)
    assert_trees_close(tp, jp)
    # every state leaf (Adam's step count included)
    got = [x for x in toptim.updaters.tree_leaves(ts)]
    want = jax.tree_util.tree_leaves(js)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_ftrl_sparsifies_tiny_gradients_like_jax():
    """FTRL's L1: tiny gradients leave the weight at exactly 0
    (tests/test_optim.py::test_ftrl_oracle's second half)."""
    params = {"w": np.zeros(3, np.float32)}
    grads = [{"w": np.array([1e-4, -1e-4, 0.0], np.float32)}]
    tp, jp, _, _ = run_both("ftrl", {}, params, grads)
    assert np.all(tp["w"].numpy() == 0.0)
    assert_trees_close(tp, jp)


def test_dcasgd_compensates_a_stale_pull_like_jax():
    """The second step sees params moved by another worker: the
    compensation term g^2 (w - shadow) enters, as in the JAX transform."""
    rng = np.random.default_rng(4)
    w0 = {"w": rng.normal(size=4).astype(np.float32)}
    g1, g2 = ({"w": rng.normal(size=4).astype(np.float32)}
              for _ in range(2))
    for name in ("dcasgd", "dcasgda"):
        jtx, ttx = joptim.get(name, learning_rate=0.1), toptim.get(
            name, learning_rate=0.1)
        jp, tp = to_jax(w0), to_torch(w0)
        js, ts = jtx.init(jp), ttx.init(tp)
        ju, js = jtx.update(to_jax(g1), js, jp)
        tu, ts = ttx.update(to_torch(g1), ts, tp)
        jp = jax.tree_util.tree_map(lambda a: a + 0.05,
                                    joptim.apply_updates(jp, ju))
        tp = toptim.updaters.tree_map(lambda a: a + 0.05,
                                      toptim.apply_updates(tp, tu))
        ju, js = jtx.update(to_jax(g2), js, jp)
        tu, ts = ttx.update(to_torch(g2), ts, tp)
        assert_trees_close(toptim.apply_updates(tp, tu),
                           joptim.apply_updates(jp, ju))


def test_clip_and_regularization_match_jax():
    g = {"g": np.array([20.0, -20.0, 1.0], np.float32)}
    w = {"g": np.array([1.0, -2.0, 0.5], np.float32)}
    for jtx, ttx in ((joptim.clip_by_value(15.0), toptim.clip_by_value(15.0)),
                     (joptim.add_decayed_regularization(0.01, 0.1),
                      toptim.add_decayed_regularization(0.01, 0.1))):
        ju, _ = jtx.update(to_jax(g), jtx.init(to_jax(w)), to_jax(w))
        tu, _ = ttx.update(to_torch(g), ttx.init(to_torch(w)), to_torch(w))
        assert_trees_close(tu, ju)
    np.testing.assert_array_equal(
        toptim.clip_by_value(15.0).update(to_torch(g), None)[0]["g"].numpy(),
        [15.0, -15.0, 1.0])


@pytest.mark.parametrize("name", ["ftrl", "dcasgd", "dcasgda"])
def test_param_reading_optimizers_require_params(name):
    tx = toptim.get(name, **OPTIMIZERS[name])
    p = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="requires params"):
        tx.update(p, tx.init(p), None)
    reg = toptim.add_decayed_regularization(0.1)
    with pytest.raises(ValueError, match="requires params"):
        reg.update(p, reg.init(p), None)


def test_registry_matches_jax():
    """``optim.get`` knows every name the JAX registry knows, and an unknown
    name lists them."""
    assert set(toptim.updaters._REGISTRY) == set(joptim.updaters._REGISTRY)
    for name, kw in OPTIMIZERS.items():
        assert toptim.get(name, **kw)
    with pytest.raises(ValueError, match="unknown optimizer 'nope'.*adam"):
        toptim.get("nope")
