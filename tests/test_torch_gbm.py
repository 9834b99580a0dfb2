"""The port's GBM (``models/gbm.py``) and its GBM -> FTRL-LR stack
(``models/stacking.py``) against the JAX package on the CPU, mirroring
tests/test_gbm_em.py's, tests/test_gbm_nan.py's and
tests/test_stacking.py's GBM cases.

  - the prefix sums in XLA's CPU order (``xla_cumsum``) equal
    ``jnp.cumsum`` bit for bit;
  - the root histograms (``merge_rows`` at d 1 over the N*F slots) equal
    the JAX package's ``jax.ops.segment_sum`` bit for bit;
  - trees from one set of gradients and masks, every tree of a JAX fit
    rebuilt from that fit's gradients, and a whole binary fit from the
    same data (numpy-seeded masks): ``feature``, ``threshold`` and
    ``default_left`` equal, weights within rtol 1e-5 (GBM_RTOL), leaf
    routes equal, the loss history within rtol 1e-5;
  - the stack's LR half over the JAX stack's trees: its trajectory within
    rtol 1e-4 of the JAX stack's (FTRL's square roots), and its weights;
  - the JAX tests' behaviour: separable data, L1 leaf weights, masked
    features, missing values routed by the learned side, sibling
    subtraction, the stack beating or matching the GBM alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.models import gbm as jgbm
from lightctr_tpu.models import stacking as jstack
from lightctr_tpu_torch.models import gbm as tgbm
from lightctr_tpu_torch.models import stacking as tstack
from lightctr_tpu_torch.ops.metrics import auc_exact

GBM_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_trees_equal(got, want):
    for name in ("feature", "threshold", "default_left"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=GBM_RTOL, atol=1e-7)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 32, 33, 100, 300])
def test_xla_cumsum_matches_jnp_cumsum_bit_for_bit(n):
    x = np.random.default_rng(n).normal(size=(3, 4, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    got = tgbm.xla_cumsum(_t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _problem(seed, n=300, f=12, nan_share=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < nan_share] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 3]) > 0).astype(
        np.float32)
    return x, y


@pytest.mark.parametrize("seed,nan_share", [(0, 0.0), (1, 0.1)])
def test_root_histograms_equal_segment_sum_bit_for_bit(seed, nan_share):
    x, y = _problem(seed, nan_share=nan_share)
    bins, _ = tgbm.quantile_bins(x, 32)
    rng = np.random.default_rng(seed + 10)
    grad = rng.normal(size=len(y)).astype(np.float32)
    hess = rng.random(len(y)).astype(np.float32)
    row_mask = (rng.random(len(y)) < 0.7).astype(np.float32)
    hg, hh = tgbm.root_histograms(_t(bins), _t(grad), _t(hess),
                                  _t(row_mask), 32)
    n, f = bins.shape
    flat = (np.arange(f)[None, :] * 33 + bins).reshape(-1)
    for stat, got in ((grad, hg), (hess, hh)):
        rep = jnp.broadcast_to((jnp.asarray(stat) * row_mask)[:, None]
                               * (row_mask > 0)[:, None], (n, f)).reshape(-1)
        want = np.asarray(jax.ops.segment_sum(rep, jnp.asarray(flat),
                                              num_segments=f * 33))
        np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed,depth,nan_share,min_hess",
                         [(0, 3, 0.0, 1.0), (1, 4, 0.1, 1.0),
                          (2, 6, 0.05, 0.5)])
def test_build_tree_matches_jax(seed, depth, nan_share, min_hess):
    x, y = _problem(seed, nan_share=nan_share)
    bins, _ = tgbm.quantile_bins(x, 16)
    rng = np.random.default_rng(seed + 20)
    grad = (rng.random(len(y)) - y).astype(np.float32)
    hess = (0.1 + rng.random(len(y))).astype(np.float32)
    row_mask = (rng.random(len(y)) < 0.7).astype(np.float32)
    feat_mask = (rng.random(x.shape[1]) < 0.7).astype(np.float32)
    args = (depth, 16, 1e-5, min_hess)
    want = jgbm.build_tree(*(jnp.asarray(a) for a in (
        bins, grad, hess, row_mask, feat_mask)), *args)
    got = tgbm.build_tree(*(_t(a) for a in (
        bins, grad, hess, row_mask, feat_mask)), *args)
    _assert_trees_equal(got, want)
    assert int((got.feature >= 0).sum()) > 0
    np.testing.assert_array_equal(
        tgbm.tree_route(got, _t(bins), depth).numpy(),
        np.asarray(jgbm.tree_route(want, jnp.asarray(bins), depth)))


def _fit_data(n_classes):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(240, 10)).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    score = np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 2])
    y = (score > 0).astype(np.float32) if n_classes == 1 else \
        np.digitize(score, [-0.7, 0.7]).astype(np.int32)
    cfg = dict(n_trees=4, max_depth=4, n_bins=16, n_classes=n_classes,
               seed=3)
    return x, y, cfg


def test_gbm_binary_fit_matches_jax():
    """A whole binary fit from the same data: the masks are numpy's, so
    every tree is the JAX package's; history and probabilities alike."""
    x, y, cfg = _fit_data(1)
    jm = jgbm.GBMModel(jgbm.GBMConfig(**cfg))
    tm = tgbm.GBMModel(tgbm.GBMConfig(**cfg), device="cpu")
    jh, th = jm.fit(x, y), tm.fit(x, y)
    np.testing.assert_allclose(th, jh, rtol=GBM_RTOL)
    assert len(tm.trees) == len(jm.trees) == 4
    for got, want in zip(tm.trees, jm.trees):
        _assert_trees_equal(got, want)
    np.testing.assert_array_equal(tm.leaf_indices(x), jm.leaf_indices(x))
    np.testing.assert_allclose(tm.predict_proba(x), jm.predict_proba(x),
                               rtol=GBM_RTOL, atol=1e-6)
    et, ej = tm.evaluate(x, y), jm.evaluate(x, y)
    assert sorted(et) == sorted(ej)
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=GBM_RTOL, err_msg=k)


def _assert_rounds_replay(jm, x, y, cfg):
    """Every tree of the JAX fit ``jm`` rebuilt by the port's
    ``build_tree`` from that fit's own gradients and numpy masks, round by
    round, is equal to it."""
    k = max(1, cfg.get("n_classes", 1))
    bins = jgbm.apply_bins(jm.edges, x)
    rng = np.random.default_rng(cfg.get("seed", 0))
    preds = jnp.zeros((len(y), k), jnp.float32)
    for t in range(cfg["n_trees"]):
        row_mask = (rng.random(len(y)) < 0.7).astype(np.float32)
        feat_mask = (rng.random(x.shape[1]) < 0.7).astype(np.float32)
        if k == 1:
            from lightctr_tpu.ops.activations import sigmoid

            p = sigmoid(preds[:, 0])
            stats = [(p - jnp.asarray(y), p * (1.0 - p))]
        else:
            p = jax.nn.softmax(preds, axis=-1)
            d = p - jnp.asarray(np.eye(k, dtype=np.float32)[y])
            h = 2.0 * p * (1.0 - p)
            stats = [(d[:, c], h[:, c]) for c in range(k)]
        for c, (g, h) in enumerate(stats):
            want = jm.trees[k * t + c]
            got = tgbm.build_tree(
                _t(bins), _t(g), _t(h), _t(row_mask), _t(feat_mask),
                cfg["max_depth"], cfg["n_bins"], 1e-5, 1.0)
            _assert_trees_equal(got, want)
            preds = preds.at[:, c].add(0.6 * jgbm.tree_predict(
                want, jnp.asarray(bins), cfg["max_depth"]))


def test_gbm_multiclass_rounds_match_jax():
    """Softmax GBM, K = 3 trees a round.  XLA's CPU ``exp`` and torch's
    round differently in the last place, so from the second round the two
    fits' softmax gradients differ by ulps and a near-tied split may go
    the other way (the binary fit's sigmoid likewise, more rarely).  So
    the port's build_tree is held to every tree of the JAX fit from that
    fit's own gradients and masks, and the port's own fit to the JAX fit's
    first round (p = 1/3 exactly), its loss history within rtol 2e-3 on
    this data."""
    x, y, cfg = _fit_data(3)
    jm = jgbm.GBMModel(jgbm.GBMConfig(**cfg))
    jh = jm.fit(x, y)
    _assert_rounds_replay(jm, x, y, cfg)
    tm = tgbm.GBMModel(tgbm.GBMConfig(**cfg), device="cpu")
    th = tm.fit(x, y)
    for got, want in zip(tm.trees[:3], jm.trees[:3]):
        _assert_trees_equal(got, want)
    np.testing.assert_allclose(th[0], jh[0], rtol=GBM_RTOL)
    np.testing.assert_allclose(th, jh, rtol=2e-3)
    assert th[-1] < th[0]
    assert tm.leaf_indices(x).shape == (len(y), 12)


def test_gbm_binary_separable(rng):
    n, f = 400, 10
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] > 0).astype(np.float32)
    model = tgbm.GBMModel(tgbm.GBMConfig(n_trees=8, max_depth=4, n_bins=32),
                          device="cpu")
    hist = model.fit(x, y)
    assert hist[-1] < hist[0]
    assert (model.predict(x) == y).mean() > 0.9
    assert auc_exact(model.predict_proba(x), y) > 0.95


def test_gbm_l1_threshold_and_leaf_weight():
    g = torch.tensor([2.0, -2.0, 1e-6])
    w = -tgbm._threshold_l1(g, 1e-5) / (1.0 + 1e-5)
    np.testing.assert_allclose(
        w.numpy(), [-1.99999 / 1.00001, 1.99999 / 1.00001, 0.0], rtol=1e-4)


def test_gbm_respects_subsampled_features(rng):
    n = 256
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    bins, _ = tgbm.quantile_bins(x, 16)
    tree = tgbm.build_tree(_t(bins), _t(y - 0.5), torch.full((n,), 0.25),
                           torch.ones(n), torch.tensor([0.0, 1.0, 1.0]), 3,
                           16, 1e-5, 1.0)
    used = set(tree.feature[tree.feature >= 0].tolist())
    assert 0 not in used


def test_gbm_sibling_histograms_partition_exactly():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 20)).astype(np.float32)
    y = ((x[:, 0] > 0) & (x[:, 1] > 0)).astype(np.float32)
    m = tgbm.GBMModel(tgbm.GBMConfig(n_trees=5, max_depth=4, n_bins=16,
                                     seed=1), device="cpu")
    m.fit(x, y)
    assert m.evaluate(x, y)["accuracy"] > 0.95


def test_gbm_deep_tree_at_image_width():
    """tests/test_gbm_em.py's depth-12 case at F = 784, at depth 8: the
    level merges of 400 x 784 slots into up to 128 x 784 x 17 segments."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(400, 784)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    m = tgbm.GBMModel(tgbm.GBMConfig(n_trees=1, max_depth=8, n_bins=16),
                      device="cpu")
    assert np.isfinite(m.fit(x, y)[-1])
    assert m.evaluate(x, y)["accuracy"] > 0.9


def test_nan_routed_by_learned_direction(rng):
    n = 400
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    x[y == 1, 0] = np.nan
    x[y == 0, 0] = rng.normal(size=int((y == 0).sum())) - 3.0
    model = tgbm.GBMModel(tgbm.GBMConfig(n_trees=4, max_depth=3, n_bins=16,
                                         feature_subsample=1.0), device="cpu")
    model.fit(x, y)
    assert model.evaluate(x, y)["accuracy"] > 0.95
    x_new = np.full((10, 3), np.nan, np.float32)
    x_new[:, 1:] = 0.0
    assert model.predict_proba(x_new).mean() > 0.8
    n2 = 300
    x2 = rng.normal(size=(n2, 2)).astype(np.float32)
    y2 = np.zeros(n2, np.float32)
    y2[: n2 // 2] = 1.0
    x2[: n2 // 4, 0] = np.nan
    x2[n2 // 4: n2 // 2, 0] = -5.0
    x2[n2 // 2:, 0] = 5.0
    m2 = tgbm.GBMModel(tgbm.GBMConfig(n_trees=3, max_depth=2, n_bins=8,
                                      feature_subsample=1.0), device="cpu")
    m2.fit(x2, y2)
    assert m2.evaluate(x2, y2)["accuracy"] > 0.95
    assert any(bool(b) for t in m2.trees
               for b in t.default_left[t.feature == 0])


def test_dense_data_unaffected_by_missing_slot(rng):
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.float32)
    model = tgbm.GBMModel(tgbm.GBMConfig(n_trees=5, max_depth=4, n_bins=16),
                          device="cpu")
    model.fit(x, y)
    assert model.evaluate(x, y)["accuracy"] > 0.9


def test_histogram_merges_counts_the_merge_rows_launches(monkeypatch):
    from lightctr_tpu_torch.ops import sparse_kernels

    calls = []
    real = sparse_kernels.merge_rows
    monkeypatch.setattr(sparse_kernels, "merge_rows",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x, y = _problem(3)
    bins, _ = tgbm.quantile_bins(x, 16)
    n = len(y)
    tgbm.build_tree(_t(bins), _t(y - 0.5), torch.full((n,), 0.25),
                    torch.ones(n), torch.ones(x.shape[1]), 5, 16, 1e-5, 1.0)
    assert len(calls) == tgbm.histogram_merges(5)
    assert all(s[1] == 1 for s in calls)
    assert calls[0][0] == n * x.shape[1]


def _stack_data(rng):
    x = rng.normal(size=(500, 8)).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0) | (x[:, 2] > 1.2)).astype(np.float32)
    return x, y


def test_stack_matches_jax(rng):
    """The stack's GBM: every JAX tree rebuilt by the port from the JAX
    fit's gradients.  Its LR half (``fit_lr``) over the JAX stack's trees
    carried across: the loss trajectory and weights within rtol 1e-4
    (FTRL's square roots), the report's keys and AUC."""
    from lightctr_tpu_torch.models import _common

    x, y = _stack_data(rng)
    cfg = dict(n_trees=6, max_depth=4, n_bins=16)
    js = jstack.GBMLRStack(jgbm.GBMConfig(**cfg), lr_steps=40)
    jh = js.fit(x, y)
    _assert_rounds_replay(js.gbm, x, y, cfg)
    ts = tstack.GBMLRStack(tgbm.GBMConfig(**cfg), lr_steps=40, device="cpu")
    ts.gbm.edges = js.gbm.edges
    ts.gbm.trees = [_common.params_from_numpy(
        jgbm.Tree(*(np.asarray(a) for a in t)), "cpu") for t in js.gbm.trees]
    assert isinstance(ts.gbm.trees[0], tgbm.Tree)
    lr = ts.fit_lr(x, y)
    np.testing.assert_allclose(lr, jh["lr_loss"], rtol=1e-4)
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=1e-4,
                               atol=1e-5)
    et, ej = ts.evaluate(x, y), js.evaluate(x, y)
    assert sorted(et) == sorted(ej)
    np.testing.assert_allclose(et["auc"], ej["auc"], rtol=1e-4)
    assert et["nonzero_weights"] == ej["nonzero_weights"]


def test_ftrl_state_carries_across():
    """The stack's optimizer state: the JAX ``FTRLState`` carried across
    (``opt_state_from_numpy``) continues as the JAX one does."""
    from lightctr_tpu import optim as joptim
    from lightctr_tpu_torch.models import _common
    from lightctr_tpu_torch.optim import updaters

    w = jnp.asarray(np.linspace(-1, 1, 7, dtype=np.float32))
    g = jnp.asarray(np.linspace(0.5, -0.5, 7, dtype=np.float32))
    jtx, ttx = joptim.ftrl(alpha=1.0, lambda1=0.003), \
        updaters.ftrl(alpha=1.0, lambda1=0.003)
    u, st = jtx.update(g, jtx.init(w), w)
    tst = _common.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, st), "cpu")
    assert isinstance(tst, updaters.FTRLState)
    w1 = w + u
    want_u, want_st = jtx.update(g, st, w1)
    got_u, got_st = ttx.update(_t(g), tst, _t(w1))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-5,
                               atol=1e-7)
    for a, b in zip(got_st, want_st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_stack_beats_or_matches_gbm_alone(rng):
    x, y = _stack_data(rng)
    stack = tstack.GBMLRStack(tgbm.GBMConfig(n_trees=8, max_depth=4,
                                             n_bins=16), device="cpu")
    hist = stack.fit(x, y)
    assert hist["lr_loss"][-1] < hist["lr_loss"][0]
    ev = stack.evaluate(x, y)
    assert ev["auc"] > 0.95, ev
    assert ev["auc"] > stack.gbm.evaluate(x, y)["auc"] - 0.02
    assert ev["nonzero_weights"] < stack.w.shape[0]


def test_stack_requires_fit_and_a_binary_gbm():
    stack = tstack.GBMLRStack(device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        stack.predict_proba(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="binary"):
        tstack.GBMLRStack(tgbm.GBMConfig(n_classes=3), device="cpu")


def test_gbm_and_stack_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgbm.GBMModel(tgbm.GBMConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstack.GBMLRStack()
