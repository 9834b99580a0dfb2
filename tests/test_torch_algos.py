"""The zoo's last four modules of the port on the CPU, against the JAX
package: PCA (``ops/pca.py``), ensembling (``ops/ensembling.py``), the ANN
index (``models/ann.py``) and the DAG builder (``graph/dag.py``).

Mirrors ``tests/test_algos.py``'s PCA, ANN and ensembling cases,
``test_quantize_extra.py::test_vote_soft_weighted``,
``test_harness.py::test_dag_unit_test_parity`` and
``test_parity_holes.py``'s DAG aggregate cases, each also run through the
JAX module on the same numpy inputs.  Tolerances: GHA from the JAX init
carried across (JAX draws it from a key): its first epoch (7 Sanger steps)
within atol 1e-5 of the JAX steps, and the whole run (420 steps) within
atol 1e-3 of a float64 numpy run of the same steps (the iteration
amplifies the last place: the JAX run parts from float64 by 0.06 there,
which the JAX test's alignment criterion allows); SVD components
equal up to each row's sign within atol 1e-5; projections within rtol 1e-5
/ atol 1e-5; top-k indices equal where the k-th and (k+1)-th scores are
apart by more than 1e-4 (``lax.top_k`` and ``torch.topk`` may order ties
differently), scores within rtol 1e-5 / atol 1e-5; votes and AdaBoost
weights exact or within rtol 1e-6; DAG losses within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import graph as jgraph
from lightctr_tpu import optim as joptim
from lightctr_tpu.graph import dag as jdag
from lightctr_tpu.models import ann as jann
from lightctr_tpu.ops import ensembling as jens
from lightctr_tpu.ops import pca as jpca
from lightctr_tpu_torch import graph as tgraph
from lightctr_tpu_torch import optim as toptim
from lightctr_tpu_torch.graph import dag as tdag
from lightctr_tpu_torch.models import ann as tann
from lightctr_tpu_torch.ops import ensembling as tens
from lightctr_tpu_torch.ops import pca as tpca

GHA_EPOCH_ATOL = 1e-5
GHA_F64_ATOL = 1e-3
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_GAP = 1e-4


# -- PCA ----------------------------------------------------------------------


def _aniso(rng, n=500, d=8):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 0] *= 5.0
    return x


def test_pca_gha_matches_svd(rng, monkeypatch):
    """``test_algos.py``'s case: the top GHA component aligns with the SVD
    one (|cos| > 0.95); both packages' SVD components agree up to sign,
    and their GHA runs from the JAX init agree; ``reduce_dimension`` and
    ``remove_pc`` as the JAX functions."""
    x = _aniso(rng)
    w_svd = tpca.fit_svd(x, 2, device="cpu").numpy()
    j_svd = np.asarray(jpca.fit_svd(x, 2))
    signs = np.sign(np.sum(w_svd * j_svd, axis=1, keepdims=True))
    np.testing.assert_allclose(w_svd, signs * j_svd, atol=1e-5)
    key = jax.random.PRNGKey(0)
    init = np.asarray(jpca.init(key, x.shape[1], 2))
    monkeypatch.setattr(tpca, "init", lambda g, d, c, device="cuda":
                        torch.from_numpy(init).to(device))
    gen = torch.Generator().manual_seed(0)
    one = tpca.fit_gha(gen, x, 2, epochs=1, lr=0.05, device="cpu").numpy()
    np.testing.assert_allclose(
        one, np.asarray(jpca.fit_gha(key, x, 2, epochs=1, lr=0.05)),
        atol=GHA_EPOCH_ATOL)
    w_gha = tpca.fit_gha(gen, x, 2, epochs=60, lr=0.05, device="cpu").numpy()
    xc = (x - x.mean(axis=0, keepdims=True)).astype(np.float64)
    w64 = init.astype(np.float64)
    for _ in range(60):
        for xb in xc[:448].reshape(7, 64, 8):
            y = xb @ w64.T
            w64 = w64 + 0.05 * (y.T @ xb - np.tril(y.T @ y) @ w64) / 64
    w64 /= np.linalg.norm(w64, axis=1, keepdims=True)
    np.testing.assert_allclose(w_gha, w64, atol=GHA_F64_ATOL)
    j_gha = np.asarray(jpca.fit_gha(key, x, 2, epochs=60, lr=0.05))
    for w in (w_gha, j_gha):
        align = abs(float(np.dot(w_svd[0], w[0])))
        assert align > 0.95, align
    wt, xt = torch.from_numpy(w_svd), torch.from_numpy(x)
    reduced = tpca.reduce_dimension(wt, xt)
    assert reduced.shape == (500, 2)
    np.testing.assert_allclose(
        reduced.numpy(),
        np.asarray(jpca.reduce_dimension(jnp.asarray(w_svd), x)),
        rtol=1e-5, atol=1e-5)
    removed = tpca.remove_pc(wt[:1], xt).numpy()
    np.testing.assert_allclose(
        removed, np.asarray(jpca.remove_pc(jnp.asarray(w_svd[:1]), x)),
        rtol=1e-5, atol=1e-5)
    assert float(np.abs(removed @ w_svd[0]).max()) < 1e-2


def test_pca_sanger_step_and_init(rng):
    """One Sanger step on equal inputs equals the JAX step; the port's
    init draws unit rows from a ``torch.Generator``, the same rows for
    the same seed."""
    w = rng.normal(size=(3, 8)).astype(np.float32)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tpca.sanger_step(torch.from_numpy(w), torch.from_numpy(x),
                         0.05).numpy(),
        np.asarray(jpca.sanger_step(jnp.asarray(w), jnp.asarray(x), 0.05)),
        rtol=1e-5, atol=1e-6)
    a = tpca.init(torch.Generator().manual_seed(3), 8, 3, device="cpu")
    b = tpca.init(torch.Generator().manual_seed(3), 8, 3, device="cpu")
    assert torch.equal(a, b) and a.shape == (3, 8)
    np.testing.assert_allclose(torch.linalg.norm(a, dim=1).numpy(), 1.0,
                               rtol=1e-6)


# -- ANN ----------------------------------------------------------------------


def _assert_topk_equal(got_idx, got_val, want_idx, want_val, scores):
    """Equal top-k sets row by row where the k-th and (k+1)-th exact
    scores are apart by more than TIE_GAP (and in the same order where
    neighbours are), scores within SCORE_TOL."""
    np.testing.assert_allclose(got_val, want_val, **SCORE_TOL)
    k = got_idx.shape[1]
    srt = -np.sort(-scores, axis=1)
    held = 0
    for r in range(got_idx.shape[0]):
        if scores.shape[1] > k and srt[r, k - 1] - srt[r, k] <= TIE_GAP:
            continue
        held += 1
        assert set(got_idx[r]) == set(want_idx[r]), r
    assert held >= got_idx.shape[0] // 2


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_brute_force_topk_matches_jax(rng, metric):
    corpus = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(20, 16)).astype(np.float32)
    ti, tv = tann.brute_force_topk(queries, corpus, 10, metric=metric,
                                   device="cpu")
    ji, jv = jann.brute_force_topk(queries, corpus, 10, metric=metric)
    q64, c64 = queries.astype(np.float64), corpus.astype(np.float64)
    exact = (q64 @ c64.T if metric == "dot" else
             -((q64[:, None, :] - c64[None]) ** 2).sum(-1))
    _assert_topk_equal(ti, tv, np.asarray(ji), np.asarray(jv), exact)
    assert ti.shape == (20, 10) and np.all(np.diff(tv, axis=1) <= 0)
    with pytest.raises(ValueError, match="metric"):
        tann.brute_force_topk(queries, corpus, 10, metric="cos",
                              device="cpu")


def test_ann_index_recall(rng):
    """``test_algos.py``'s case: recall@10 above 0.6 at a budget of 400;
    the forest (host numpy from one seed) is the JAX index's node for
    node, so every query's result equals the JAX index's."""
    corpus = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(20, 16)).astype(np.float32)
    exact_idx, _ = tann.brute_force_topk(queries, corpus, 10, device="cpu")
    index = tann.ANNIndex(n_trees=10, leaf_size=32, seed=0,
                          device="cpu").build(corpus)
    jindex = jann.ANNIndex(n_trees=10, leaf_size=32, seed=0).build(corpus)
    for t, jt in zip(index.trees, jindex.trees):
        assert len(t) == len(jt)
        for a, b in zip(t, jt):
            assert (a.left, a.right, a.b) == (b.left, b.right, b.b)
            for x, y in ((a.w, b.w), (a.items, b.items)):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
    recalls = []
    for qi in range(20):
        got, vals = index.query(queries[qi], 10, search_budget=400)
        jgot, jvals = jindex.query(queries[qi], 10, search_budget=400)
        np.testing.assert_allclose(vals, np.asarray(jvals), **SCORE_TOL)
        assert set(got.tolist()) == set(jgot.tolist())
        recalls.append(len(set(got.tolist())
                           & set(exact_idx[qi].tolist())) / 10)
    assert np.mean(recalls) > 0.6, np.mean(recalls)


def test_ann_and_topk_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tann.ANNIndex()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tann.brute_force_topk(np.zeros((1, 2)), np.zeros((3, 2)), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpca.fit_svd(np.zeros((4, 2)), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.Graph()


# -- ensembling ---------------------------------------------------------------


def test_ensembling(rng):
    """``test_algos.py``'s case, and the same calls against the JAX
    functions."""
    preds = np.asarray([[0, 1, 1], [0, 1, 0], [1, 1, 0]])
    out = tens.vote_hard(torch.from_numpy(preds)).numpy()
    np.testing.assert_array_equal(out, [0, 1, 0])
    np.testing.assert_array_equal(out, np.asarray(jens.vote_hard(preds)))
    w = torch.full((4,), 0.25)
    pred = torch.tensor([0, 1, 0, 1])
    true = torch.tensor([0, 0, 0, 1])
    new_w, alpha = tens.adaboost_step(w, pred, true)
    assert float(alpha) > 0  # err = 0.25 < 0.5
    assert float(new_w[1]) > float(new_w[0])  # misclassified upweighted
    jw, ja = jens.adaboost_step(jnp.full((4,), 0.25), jnp.asarray(pred),
                                jnp.asarray(true))
    np.testing.assert_allclose(new_w.numpy(), np.asarray(jw), rtol=1e-6)
    assert float(alpha) == pytest.approx(float(ja), rel=1e-6)


def test_vote_soft_weighted():
    probs = np.asarray([
        [[0.9, 0.1], [0.2, 0.8]],   # model 0
        [[0.4, 0.6], [0.4, 0.6]],   # model 1
    ], np.float32)
    out = tens.vote_soft(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(out, [0, 1])
    weights = np.asarray([0.1, 2.0], np.float32)
    out_w = tens.vote_soft(torch.from_numpy(probs),
                           weights=torch.from_numpy(weights)).numpy()
    np.testing.assert_array_equal(out_w, [1, 1])
    np.testing.assert_array_equal(out_w, np.asarray(jens.vote_soft(
        jnp.asarray(probs), weights=jnp.asarray(weights))))


def test_votes_keep_the_jax_semantics_at_the_edges(rng):
    """An id outside ``[0, num_classes)`` (negative or too large) votes
    for nothing, as ``jax.nn.one_hot``'s zero row; ties go to the lowest
    class in both packages; random votes and probabilities agree."""
    preds = np.asarray([[-1, 3, 7, 2, 5, -4],
                        [-1, 3, 9, 2, 1, 0],
                        [4, 9, 9, -2, 1, 0]])
    for nc in (4, 8, 10):
        got = tens.vote_hard(torch.from_numpy(preds), num_classes=nc)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jens.vote_hard(preds, num_classes=nc)),
            err_msg=str(nc))
    ties = np.asarray([[2, 1, 3], [1, 2, 0]])
    np.testing.assert_array_equal(tens.vote_hard(torch.from_numpy(ties),
                                                 4).numpy(), [1, 1, 0])
    big = rng.integers(0, 10, size=(5, 1000))
    np.testing.assert_array_equal(
        tens.vote_hard(torch.from_numpy(big), 10).numpy(),
        np.asarray(jens.vote_hard(big, num_classes=10)))
    probs = rng.random((5, 1000, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        tens.vote_soft(torch.from_numpy(probs)).numpy(),
        np.asarray(jens.vote_soft(jnp.asarray(probs))))


def test_adaboost_rounds_match_jax(rng):
    """Ten AdaBoost rounds over five models' predictions of 1,000 rows:
    sample weights and alphas within rtol 1e-5 of the JAX rounds."""
    true = rng.integers(0, 10, 1000)
    preds = np.where(rng.random((10, 1000)) < 0.7, true,
                     rng.integers(0, 10, (10, 1000)))
    w, jw = torch.full((1000,), 1e-3), jnp.full((1000,), 1e-3)
    for r in range(10):
        w, a = tens.adaboost_step(w, torch.from_numpy(preds[r]),
                                  torch.from_numpy(true))
        jw, ja = jens.adaboost_step(jw, jnp.asarray(preds[r]),
                                    jnp.asarray(true))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
        assert float(a) == pytest.approx(float(ja), rel=1e-5)


# -- the DAG builder ------------------------------------------------------------


def _demo(mod):
    """The -DDAG demo graph in package ``mod``: (graph, p, loss)."""
    g = mod.Graph(device="cpu") if mod is tgraph else mod.Graph()
    zeros = torch.zeros if mod is tgraph else jnp.zeros
    x = g.add_node(mod.source("x"))
    w = g.add_node(mod.trainable("w", zeros((4,))))
    b = g.add_node(mod.trainable("b", zeros(())))
    wx = g.add_node(mod.matmul(x, w))
    z = g.add_node(mod.add(wx, b))
    p = g.add_node(mod.activation(z, "sigmoid"))
    loss_id = g.add_node(mod.logistic_loss_node(p, label_name="y"))
    return g, p, loss_id


def test_dag_unit_test_parity(rng):
    """The reference's -DDAG test: sigma(w*x + b) with logistic loss
    trains for 20 steps with decreasing loss (main.cpp:80-116), in both
    packages on the same feeds, the losses within rtol 1e-5."""
    w_true = rng.normal(size=(4,)).astype(np.float32)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = (1 / (1 + np.exp(-X @ w_true)) > rng.random(64)).astype(np.float32)
    runs = []
    for mod, opt in ((tgraph, toptim), (jgraph, joptim)):
        g, p, loss_id = _demo(mod)
        feeds = ({"x": torch.from_numpy(X), "y": torch.from_numpy(y)}
                 if mod is tgraph else
                 {"x": jnp.asarray(X), "y": jnp.asarray(y)})
        step, opt_state = g.compile_train_step(loss_id, opt.sgd(0.5))
        params = g.init_params()
        losses = []
        for _ in range(20):
            params, opt_state, loss = step(params, opt_state, feeds)
            losses.append(float(loss))
        probs = np.asarray(g.compile_forward(p)(params, feeds))
        runs.append((losses, probs))
    (tl, tp), (jl, jp) = runs
    assert tl[-1] < tl[0], tl  # "Pass All DAG UnitTest!"
    assert tp.shape == (64,) and np.all((tp > 0) & (tp < 1))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)


def test_dag_default_optimizer_is_sgd_0_1(rng):
    """``compile_train_step`` without an optimizer steps SGD at 0.1, as
    the JAX builder does."""
    X = rng.normal(size=(16, 4)).astype(np.float32)
    y = (rng.random(16) > 0.5).astype(np.float32)
    out = []
    for mod in (tgraph, jgraph):
        g, _, loss_id = _demo(mod)
        step, st = g.compile_train_step(loss_id)
        params, st, _ = step(g.init_params(), st, {"x": X, "y": y} if
                             mod is tgraph else {"x": jnp.asarray(X),
                                                 "y": jnp.asarray(y)})
        out.append(np.asarray(params["w"]))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-7)


def test_dag_aggregate_multi_output():
    """``test_parity_holes.py``'s aggregate: three outputs fanned out to
    three consumers, the aggregate computed once."""
    g = tdag.Graph(device="cpu")
    x = g.add_node(tdag.source("x"))
    y = g.add_node(tdag.source("y"))
    calls = []

    def split_fn(a, b):
        calls.append(1)
        return a + b, a - b, a * b

    agg = g.add_node(tdag.aggregate([x, y], split_fn, name="sumdiffprod"))
    s = g.add_node(tdag.project(agg, 0))
    d = g.add_node(tdag.project(agg, 1))
    p = g.add_node(tdag.project(agg, 2))
    out = g.add_node(tdag.add(s, d))       # (a+b) + (a-b) = 2a
    out2 = g.add_node(tdag.multiply(out, p))
    fwd = g.compile_forward(out2)
    feeds = {"x": torch.tensor(3.0), "y": torch.tensor(2.0)}
    assert float(fwd({}, feeds)) == pytest.approx(2 * 3.0 * 6.0)
    assert len(calls) == 1


def test_dag_aggregate_trainable_backward():
    """``test_parity_holes.py``'s trainable aggregate: the loss falls over
    10 SGD steps, and every step's loss is the JAX builder's within rtol
    1e-5."""
    feats = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    runs = []
    for dag, opt, sig in ((tdag, toptim, torch.sigmoid),
                          (jdag, joptim, jax.nn.sigmoid)):
        g = dag.Graph(device="cpu") if dag is tdag else dag.Graph()
        x = g.add_node(dag.source("x"))
        ones = torch.ones((4,)) if dag is tdag else jnp.ones((4,))
        w = g.add_node(dag.trainable("w", init=ones))

        def affine_pair(f, weights, _sig=sig):
            z = f @ weights
            return z, _sig(z)

        agg = g.add_node(dag.aggregate([x, w], affine_pair, name="affine"))
        prob = g.add_node(dag.project(agg, 1))
        loss = g.add_node(dag.logistic_loss_node(prob, label_name="y"))
        step, opt_state = g.compile_train_step(loss, opt.sgd(0.5))
        params = g.init_params()
        feeds = ({"x": torch.from_numpy(feats), "y": torch.zeros(16)}
                 if dag is tdag else
                 {"x": jnp.asarray(feats), "y": jnp.zeros((16,))})
        losses = []
        for _ in range(10):
            params, opt_state, l = step(params, opt_state, feeds)
            losses.append(float(l))
        runs.append(losses)
    assert runs[0][-1] < runs[0][0]
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


def test_dag_names_are_the_jax_module_names():
    jnames = {n for n in vars(jdag) if not n.startswith("_")
              and callable(getattr(jdag, n))}
    assert jnames - {n for n in vars(tdag)} <= {"jax", "jnp", "optax"}
    assert tgraph.__all__ == jgraph.__all__
