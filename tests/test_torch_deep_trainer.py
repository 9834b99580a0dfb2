"""The Wide&Deep family trained by the port's ``CTRTrainer`` (the
optimizer transform and the fused Adagrad kernel's plain version) and
``SparseTableCTRTrainer`` against the JAX package's trainers on the CPU
(tests/test_deepfm_dcn.py's sparse-trainer compose case, for every kind):
12 full-batch Adagrad steps from the JAX init carried across as numpy,
each kind's ``logits_with_l2`` (Wide&Deep: ``logits``) with lambda 0.001.
The table leaves train O(touched) (``w`` over ``fids``, ``embed`` over
``rep_fids``; DCN has no wide table), the MLP's and the cross network's
nested dense leaves through the optimizer transform.

Tolerance, measured: the 12 losses agree within 2.4e-7 relative, and
every parameter within rtol 1e-4 / atol 2e-5 (largest gap 2.6e-5 of a
value; the tanh of ``fc1``, which XLA's CPU code approximates, is in
every kind's path, ROADMAP §C "In the reference").  Losses are held at the
trainers' bound, rtol 2e-5 / atol 2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models_deep import KINDS, family_batch, family_params
from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.export import _flatten_params
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu.ops import sparse_kernels as jsk
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer

LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
CFG = dict(learning_rate=0.1, lambda_l2=0.001)
STEPS = 12

#: kind -> the sparse trainer's tables
TABLES = {"widedeep": {"w": ["fids"], "embed": ["rep_fids"]},
          "deepfm": {"w": ["fids"], "embed": ["rep_fids"]},
          "dcn": {"embed": ["rep_fids"]}}


def numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: a.numpy() if hasattr(a, "numpy") and not isinstance(
            a, np.ndarray) else np.asarray(a), tree)


def assert_trees_close(got, want, **tol):
    g, w = _flatten_params(numpy_tree(got)), _flatten_params(
        numpy_tree(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def trainers(kind, mode, p):
    _, jl, jl2, tl, tl2 = KINDS[kind]
    jkw = {} if jl2 is None else {"fused_fn": jl2}
    tkw = {} if tl2 is None else {"fused_fn": tl2}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = _common.params_from_numpy(p, "cpu")
    if mode == "sparse":
        jt = JSparseTrainer(jp, jl, JConfig(**CFG),
                            sparse_tables=TABLES[kind], **jkw)
        tt = SparseTableCTRTrainer(tp, tl, TrainConfig(**CFG),
                                   sparse_tables=TABLES[kind], device="cpu",
                                   **tkw)
    else:
        fused = mode == "fused"
        jt = JCTRTrainer(jp, jl, JConfig(**CFG), fused_adagrad=fused, **jkw)
        tt = CTRTrainer(tp, tl, TrainConfig(**CFG), fused_adagrad=fused,
                        device="cpu", **tkw)
    jt.health = tt.health = None
    return jt, tt


@pytest.mark.parametrize("mode", ["dense", "fused", "sparse"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_family_trajectory_matches_jax(monkeypatch, kind, mode):
    monkeypatch.setenv(jsk.ENV_FLAG, "xla")
    p, b = family_params(kind), family_batch(3)
    jt, tt = trainers(kind, mode, p)
    lj = np.asarray(jt.fit_fullbatch_scan(b, STEPS))
    lt = tt.fit_fullbatch_scan(b, STEPS)
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    assert lt[-1] < 0.5 * lt[0]
    assert_trees_close(tt.params, jt.params, **PARAM_TOL)
    if mode == "sparse":
        assert_trees_close(tt.opt_state["accum"], jt.opt_state["accum"],
                           **PARAM_TOL)
        assert_trees_close(tt.opt_state["dense"].accum,
                           jt.opt_state["dense"].accum, **PARAM_TOL)
    else:
        assert_trees_close(tt.opt_state.accum, jt.opt_state.accum,
                           **PARAM_TOL)


@pytest.mark.parametrize("kind", ["deepfm", "dcn"])
def test_sparse_trainer_restarts_from_the_jax_nested_state(monkeypatch,
                                                          kind):
    """Minibatch steps of the JAX sparse trainer, then both packages step
    on from its params and optimizer state (nested dense accumulators)."""
    monkeypatch.setenv(jsk.ENV_FLAG, "xla")
    p, b = family_params(kind, seed=4), family_batch(5, n=96)
    jt, tt = trainers(kind, "sparse", p)
    lj = jt.fit(b, epochs=2, batch_size=32)["loss"]
    lt = tt.fit(b, epochs=2, batch_size=32)["loss"]
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    tt.params = _common.params_from_numpy(numpy_tree(jt.params), "cpu")
    tt.opt_state = _common.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.opt_state), "cpu")
    nb = family_batch(6, n=32)
    np.testing.assert_allclose(float(tt.train_step(nb)),
                               float(jt.train_step(nb)), **LOSS_TOL)
    assert_trees_close(tt.params, jt.params, **PARAM_TOL)


def test_sparse_family_trainer_keeps_untouched_rows_and_matches_dense():
    """DeepFM's O(touched) step follows the port's own dense trainer
    (tests/test_sparse_trainer.py's bound) and leaves the rows no batch
    touched, and their accumulators, as they were."""
    p, b = family_params("deepfm", seed=7), family_batch(8)
    _, dense = trainers("deepfm", "dense", p)
    _, sparse = trainers("deepfm", "sparse", p)
    ld = dense.fit_fullbatch_scan(b, 8)
    ls = sparse.fit_fullbatch_scan(b, 8)
    np.testing.assert_allclose(ls, ld, rtol=1e-5, atol=1e-6)
    assert_trees_close(sparse.params, dense.params, rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(p["embed"].shape[0]),
                             b["rep_fids"])
    np.testing.assert_array_equal(
        sparse.params["embed"][untouched].numpy(), p["embed"][untouched])
    assert not sparse.opt_state["accum"]["embed"][untouched].any()


def test_family_trainers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _common.params_from_numpy(family_params("dcn"), "cpu")
    _, _, _, tl, tl2 = KINDS["dcn"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CTRTrainer(p, tl, TrainConfig(**CFG), fused_fn=tl2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseTableCTRTrainer(p, tl, TrainConfig(**CFG),
                              sparse_tables=TABLES["dcn"], fused_fn=tl2)


def criteo_family_batches(steps, n=256, vocab=4096, fields=39, n_cat=26,
                          seed=0):
    """Criteo-layout batches (data/synth.py's recipe: u^4 head/tail ids,
    one id per numeric field with an exponential value, a label planted
    as a logistic in two numeric fields and a head-id effect) with the
    field-representative pair (slot j is field j)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        fids = (rng.random((n, fields)) ** 4 * vocab).astype(np.int32)
        fids[:, n_cat:] = np.arange(n_cat, fields, dtype=np.int32)
        vals = np.ones((n, fields), np.float32)
        vals[:, n_cat:] = rng.exponential(1.0, (n, fields - n_cat)).astype(
            np.float32).round(3)
        z = ((vals[:, n_cat] - 1.0) + (vals[:, n_cat + 1] - 1.0)
             + (fids[:, 0] % 2).astype(np.float32) - 0.5)
        labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-2.0 * z))).astype(
            np.float32)
        out.append({"fids": fids, "vals": vals,
                    "mask": np.ones((n, fields), np.float32),
                    "labels": labels,
                    "rep_fids": fids, "rep_mask": np.ones_like(vals)})
    return out


def test_dcn_at_lr_0_05_diverges_at_criteo_width_in_both_packages(
        monkeypatch):
    """Why chip_smoke.py's train_deep trains DCN at lr 0.005: at the
    Criteo width (39 fields x 32 = 1,248 inputs, 3 crosses, hidden 50,
    the JAX init) Adagrad's first step moves every cross weight by about
    lr, and at lr 0.05 the crosses blow the logits up: over 8 steps the
    loss rises more than tenfold and ends above where it began, in the JAX
    package as in the port (the same losses to 1e-4).  At lr 0.005 it
    falls (the mean of the last 3 below that of the first 3)."""
    monkeypatch.setenv(jsk.ENV_FLAG, "xla")
    vocab, fields, dim = 4096, 39, 32
    batches = criteo_family_batches(8, vocab=vocab, fields=fields)
    rng = np.random.default_rng(1)
    d = fields * dim
    p = {"embed": (rng.standard_normal((vocab, dim)) / np.sqrt(dim)).astype(
            np.float32),
         "cross_w": (rng.standard_normal((3, d)) / np.sqrt(d)).astype(
            np.float32),
         "cross_b": np.zeros((3, d), np.float32),
         "fc1": {"w": (rng.random((50, d)) - 0.5).astype(np.float32),
                 "b": np.zeros(50, np.float32)},
         "out": {"w": (rng.random((1, d + 50)) - 0.5).astype(np.float32),
                 "b": np.zeros(1, np.float32)}}
    _, jl, jl2, tl, tl2 = KINDS["dcn"]
    for lr, diverges in ((0.05, True), (0.005, False)):
        cfg = dict(learning_rate=lr, lambda_l2=0.001)
        jt = JSparseTrainer(jax.tree_util.tree_map(jnp.asarray, p), jl,
                            JConfig(**cfg), sparse_tables=TABLES["dcn"],
                            fused_fn=jl2)
        tt = SparseTableCTRTrainer(_common.params_from_numpy(p, "cpu"), tl,
                                   TrainConfig(**cfg),
                                   sparse_tables=TABLES["dcn"],
                                   fused_fn=tl2, device="cpu")
        jt.health = tt.health = None
        lj = [float(jt.train_step(b)) for b in batches]
        lt = [float(tt.train_step(b)) for b in batches]
        np.testing.assert_allclose(lt, lj, rtol=1e-4)
        for losses in (lj, lt):
            if diverges:
                assert max(losses) > 10 * losses[0], losses
                assert losses[-1] > losses[0], losses
            else:
                assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
