"""The port's training slice against the JAX package on the CPU: losses,
metrics and optimizers; ``CTRTrainer`` (optimizer transform and
``fused_adagrad``) and ``SparseTableCTRTrainer`` trajectories from the
same numpy init; the sparse trainer against the port's own dense trainer;
``evaluate``; FM's dense formulation; the ctor refusals; and the entry
points' CUDA default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu import optim as joptim
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu.ops import losses as jlosses
from lightctr_tpu.ops import metrics as jmetrics
from lightctr_tpu.ops import sparse_kernels as jsk
from lightctr_tpu_torch import optim as toptim
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.obs import health as thealth
from lightctr_tpu_torch.ops import losses as tlosses
from lightctr_tpu_torch.ops import metrics as tmetrics
from lightctr_tpu_torch.ops import sparse_kernels as tsk

F, K, N, NNZ = 512, 8, 96, 5
TABLES = {"w": ["fids"], "v": ["fids"]}
# the JAX sparse trainer's own interpret-vs-reference trajectory bound
# (tests/test_sparse_kernels.py); cross-framework sums differ in order
RTOL, ATOL = 2e-5, 2e-6


def fm_batch(seed=0, n=N, f=F, nnz=NNZ):
    rng = np.random.default_rng(seed)
    return {
        "fids": rng.integers(1, f, size=(n, nnz)).astype(np.int32),
        "fields": np.zeros((n, nnz), np.int32),
        "vals": rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32),
        "mask": (rng.random((n, nnz)) < 0.9).astype(np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
    }


def init_params(f=F, k=K):
    p = jfm.init(jax.random.PRNGKey(0), f, k)
    return {key: np.asarray(v) for key, v in p.items()}


def tparams(np_params):
    return tfm.params_from_numpy(np_params, "cpu")


def assert_params_close(jax_params, torch_params, rtol=RTOL, atol=ATOL):
    for key in ("w", "v"):
        np.testing.assert_allclose(torch_params[key].numpy(),
                                   np.asarray(jax_params[key]),
                                   rtol=rtol, atol=atol, err_msg=key)


# -- losses, metrics, optimizers ------------------------------------------


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(1)
    z = (rng.normal(size=64) * 4).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    p = rng.uniform(0, 1, size=64).astype(np.float32)
    for jf, tf, a in ((jlosses.logistic_loss, tlosses.logistic_loss, z),
                      (jlosses.square_loss, tlosses.square_loss, z),
                      (jlosses.bce_on_probs, tlosses.bce_on_probs, p)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(y), reduction))
        got = tf(torch.from_numpy(a), torch.from_numpy(y), reduction).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tlosses.get("logistic") is tlosses.logistic_loss
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get("hinge")
    with pytest.raises(ValueError, match="reduction"):
        tlosses.logistic_loss(torch.zeros(2), torch.zeros(2), "max")


def test_logistic_loss_gradient_is_sigmoid_minus_label():
    z = torch.tensor([-20.0, -1.0, 0.0, 2.0, 30.0], requires_grad=True)
    y = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0])
    tlosses.logistic_loss(z, y).backward()
    torch.testing.assert_close(z.grad, torch.sigmoid(z.detach()) - y)


@pytest.mark.parametrize("num_bins", [64, 1 << 20])
def test_metrics_match_jax(num_bins):
    rng = np.random.default_rng(2)
    s = rng.uniform(0, 1, size=500).astype(np.float32)
    y = (rng.random(500) < s).astype(np.int32)
    ts, ty = torch.from_numpy(s), torch.from_numpy(y)
    assert float(tmetrics.auc_histogram(ts, ty, num_bins)) == pytest.approx(
        float(jmetrics.auc_histogram(jnp.asarray(s), jnp.asarray(y),
                                     num_bins)), abs=1e-7)
    stream = tmetrics.StreamingAUC(num_bins)
    for lo in range(0, 500, 128):
        stream.update(ts[lo:lo + 128], ty[lo:lo + 128])
    assert stream.result() == pytest.approx(
        float(tmetrics.auc_histogram(ts, ty, num_bins)), abs=1e-7)
    assert tmetrics.auc_exact(ts, ty) == jmetrics.auc_exact(s, y)
    assert float(tmetrics.logloss(ts, ty.float())) == pytest.approx(
        float(jmetrics.logloss(jnp.asarray(s), jnp.asarray(y, jnp.float32))),
        rel=1e-6)
    pred = (ts > 0.5).int()
    assert float(tmetrics.accuracy(pred, ty)) == pytest.approx(
        float(jmetrics.accuracy(jnp.asarray(pred.numpy()), jnp.asarray(y))))
    assert tmetrics.StreamingAUC(num_bins).result() == 0.0


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_updaters_match_jax(name):
    rng = np.random.default_rng(3)
    p = {"a": rng.normal(size=(7, 3)).astype(np.float32),
         "b": rng.normal(size=5).astype(np.float32)}
    gs = [{k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in p.items()} for _ in range(4)]
    jtx, ttx = joptim.get(name, learning_rate=0.1), toptim.get(
        name, learning_rate=0.1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in gs:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        tp = toptim.apply_updates(tp, tu)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.get("adamw", learning_rate=0.1)


def test_fm_dense_formulation_and_l2_match_jax():
    b = fm_batch(4, n=32, f=64)
    p = init_params(64, 4)
    p["w"] = np.random.default_rng(5).normal(size=64).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_l2 = np.asarray(jfm.l2_penalty({k: jnp.asarray(v) for k, v in
                                         p.items()},
                                        {k: jnp.asarray(v) for k, v in
                                         b.items()}))
    np.testing.assert_allclose(tfm.l2_penalty(tparams(p), tb).numpy(),
                               want_l2, rtol=1e-5)
    jd, td = jfm.densify(b, 64), tfm.densify(b, 64)
    for key in jd:
        np.testing.assert_array_equal(td[key], jd[key])
    tz, tl2 = tfm.dense_logits_with_l2(
        tparams(p), {k: torch.from_numpy(v) for k, v in td.items()})
    sz, sl2 = tfm.logits_with_l2(tparams(p), tb)
    torch.testing.assert_close(tz, sz, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tl2, sl2, rtol=1e-5, atol=1e-5)
    jz = jfm.dense_logits({k: jnp.asarray(v) for k, v in p.items()},
                          {k: jnp.asarray(v) for k, v in jd.items()})
    np.testing.assert_allclose(tfm.dense_logits(
        tparams(p), {k: torch.from_numpy(v) for k, v in td.items()}).numpy(),
        np.asarray(jz), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        tfm.densify(b, 8)


# -- trainers against the JAX package ---------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["interpret", "xla"])
def test_ctr_trainer_matches_jax(monkeypatch, mode, fused):
    """CTRTrainer, full-batch fit over 12 Adagrad epochs, with the
    optimizer transform and with the fused Adagrad kernel's plain version;
    the JAX trainer's kernels run interpreted or through their XLA
    twins (one trainer per mode: the pick is made at trace time)."""
    monkeypatch.setenv(jsk.ENV_FLAG, mode)
    b, p = fm_batch(), init_params()
    jt = JCTRTrainer(p, jfm.logits, JConfig(learning_rate=0.1),
                     fused_adagrad=fused)
    tt = CTRTrainer(tparams(p), tfm.logits, TrainConfig(learning_rate=0.1),
                    fused_adagrad=fused, device="cpu")
    jt.health = tt.health = None
    lj = jt.fit(b, epochs=12)["loss"]
    lt = tt.fit(b, epochs=12)["loss"]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    assert lt[-1] < lt[0]
    assert_params_close(jt.params, tt.params)
    np.testing.assert_allclose(tt.opt_state.accum["v"].numpy(),
                               np.asarray(jt.opt_state.accum["v"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["interpret", "xla"])
def test_sparse_trainer_matches_jax(monkeypatch, mode):
    """SparseTableCTRTrainer.fit against the JAX trainer whose dedup and
    merge_apply run as interpreted Pallas kernels (or XLA twins), at the
    JAX interpret-vs-reference bound."""
    monkeypatch.setenv(jsk.ENV_FLAG, mode)
    b, p = fm_batch(1), init_params()
    cfg = dict(learning_rate=0.1, lambda_l2=0.001)
    jt = JSparseTrainer(p, jfm.logits, JConfig(**cfg), sparse_tables=TABLES,
                        fused_fn=jfm.logits_with_l2)
    tt = SparseTableCTRTrainer(tparams(p), tfm.logits, TrainConfig(**cfg),
                               sparse_tables=TABLES,
                               fused_fn=tfm.logits_with_l2, device="cpu")
    jt.health = tt.health = None
    lj = jt.fit(b, epochs=6)["loss"]
    lt = tt.fit(b, epochs=6)["loss"]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    assert_params_close(jt.params, tt.params)
    for key in ("w", "v"):
        np.testing.assert_allclose(tt.opt_state["accum"][key].numpy(),
                                   np.asarray(jt.opt_state["accum"][key]),
                                   rtol=RTOL, atol=ATOL)


def test_sparse_trainer_minibatch_fit_and_opt_state_from_numpy():
    """Minibatch fit (the same shuffles from cfg.seed) matches JAX; then
    both packages continue from the JAX trainer's (params, opt_state)."""
    b, p = fm_batch(2, n=128), init_params()
    jt = JSparseTrainer(p, jfm.logits, JConfig(learning_rate=0.05),
                        sparse_tables=TABLES)
    tt = SparseTableCTRTrainer(tparams(p), tfm.logits,
                               TrainConfig(learning_rate=0.05),
                               sparse_tables=TABLES, device="cpu")
    jt.health = tt.health = None
    lj = jt.fit(b, epochs=3, batch_size=32)["loss"]
    lt = tt.fit(b, epochs=3, batch_size=32)["loss"]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    # restart the port from the JAX state and step both once more
    state = jax.tree_util.tree_map(np.asarray, jt.opt_state)
    tt.params = tparams({k: np.asarray(v) for k, v in jt.params.items()})
    tt.opt_state = tfm.opt_state_from_numpy(state, "cpu")
    nb = fm_batch(3, n=32)
    np.testing.assert_allclose(float(tt.train_step(nb)),
                               float(jt.train_step(nb)), rtol=RTOL)
    assert_params_close(jt.params, tt.params)


def test_opt_state_from_numpy_of_ctr_trainer():
    b, p = fm_batch(6), init_params()
    jt = JCTRTrainer(p, jfm.logits, JConfig(learning_rate=0.1),
                     fused_adagrad=True)
    jt.health = None
    jt.fit(b, epochs=3)
    tt = CTRTrainer(tparams({k: np.asarray(v) for k, v in jt.params.items()}),
                    tfm.logits, TrainConfig(learning_rate=0.1),
                    fused_adagrad=True, device="cpu")
    tt.health = None
    tt.opt_state = tfm.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.opt_state), "cpu")
    np.testing.assert_allclose(tt.fit_fullbatch_scan(b, 4),
                               jt.fit_fullbatch_scan(b, 4), rtol=RTOL,
                               atol=ATOL)
    assert_params_close(jt.params, tt.params)
    with pytest.raises(ValueError, match="Adagrad"):
        tfm.opt_state_from_numpy({"m": 1}, "cpu")


def test_sparse_trainer_matches_dense_trainer():
    """The O(touched) step's trajectory is the dense Adagrad trainer's
    (tests/test_sparse_trainer.py's bound)."""
    b = fm_batch(7, n=64, nnz=6)
    p = init_params(F, 4)
    cfg = TrainConfig(learning_rate=0.1, lambda_l2=0.001)
    dense = CTRTrainer(tparams(p), tfm.logits, cfg,
                       fused_fn=tfm.logits_with_l2, device="cpu")
    sparse = SparseTableCTRTrainer(tparams(p), tfm.logits, cfg,
                                   sparse_tables=TABLES,
                                   fused_fn=tfm.logits_with_l2, device="cpu")
    ld = dense.fit_fullbatch_scan(b, 15)
    ls = sparse.fit_fullbatch_scan(b, 15)
    np.testing.assert_allclose(ls, ld, rtol=1e-5, atol=1e-6)
    for key in ("w", "v"):
        torch.testing.assert_close(sparse.params[key], dense.params[key],
                                   rtol=1e-5, atol=1e-6)


def test_l2_fn_path_matches_fused_fn_path():
    b, p = fm_batch(8), init_params()
    cfg = TrainConfig(learning_rate=0.1, lambda_l2=0.01)
    a = CTRTrainer(tparams(p), tfm.logits, cfg, l2_fn=tfm.l2_penalty,
                   device="cpu")
    f = CTRTrainer(tparams(p), tfm.logits, cfg, fused_fn=tfm.logits_with_l2,
                   device="cpu")
    np.testing.assert_allclose(a.fit_fullbatch_scan(b, 5),
                               f.fit_fullbatch_scan(b, 5), rtol=1e-6)


@pytest.mark.parametrize("batch_size", [None, 40])
def test_evaluate_matches_jax(batch_size):
    b, p = fm_batch(9, n=200), init_params()
    p["w"] = np.random.default_rng(9).normal(size=F).astype(np.float32)
    jt = JCTRTrainer(p, jfm.logits, JConfig())
    tt = CTRTrainer(tparams(p), tfm.logits, TrainConfig(), device="cpu")
    want = jt.evaluate(b, batch_size=batch_size)
    got = tt.evaluate(b, batch_size=batch_size)
    assert got["logloss"] == pytest.approx(want["logloss"], abs=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-5)
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-4)
    np.testing.assert_allclose(tt.predict_proba(b), jt.predict_proba(b),
                               rtol=1e-5, atol=1e-6)


def test_train_step_returns_loss_tensor_and_feeds_health():
    b, p = fm_batch(10), init_params()
    before = tsk.launches()
    tt = SparseTableCTRTrainer(tparams(p), tfm.logits, TrainConfig(),
                               sparse_tables=TABLES, device="cpu")
    tt.health = thealth.HealthMonitor()
    thealth.ensure_trainer_detectors(tt.health, tables=True)
    loss = tt.train_step(b)
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert not loss.requires_grad
    for _ in range(3):
        tt.train_step(b)
    tt.flush_health()
    assert tt._health_pending == []
    assert tt._steps_seen == 4
    assert tt.health.status() in ("ok", "degraded", "unhealthy")
    # the plain versions ran: no kernel launch was counted
    assert tsk.launches() == before


# -- refusals ----------------------------------------------------------------


#: what each of the JAX trainers' multi-device and telemetry arguments
#: meets in the port when given alone: ``mesh``, ``compress_bits`` and
#: ``hier_exchange`` are ported (a mesh must be a port Mesh; compress_bits
#: and the two-level exchange need one), ``quality_bins`` is ported and
#: arms the quality sketch, the rest are not yet ported
REFUSALS = {"mesh": "mesh must be a lightctr_tpu_torch",
            "compress_bits": "compress_bits requires a mesh",
            "hier_exchange": "hier_exchange needs a mesh"}


def _build_or_refuse(arg, build):
    """``quality_bins`` arms the trainer's quality tracker and
    ``resources`` its compile tracker (over the step's and the scorer's
    input signatures); any other argument given alone raises."""
    if arg == "quality_bins":
        tr = build()
        assert tr._quality_bins == 8 and tr.quality is not None
        tr.quality.close()
        return
    if arg == "resources":
        tr = build()
        assert tr.resources is not None
        assert {"trainer_step", "trainer_logits"} <= set(
            tr.resources.snapshot()["fns"])
        tr.resources.close()
        return
    with pytest.raises(ValueError,
                       match=REFUSALS.get(arg, f"{arg} not yet ported")):
        build()


@pytest.mark.parametrize("arg", ["mesh", "param_shardings", "compress_bits",
                                 "zero_sharded", "quality_bins",
                                 "resources"])
def test_ctr_trainer_refuses_unported_arguments(arg):
    _build_or_refuse(arg, lambda: CTRTrainer(
        tparams(init_params()), tfm.logits, TrainConfig(), device="cpu",
        **{arg: 8 if arg != "zero_sharded" else True}))


@pytest.mark.parametrize("arg", ["mesh", "param_shardings", "compress_bits",
                                 "hier_exchange", "quality_bins"])
def test_sparse_trainer_refuses_unported_arguments(arg):
    _build_or_refuse(arg, lambda: SparseTableCTRTrainer(
        tparams(init_params()), tfm.logits, TrainConfig(),
        sparse_tables=TABLES, device="cpu", **{arg: 8}))


def test_sparse_trainer_ctor_validation_and_fit_refusals():
    p = tparams(init_params())
    with pytest.raises(ValueError, match="at least one"):
        SparseTableCTRTrainer(p, tfm.logits, TrainConfig(), sparse_tables={},
                              device="cpu")
    with pytest.raises(ValueError, match="not in params"):
        SparseTableCTRTrainer(p, tfm.logits, TrainConfig(),
                              sparse_tables={"emb": ["fids"]}, device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        SparseTableCTRTrainer(p, tfm.logits, TrainConfig(),
                              sparse_tables={"w": ["fids"],
                                             "v": ["fids", "rep"]},
                              device="cpu")
    with pytest.raises(ValueError, match="replaces the optimizer"):
        CTRTrainer(p, tfm.logits, TrainConfig(), fused_adagrad=True,
                   optimizer=toptim.adagrad(0.1), device="cpu")
    tt = CTRTrainer(p, tfm.logits, TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="prefetch depth must be >= 1"):
        tt.fit(fm_batch(), epochs=1, batch_size=32, prefetch=-1)
    # a path that is no cache directory is a raw file to compile, which
    # needs max_nnz (as_arrays' refusal, the JAX package's too)
    with pytest.raises(ValueError, match="needs max_nnz"):
        tt.fit("/nonexistent/cache", epochs=1)
    with pytest.raises(ValueError, match="exceeds dataset size"):
        tt.fit(fm_batch(), epochs=1, batch_size=10_000)


def test_trainers_default_to_cuda():
    """Without CUDA an entry point raises unless the caller asks for the
    CPU; the caller's params are never updated in place."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    p = tparams(init_params())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CTRTrainer(p, tfm.logits, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseTableCTRTrainer(p, tfm.logits, TrainConfig(),
                              sparse_tables=TABLES)
    before = {k: v.clone() for k, v in p.items()}
    tt = SparseTableCTRTrainer(p, tfm.logits, TrainConfig(),
                               sparse_tables=TABLES, device="cpu")
    tt.train_step(fm_batch())
    for k in p:
        assert torch.equal(p[k], before[k])
    tt.reset(p)
    assert torch.equal(tt.params["v"], p["v"])
    assert not tt.opt_state["accum"]["v"].any()


def test_traced_step_spans_and_stall_watch_from_env(monkeypatch):
    """With tracing sampled, the step runs under the trainer/* and
    sparse_tables/* spans; LIGHTCTR_STALL=1 arms the stall watchdog,
    which counts completed steps and pauses after fit."""
    from lightctr_tpu_torch.obs import trace

    monkeypatch.setenv("LIGHTCTR_STALL", "1")
    tt = SparseTableCTRTrainer(tparams(init_params()), tfm.logits,
                               TrainConfig(), sparse_tables=TABLES,
                               device="cpu")
    try:
        assert tt.stepwatch is not None
        trace.reset()
        with trace.override_rate(1.0):
            loss = tt.train_step(fm_batch(11))
        names = {r["name"] for r in trace.finished()}
        assert {"trainer/step", "trainer/input", "trainer/exec",
                "sparse_tables/dedup_gather",
                "sparse_tables/apply"} <= names, names
        assert loss.dim() == 0
        hist = tt.fit(fm_batch(12, n=64), epochs=4, batch_size=32,
                      eval_arrays=fm_batch(13), eval_every=2, verbose=True)
        assert tt.stepwatch._steps == 1 + 4 * 2
        assert [e for e, _ in hist["eval"]] == [1, 3]
        assert set(hist["eval"][0][1]) == {"logloss", "accuracy", "auc"}
        assert hist["wall_time_s"] > 0 and len(hist["loss"]) == 4
    finally:
        tt.stepwatch.close()
        trace.reset()
