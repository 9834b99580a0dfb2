"""The port's DL zoo against the JAX package on the CPU: the layers
(``nn/pool``, ``nn/conv``, ``nn/lstm``, ``nn/attention``, ``nn/sample``),
the CNN, RNN and VAE, and ``ClassifierTrainer`` / ``VAETrainer``, each from
the JAX init carried across (``models._common.params_from_numpy``) on
inputs made from one numpy seed; mirrors tests/test_dl_models.py.

Tolerances:
  - pool, conv, the LSTM, the sampling layer and their gradients: rtol
    1e-5 (LAYER_TOL);
  - tanh paths (the CNN, the RNN, attention): rtol 1e-4 / atol 2e-4
    (TANH_TOL), and their training trajectories rtol 1e-4 / atol 2e-5
    (TRAJ_TOL): XLA's CPU tanh and torch's differ in the last places
    (ROADMAP.md §C); the params after training rtol 1e-2 / atol 5e-4
    (PARAM_TOL, the bound tests/test_dl_models.py holds its scan and
    step loops to: Adagrad's rsqrt of small accumulators amplifies ulps);
  - the VAE's loss and gradient given JAX's noise: rtol 1e-5, and its
    trajectory with JAX's noise fed step by step: TRAJ_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JTrainConfig
from lightctr_tpu.models import cnn as jcnn
from lightctr_tpu.models import rnn as jrnn
from lightctr_tpu.models import vae as jvae
from lightctr_tpu.models.dl_trainer import ClassifierTrainer as JTrainer
from lightctr_tpu.nn import attention as jattention
from lightctr_tpu.nn import conv as jconv
from lightctr_tpu.nn import lstm as jlstm
from lightctr_tpu.nn import pool as jpool
from lightctr_tpu.nn import sample as jsample
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import cnn as tcnn
from lightctr_tpu_torch.models import rnn as trnn
from lightctr_tpu_torch.models import vae as tvae
from lightctr_tpu_torch.models.dl_trainer import ClassifierTrainer
from lightctr_tpu_torch.nn import attention as tattention
from lightctr_tpu_torch.nn import conv as tconv
from lightctr_tpu_torch.nn import lstm as tlstm
from lightctr_tpu_torch.nn import pool as tpool
from lightctr_tpu_torch.nn import sample as tsample
from lightctr_tpu_torch.optim.updaters import tree_leaves

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
TANH_TOL = dict(rtol=1e-4, atol=2e-4)
TRAJ_TOL = dict(rtol=1e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-2, atol=5e-4)


def carry(tree):
    return _common.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _grads(fn, params):
    leaves = jax.tree_util.tree_map(lambda x: x.detach().requires_grad_(),
                                    params, is_leaf=torch.is_tensor)
    fn(leaves).backward()
    return jax.tree_util.tree_map(lambda x: x.grad, leaves,
                                  is_leaf=torch.is_tensor)


def _assert_tree_close(got, want, **tol):
    g = jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# -- layers -----------------------------------------------------------------


def test_maxpool_routes_gradient_to_argmax():
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]]).reshape(1, 2, 2, 1)
    x.requires_grad_()
    tpool.max_pool(x, 2).sum().backward()
    np.testing.assert_array_equal(x.grad.reshape(2, 2).numpy(),
                                  [[0, 0], [0, 1]])


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2)])
def test_maxpool_matches_jax(rng, window, stride):
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    want = jpool.max_pool(jnp.asarray(x), window, stride)
    wg = jax.grad(lambda v: jnp.sum(jpool.max_pool(v, window, stride) ** 2))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = tpool.max_pool(xt, window, stride)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wg), **LAYER_TOL)


def test_conv_matches_scipy_oracle(rng):
    from scipy import signal

    x = rng.normal(size=(1, 8, 8, 1)).astype(np.float32)
    params = tconv.init(torch.Generator().manual_seed(0), 3, 1, 1)
    y = tconv.apply(params, _t(x)).numpy()
    w = params["w"][:, :, 0, 0].numpy()
    want = signal.correlate2d(x[0, :, :, 0], w, mode="valid") + float(
        params["b"][0])
    np.testing.assert_allclose(y[0, :, :, 0], want, rtol=1e-3, atol=1e-5)


def test_conv_stride_padding_shapes():
    params = tconv.init(torch.Generator().manual_seed(0), 5, 1, 6)
    x = torch.zeros((2, 28, 28, 1))
    assert tconv.apply(params, x, stride=2).shape == (2, 12, 12, 6)
    assert tconv.apply(params, x, stride=1, padding=2).shape == (2, 28, 28, 6)


@pytest.mark.parametrize("stride,padding,masked", [(1, 0, False),
                                                   (2, 1, False),
                                                   (1, 0, True)])
def test_conv_and_its_gradients_match_jax(rng, stride, padding, masked):
    cin, cout = (6, 16) if masked else (3, 5)
    jp = jconv.init(jax.random.PRNGKey(1), 3, cin, cout)
    jp = dict(jp, b=jnp.asarray(rng.normal(size=cout).astype(np.float32)))
    x = rng.normal(size=(2, 9, 9, cin)).astype(np.float32)
    mask = jconv.LENET_CONNECTION_6x16 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)

    def jloss(p, v):
        return jnp.sum(jnp.tanh(jconv.apply(p, v, stride, padding, jmask)))

    want = jconv.apply(jp, jnp.asarray(x), stride, padding, jmask)
    wgp, wgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = carry(jp)
    got = tconv.apply(tp, _t(x), stride, padding, tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    xt = _t(x).requires_grad_()
    gp = _grads(lambda p: torch.sum(torch.tanh(tconv.apply(
        p, xt, stride, padding, tmask))), tp)
    np.testing.assert_allclose(gp["w"].numpy(), np.asarray(wgp["w"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gp["b"].numpy(), np.asarray(wgp["b"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgx),
                               rtol=1e-4, atol=1e-5)
    if masked:
        assert np.all(gp["w"].numpy()[:, :, mask == 0] == 0.0)


def test_lenet_mask_blocks_weights_and_grads():
    params = tcnn.init(torch.Generator().manual_seed(0))
    feats = torch.from_numpy(
        np.random.default_rng(0).random((4, 784)).astype(np.float32))
    labels = torch.tensor([1, 2, 3, 4])
    g = _grads(lambda p: torch.sum(tcnn.logits(p, feats) * torch.nn.functional
                                   .one_hot(labels, 10)), params)
    gw = g["conv2"]["w"].numpy()
    assert np.all(gw[:, :, tconv.LENET_CONNECTION_6x16 == 0] == 0.0)
    assert np.any(gw != 0)


def test_lstm_matches_jax_and_its_own_cell_loop(rng):
    jp = jlstm.init(jax.random.PRNGKey(0), 5, 7)
    jp = dict(jp, bias=jnp.asarray(rng.normal(size=28).astype(np.float32)))
    xs = rng.normal(size=(3, 11, 5)).astype(np.float32)
    want = jlstm.apply_seq(jp, jnp.asarray(xs))
    wg = jax.grad(lambda p: jnp.sum(jlstm.apply_seq(p, jnp.asarray(xs)) ** 2))(
        jp)
    tp = carry(jp)
    hs = tlstm.apply_seq(tp, _t(xs))
    assert hs.shape == (3, 11, 7)
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(want),
                               **LAYER_TOL)
    h, c = torch.zeros((3, 7)), torch.zeros((3, 7))
    for t in range(11):
        (h, c), _ = tlstm.cell(tp, _t(xs[:, t]), (h, c))
    np.testing.assert_allclose(hs[:, -1].numpy(), h.numpy(), rtol=1e-5,
                               atol=1e-6)
    g = _grads(lambda p: torch.sum(tlstm.apply_seq(p, _t(xs)) ** 2), tp)
    _assert_tree_close(g, wg, rtol=1e-4, atol=1e-5)


def test_attention_matches_jax(rng):
    jp = jattention.init(jax.random.PRNGKey(2), 6, 4)
    hs = rng.normal(size=(3, 5, 6)).astype(np.float32)
    want = jattention.apply(jp, jnp.asarray(hs))
    wg = jax.grad(lambda p: jnp.sum(jattention.apply(p, jnp.asarray(hs)) ** 2))(
        jp)
    tp = carry(jp)
    np.testing.assert_allclose(tattention.apply(tp, _t(hs)).numpy(),
                               np.asarray(want), **TANH_TOL)
    g = _grads(lambda p: torch.sum(tattention.apply(p, _t(hs)) ** 2), tp)
    _assert_tree_close(g, wg, **TANH_TOL)


def test_sample_layer_matches_jax(rng):
    v = rng.normal(size=(4, 6)).astype(np.float32)
    jmu, jls = jsample.split(jnp.asarray(v))
    key = jax.random.PRNGKey(3)
    want = jsample.sample(key, jmu, jls)
    eps = jax.random.normal(key, jmu.shape, jmu.dtype)
    mu, ls = tsample.split(_t(v))
    np.testing.assert_array_equal(mu.numpy(), np.asarray(jmu))
    np.testing.assert_allclose(tsample.reparameterize(mu, ls, _t(eps)).numpy(),
                               np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(tsample.kl_divergence(mu, ls).numpy(),
                               np.asarray(jsample.kl_divergence(jmu, jls)),
                               **LAYER_TOL)
    z = tsample.sample(torch.Generator().manual_seed(0), mu, ls)
    assert z.shape == mu.shape and torch.isfinite(z).all()


# -- models -----------------------------------------------------------------


@pytest.mark.parametrize("model", ["cnn", "rnn"])
def test_logits_and_gradients_match_jax(rng, model):
    jmod, tmod = (jcnn, tcnn) if model == "cnn" else (jrnn, trnn)
    jp = jmod.init(jax.random.PRNGKey(0), hidden=16, n_classes=10)
    feats = rng.random((6, 784)).astype(np.float32)
    onehot = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    want = jmod.logits(jp, jnp.asarray(feats))
    wg = jax.grad(lambda p: jnp.sum(jmod.logits(p, jnp.asarray(feats))
                                    * onehot))(jp)
    tp = carry(jp)
    np.testing.assert_allclose(tmod.logits(tp, _t(feats)).detach().numpy(),
                               np.asarray(want), **TANH_TOL)
    g = _grads(lambda p: torch.sum(tmod.logits(p, _t(feats)) * _t(onehot)),
               tp)
    _assert_tree_close(g, wg, **TANH_TOL)


def _digits(rng, n=60):
    templates = rng.random((4, 784)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    feats = np.clip(templates[labels] + 0.15 * rng.standard_normal(
        (n, 784)).astype(np.float32), 0, 1)
    return feats, labels


@pytest.mark.parametrize("model,loss", [("cnn", "softmax_ce"),
                                        ("cnn", "square"),
                                        ("rnn", "softmax_ce")])
def test_classifier_trainer_matches_jax(rng, model, loss):
    """Three epochs of minibatches of 10 (the numpy-seeded order) under the
    default optimizer (clip 15, Adagrad 0.1): the loss per epoch, the
    evaluation and the params."""
    jmod, tmod = (jcnn, tcnn) if model == "cnn" else (jrnn, trnn)
    feats, labels = _digits(rng)
    jp = jmod.init(jax.random.PRNGKey(0), hidden=16, n_classes=4)
    jt = JTrainer(jp, jmod.logits, JTrainConfig(learning_rate=0.1,
                                                minibatch_size=10),
                  n_classes=4, loss=loss)
    tt = ClassifierTrainer(carry(jp), tmod.logits,
                           TrainConfig(learning_rate=0.1, minibatch_size=10),
                           n_classes=4, loss=loss, device="cpu")
    jh, th = jt.fit(feats, labels, epochs=3), tt.fit(feats, labels, epochs=3)
    np.testing.assert_allclose(th["loss"], jh["loss"], **TRAJ_TOL)
    ej, et = jt.evaluate(feats, labels), tt.evaluate(feats, labels)
    np.testing.assert_allclose(et["loss"], ej["loss"], **TRAJ_TOL)
    np.testing.assert_allclose(et["accuracy"], ej["accuracy"], rtol=1e-6)
    eb = tt.evaluate(feats, labels, batch_size=7)
    np.testing.assert_allclose(eb["loss"], et["loss"], rtol=1e-5)
    np.testing.assert_allclose(eb["accuracy"], et["accuracy"], rtol=1e-6)
    np.testing.assert_array_equal(tt.predict(feats), jt.predict(feats))
    # Adagrad's rsqrt of small early accumulators amplifies the tanh ulps:
    # the bound tests/test_dl_models.py holds its scan and loop steps to
    _assert_tree_close(tt.params, jt.params, **PARAM_TOL)


def test_steps_loop_matches_steps_scan_and_jax(rng):
    feats = rng.normal(size=(64, 784)).astype(np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    idx = rng.integers(0, 64, size=(8, 16)).astype(np.int32)
    jp = jcnn.init(jax.random.PRNGKey(0), hidden=32, n_classes=10)
    cfg = TrainConfig(learning_rate=0.1)
    scan = ClassifierTrainer(carry(jp), tcnn.logits, cfg, 10, device="cpu")
    loop = ClassifierTrainer(carry(jp), tcnn.logits, cfg, 10, device="cpu")
    l_scan = scan.fit_steps_scan(feats, labels, 8, 16, idx=idx)
    l_loop = loop.fit_steps_loop(feats, labels, 8, 16, idx=idx)
    np.testing.assert_array_equal(l_scan, l_loop)
    for a, b in zip(tree_leaves(scan.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)
    jt = JTrainer(jp, jcnn.logits, JTrainConfig(learning_rate=0.1), 10)
    np.testing.assert_allclose(
        l_loop, jt.fit_steps_loop(feats, labels, 8, 16, idx=idx), **TRAJ_TOL)
    before = [x.clone() for x in tree_leaves(loop.params)]
    loop.warmup_steps_scan(feats, labels, 2, 16)
    for a, b in zip(tree_leaves(loop.params), before):
        assert torch.equal(a, b)


def test_square_loss_mode_trains(rng):
    feats = rng.random((64, 784)).astype(np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    params = tcnn.init(torch.Generator().manual_seed(0), hidden=32)
    tr = ClassifierTrainer(params, tcnn.logits,
                           TrainConfig(learning_rate=0.1, minibatch_size=16),
                           n_classes=10, loss="square", device="cpu")
    assert np.isfinite(tr.fit(feats, labels, epochs=3)["loss"][-1])


@pytest.fixture(scope="module")
def synth_digits(tmp_path_factory):
    """300 rows of data/synth.py's templated 28x28 digits, 10 classes."""
    from lightctr_tpu_torch.data import load_dense_csv, synth

    path = str(tmp_path_factory.mktemp("dl") / "digits.csv")
    ds = load_dense_csv(synth.write_synthetic_dense_csv(path, 300, seed=0))
    return ds.features, ds.labels


@pytest.mark.parametrize("model", ["cnn", "rnn"])
def test_cnn_and_rnn_learn_templated_digits(synth_digits, model):
    """tests/test_dl_models.py's convergence cases (CNN under rmsprop 0.01,
    RNN at the reference's lr 0.03 config) on templated digits (the
    reference data is not in the repo)."""
    from lightctr_tpu_torch.optim import rmsprop

    feats, labels = synth_digits
    mod, opt, floor = {"cnn": (tcnn, rmsprop(0.01), 0.8),
                       "rnn": (trnn, None, 0.4)}[model]
    params = mod.init(torch.Generator().manual_seed(0), hidden=64)
    tr = ClassifierTrainer(params, mod.logits,
                           TrainConfig(learning_rate=0.03, minibatch_size=10),
                           n_classes=10, optimizer=opt, device="cpu")
    hist = tr.fit(feats, labels, epochs=4)
    assert hist["loss"][-1] < hist["loss"][0]
    assert tr.evaluate(feats, labels)["accuracy"] > floor


def test_opt_state_carries_the_chain_state(rng):
    jp = jcnn.init(jax.random.PRNGKey(0), hidden=8)
    jt = JTrainer(jp, jcnn.logits, JTrainConfig(), 10)
    feats, labels = rng.random((20, 784)).astype(np.float32), \
        rng.integers(0, 10, 20).astype(np.int32)
    jt.fit(feats, labels, epochs=1, batch_size=10)
    state = _common.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.opt_state), "cpu")
    tt = ClassifierTrainer(carry(jt.params), tcnn.logits, TrainConfig(), 10,
                           device="cpu")
    assert type(state) is tuple and len(state) == 2
    assert type(state[0]).__name__ == "EmptyState"
    assert set(state[1].accum) == set(tt.opt_state[1].accum)
    tt.opt_state = state
    jt.fit(feats, labels, epochs=1, batch_size=10)
    tt.fit(feats, labels, epochs=1, batch_size=10)
    _assert_tree_close(tt.params, jt.params, **PARAM_TOL)


# -- VAE --------------------------------------------------------------------


def test_vae_loss_and_gradient_match_jax_given_its_noise(rng):
    jp = jvae.init(jax.random.PRNGKey(0), 30, hidden=12, gauss_cnt=4)
    x = rng.random((5, 30)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = jax.random.normal(key, (5, 4), jnp.float32)
    want, wg = jax.value_and_grad(jvae.loss_fn)(jp, jnp.asarray(x), key, 0.1)
    tp = carry(jp)
    got = tvae.loss_fn(tp, _t(x), _t(eps), 0.1)
    np.testing.assert_allclose(float(got), float(want), **LAYER_TOL)
    g = _grads(lambda p: tvae.loss_fn(p, _t(x), _t(eps), 0.1), tp)
    _assert_tree_close(g, wg, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tvae.encode(tp, _t(x)).detach().numpy(),
                               np.asarray(jvae.encode(jp, jnp.asarray(x))),
                               **LAYER_TOL)


def test_vae_trainer_matches_jax_fed_its_noise(rng, monkeypatch):
    """The JAX trainer splits one key a step; the port's trainer draws
    ``_noise`` from its generator.  Fed JAX's per-step noise, the two
    trajectories agree."""
    x = rng.random((40, 30)).astype(np.float32)
    jp = jvae.init(jax.random.PRNGKey(0), 30, hidden=12, gauss_cnt=4)
    cfg = dict(learning_rate=0.1, minibatch_size=10, seed=3)
    jt = jvae.VAETrainer(jp, JTrainConfig(**cfg))
    tt = tvae.VAETrainer(carry(jp), TrainConfig(**cfg), device="cpu")
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(3 * 4):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (10, 4), jnp.float32)))
    monkeypatch.setattr(tt, "_noise", lambda rows: _t(draws.pop(0)))
    jh, th = jt.fit(x, epochs=3), tt.fit(x, epochs=3)
    assert not draws
    np.testing.assert_allclose(th["loss"], jh["loss"], **TRAJ_TOL)
    _assert_tree_close(tt.params, jt.params, rtol=1e-3, atol=1e-5)


def test_vae_reconstruction_improves(synth_digits):
    feats = synth_digits[0][:100]
    params = tvae.init(torch.Generator().manual_seed(0), 784)
    tr = tvae.VAETrainer(params, TrainConfig(learning_rate=0.1,
                                             minibatch_size=10), device="cpu")
    hist = tr.fit(feats, epochs=10)
    # tests/test_dl_models.py asks 0.8 of MNIST; the templated rows'
    # per-pixel noise is a higher floor (the same port against JAX run is
    # held step by step above)
    assert hist["loss"][-1] < hist["loss"][0] * 0.85
    assert tvae.encode(tr.params, _t(feats[:5])).shape == (5, 20)
    assert tr.reconstruct(feats[:3]).shape == (3, 784)


def test_dl_trainers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tcnn.init(torch.Generator().manual_seed(0), hidden=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClassifierTrainer(params, tcnn.logits, TrainConfig(), 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvae.VAETrainer(tvae.init(torch.Generator(), 8), TrainConfig())
