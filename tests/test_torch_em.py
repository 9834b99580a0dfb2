"""The port's EM models against the JAX package on the CPU: the shared EM
template (``models/em.py``, a copy), the GMM (``models/gmm.py``) and its
text codec (``models/export.save_gmm_text`` / ``load_gmm_text``), and PLSA
(``models/plsa.py``); mirrors tests/test_gbm_em.py's GMM and PLSA cases,
tests/test_stacking.py's k-means++ case and tests/test_rng_em.py's EM
template case.

The inits draw from a ``torch.Generator`` where the JAX functions take a
key, so each parity case starts both packages from the JAX init carried
across.  Tolerances: each E/M step and the log-likelihood within rtol
1e-5 (EM_TOL); a whole fit's log-likelihood history within rtol 1e-5 and
its params within rtol 1e-4 / atol 1e-5, on data whose stop is not near
``tol``'s edge (both stop at the same epoch)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.models import em as jem
from lightctr_tpu.models import export as jexport
from lightctr_tpu.models import gmm as jgmm
from lightctr_tpu.models import plsa as jplsa
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import em as tem
from lightctr_tpu_torch.models import export as texport
from lightctr_tpu_torch.models import gmm as tgmm
from lightctr_tpu_torch.models import plsa as tplsa

EM_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)


def carry(params):
    return _common.params_from_numpy(
        type(params)(*(np.asarray(a) for a in params)), "cpu")


def _assert_params_close(got, want, **tol):
    assert type(got).__name__ == type(want).__name__
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def _blobs(rng, centers, n=100, scale=0.5):
    centers = np.asarray(centers, np.float32)
    return np.concatenate([rng.normal(size=(n, centers.shape[1])).astype(
        np.float32) * scale + c for c in centers])


def test_fit_em_is_a_copy_and_converges_and_stops():
    assert inspect.getsource(tem.fit_em) == inspect.getsource(jem.fit_em)

    def step(p, d):
        return p * 0.5, -1.0 - p

    p, hist = tem.fit_em(8.0, step, None, epochs=100, tol=1e-2)
    assert len(hist) < 100
    assert hist[0] < hist[-1] <= -1.0
    assert (p, hist) == jem.fit_em(8.0, step, None, epochs=100, tol=1e-2)


def test_gmm_steps_match_jax(rng):
    x = _blobs(rng, [[-3.0, 0.0, 1.0], [3.0, 0.0, -1.0], [0.0, 4.0, 0.0]],
               n=40)
    jp = jgmm.init_from_data(jax.random.PRNGKey(0), 3, x)
    tp = carry(jp)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tgmm.log_pdf(tp, xt).numpy(),
                               np.asarray(jgmm.log_pdf(jp, jnp.asarray(x))),
                               **EM_TOL)
    jr, jl = jgmm.e_step(jp, jnp.asarray(x))
    tr, tl = tgmm.e_step(tp, xt)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **EM_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **EM_TOL)
    _assert_params_close(tgmm.m_step(tp, xt, torch.from_numpy(np.asarray(jr))),
                         jgmm.m_step(jp, jnp.asarray(x), jr), **EM_TOL)


def test_gmm_fit_matches_jax_and_recovers_clusters(rng):
    centers = [[-3.0, 0.0], [3.0, 0.0], [0.0, 4.0]]
    x = _blobs(rng, centers)
    jp0 = jgmm.init_from_data(jax.random.PRNGKey(0), 3, x)
    jp, jh = jgmm.fit(jp0, x, epochs=60)
    tp, th = tgmm.fit(carry(jp0), x, epochs=60, device="cpu")
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, **EM_TOL)
    _assert_params_close(tp, jp, **FIT_TOL)
    labels = tgmm.predict(tp, x)
    np.testing.assert_array_equal(labels, jgmm.predict(jp, x))
    assert th[-1] > th[0]
    purities = [np.bincount(labels[i * 100:(i + 1) * 100], minlength=3).max()
                / 100 for i in range(3)]
    assert min(purities) > 0.9, purities
    for c in centers:
        assert np.min(np.linalg.norm(tp.mu.numpy() - c, axis=1)) < 0.5


def test_gmm_sigma_floor_and_reference_init():
    x = np.zeros((50, 2), np.float32)
    params = tgmm.init(torch.Generator().manual_seed(0), 2, 2, device="cpu")
    assert float(params.sigma.min()) == 5.0
    assert params.mu.abs().max() <= 0.5
    params, _ = tgmm.fit(params, x, epochs=5, device="cpu")
    assert float(params.sigma.min()) >= tgmm.SIGMA_FLOOR - 1e-6


def test_kmeanspp_seeding_separates_blobs(rng):
    x = _blobs(rng, [[-6.0, 0.0], [6.0, 0.0], [0.0, 8.0]], n=80, scale=0.4)
    ok = 0
    for seed in range(5):
        params = tgmm.init_from_data(torch.Generator().manual_seed(seed), 3,
                                     x, device="cpu")
        assert params.mu.shape == (3, 2) and params.sigma.shape == (3, 2)
        params, _ = tgmm.fit(params, x, epochs=40, device="cpu")
        ok += int(np.bincount(tgmm.predict(params, x), minlength=3).min()
                  > 60)
    assert ok >= 4, f"only {ok}/5 seeds separated the blobs"


def test_init_from_data_falls_back_to_uniform_on_constant_rows():
    x = np.ones((6, 3), np.float32)
    params = tgmm.init_from_data(torch.Generator().manual_seed(1), 4, x,
                                 device="cpu")
    assert torch.isfinite(params.mu).all()
    np.testing.assert_allclose(params.sigma.numpy(), tgmm.SIGMA_FLOOR)


def test_gmm_text_codec_round_trips_across_packages(tmp_path, rng):
    x = _blobs(rng, [[0.0, 1.0], [5.0, 5.0]], n=30)
    tp, _ = tgmm.fit(tgmm.init_from_data(torch.Generator().manual_seed(0), 2,
                                         x, device="cpu"), x, epochs=10,
                     device="cpu")
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    texport.save_gmm_text(str(a), tp)
    jexport.save_gmm_text(str(b), jgmm.GMMParams(*(jnp.asarray(t.numpy())
                                                   for t in tp)))
    assert a.read_text() == b.read_text()
    back = texport.load_gmm_text(str(b))
    assert isinstance(back, tgmm.GMMParams)
    _assert_params_close(back, jexport.load_gmm_text(str(a)), rtol=0, atol=0)
    _assert_params_close(back, tp, rtol=1e-5, atol=1e-6)


def _topic_counts(rng, d=40, w=20):
    counts = np.zeros((d, w), np.float32)
    for i in range(d):
        half = slice(0, w // 2) if i % 2 == 0 else slice(w // 2, w)
        counts[i, half] = rng.integers(5, 20, size=w // 2)
    return counts


def test_plsa_step_and_fit_match_jax(rng):
    counts = _topic_counts(rng)
    jp0 = jplsa.init(jax.random.PRNGKey(0), 40, 2, 20)
    jp1, jll = jplsa.em_step(jp0, jnp.asarray(counts))
    tp1, tll = tplsa.em_step(carry(jp0), torch.from_numpy(counts))
    _assert_params_close(tp1, jp1, **EM_TOL)
    np.testing.assert_allclose(float(tll), float(jll), **EM_TOL)
    jp, jh = jplsa.fit(jp0, counts, epochs=30)
    tp, th = tplsa.fit(carry(jp0), counts, epochs=30, device="cpu")
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, **EM_TOL)
    _assert_params_close(tp, jp, **FIT_TOL)
    vocab = [f"w{i}" for i in range(20)]
    assert tplsa.topic_keywords(tp, vocab, 5) == jplsa.topic_keywords(
        jp, vocab, 5)


def test_plsa_recovers_topics(rng):
    counts = _topic_counts(rng)
    params = tplsa.init(torch.Generator().manual_seed(0), 40, 2, 20,
                        device="cpu")
    np.testing.assert_allclose(params.p_word_topic.sum(1).numpy(), 1.0,
                               rtol=1e-6)
    params, hist = tplsa.fit(params, counts, epochs=100, device="cpu")
    assert hist[-1] > hist[0]
    frac0 = params.p_word_topic[:, :10].sum(dim=1).numpy()
    assert frac0.max() > 0.95 and frac0.min() < 0.05, frac0
    kw = tplsa.topic_keywords(params, [f"w{i}" for i in range(20)], top_k=5)
    assert len(kw) == 2 and len(kw[0]) == 5


@pytest.mark.parametrize("call", ["gmm_init", "gmm_data", "gmm_fit",
                                  "plsa_init", "plsa_fit"])
def test_em_entry_points_default_to_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator()
    x = np.zeros((4, 2), np.float32)
    fn = {"gmm_init": lambda: tgmm.init(g, 2, 2),
          "gmm_data": lambda: tgmm.init_from_data(g, 2, x),
          "gmm_fit": lambda: tgmm.fit(tgmm.init(g, 2, 2, device="cpu"), x),
          "plsa_init": lambda: tplsa.init(g, 4, 2, 2),
          "plsa_fit": lambda: tplsa.fit(tplsa.init(g, 4, 2, 2, device="cpu"),
                                        x)}[call]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
