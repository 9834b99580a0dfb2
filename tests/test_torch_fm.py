"""The port's FM forward and sigmoid (lightctr_tpu_torch/models/fm.py,
ops/activations.py) against the JAX package's on the same numpy inputs.
Tolerance 1e-5 (atol and rtol) in fp32: only the summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.models import fm as jfm
from lightctr_tpu.ops import activations as jact
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.ops import activations as tact

F, K = 256, 8
TOL = dict(atol=1e-5, rtol=1e-5)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0.0, 0.1, F).astype(np.float32),
            "v": (rng.standard_normal((F, K)) / np.sqrt(K)).astype(np.float32)}


def _batch(seed, b, p):
    rng = np.random.default_rng(seed + 7)
    return {"fids": rng.integers(0, F, (b, p)).astype(np.int32),
            "vals": rng.random((b, p)).astype(np.float32),
            "mask": (rng.random((b, p)) > 0.25).astype(np.float32)}


def _both(np_params, np_batch):
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tp = tfm.params_from_numpy(np_params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return jp, jb, tp, tb


@pytest.mark.parametrize("b,p", [(1, 1), (16, 5), (64, 39)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fm_logits_match_jax(seed, b, p):
    jp, jb, tp, tb = _both(_params(seed), _batch(seed, b, p))
    want = np.asarray(jfm.logits(jp, jb))
    got = tfm.logits(tp, tb).numpy()
    assert got.dtype == np.float32 and got.shape == (b,)
    np.testing.assert_allclose(got, want, **TOL)


def test_fm_logits_with_l2_match_jax():
    jp, jb, tp, tb = _both(_params(3), _batch(3, 32, 7))
    jz, jl2 = jfm.logits_with_l2(jp, jb)
    tz, tl2 = tfm.logits_with_l2(tp, tb)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(float(tl2), float(jl2), **TOL)


def test_params_from_numpy_carries_values_exactly():
    np_params = _params(4)
    tp = tfm.params_from_numpy(np_params, torch.device("cpu"))
    for k, v in np_params.items():
        assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
        np.testing.assert_array_equal(tp[k].numpy(), v)


def test_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = tfm.init(gen, 4096, K, device="cpu")
    assert p["w"].shape == (4096,) and not p["w"].any()
    assert p["v"].shape == (4096, K)
    # V ~ N(0, 1/k) as in the JAX package (fm_algo_abst.h:53-67)
    assert abs(float(p["v"].std()) - 1.0 / np.sqrt(K)) < 0.01
    again = tfm.init(torch.Generator().manual_seed(0), 4096, K)
    assert torch.equal(again["v"], p["v"])


def test_sigmoid_matches_jax_including_the_clamp():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-16.0, 16.0, -16.0001, 16.0001, 0.0]]).astype(
                            np.float32)
    want = np.asarray(jact.sigmoid(jnp.asarray(x)))
    got = tact.sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    assert got.min() == np.float32(tact.EPS)
    assert got.max() == np.float32(1.0 - tact.EPS)
