"""The port's small ops against the JAX package on the CPU, on inputs from
a numpy seed: activations (``binary_sigmoid``'s straight-through gradient
against ``jax.grad``), ``softmax_cross_entropy``, ``precision_recall_f1``,
the significance helpers, the rng helpers' contracts
(``tests/test_rng_em.py``'s cases) and the precision policy.  Tolerances
are stated per test."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.core import precision as jprecision
from lightctr_tpu.ops import activations as jact
from lightctr_tpu.ops import losses as jlosses
from lightctr_tpu.ops import metrics as jmetrics
from lightctr_tpu.ops import significance as jsig
from lightctr_tpu_torch.core import precision as tprecision
from lightctr_tpu_torch.core import rng as trng
from lightctr_tpu_torch.ops import activations as tact
from lightctr_tpu_torch.ops import losses as tlosses
from lightctr_tpu_torch.ops import metrics as tmetrics
from lightctr_tpu_torch.ops import significance as tsig

RTOL, ATOL = 1e-6, 1e-7


def normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


#: XLA's CPU tanh is a rational approximation, and softplus goes through
#: it: tests/test_activations.py holds both to numpy at these tolerances
LOOSE = {"tanh": (1e-4, 2e-4), "softplus": (1e-4, 2e-4)}


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_and_its_gradient_match_jax(name):
    """Forward and the gradient of sum(f(x) * c), c from the seed, for every
    registered activation: rtol 1e-6 / atol 1e-7, tanh and softplus at
    the JAX tests' own 1e-4 / 2e-4 (x spans the sigmoid's +-16 clamp;
    softmax on [8, 10] rows).  Softmax's gradient is compared at logits of
    scale 2, where no output reaches its [1e-7, 1 - 1e-7] clamp: on the
    clamp value itself ``jnp.clip`` (a min and a max) gives half the
    gradient and ``torch.clamp`` all of it, a convention at a tie."""
    rtol, atol = LOOSE.get(name, (RTOL, ATOL))
    shape = (8, 10) if name == "softmax" else (64,)
    x = normal(1, shape, 8.0)
    x.reshape(-1)[:2] = [-20.0, 20.0]
    jf, tf = jact.get(name), tact.get(name)
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))),
                               rtol=rtol, atol=atol)
    if name == "softmax":
        x = normal(1, shape, 2.0)
    c = normal(9, shape)
    want = jax.grad(lambda v: jnp.sum(jf(v) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tf(xt) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_binary_sigmoid_is_a_straight_through_estimator():
    """sign(x) * mean|x| forward; the gradient passes through unchanged
    (activations.h:54-59), exactly as ``jax.grad`` of the JAX custom_vjp."""
    x = normal(2, (16,))
    got = tact.binary_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.sign(x) * np.abs(x).mean(), rtol=1e-6)
    xt = torch.from_numpy(x).requires_grad_()
    g = normal(3, (16,))
    tact.binary_sigmoid(xt).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jact.binary_sigmoid, jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), g)


def test_unknown_activation_lists_the_names():
    with pytest.raises(ValueError, match="unknown activation.*relu"):
        tact.get("swish")


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_softmax_cross_entropy_and_gradient_match_jax(temperature,
                                                      reduction):
    """Value and gradient w.r.t. the logits, rtol 1e-6 / atol 1e-6."""
    z = normal(4, (8, 5), 3.0)
    onehot = np.eye(5, dtype=np.float32)[
        np.random.default_rng(5).integers(0, 5, size=8)]

    def jf(v):
        return jlosses.softmax_cross_entropy(v, jnp.asarray(onehot),
                                             temperature, reduction)

    zt = torch.from_numpy(z).requires_grad_()
    got = tlosses.softmax_cross_entropy(zt, torch.from_numpy(onehot),
                                        temperature, reduction)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jf(jnp.asarray(z))),
                               rtol=RTOL, atol=1e-6)
    got.sum().backward()
    want = jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(z))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-6)
    assert tlosses.get("softmax_ce") is tlosses.softmax_cross_entropy


@pytest.mark.parametrize("case", ["mixed", "no_positive_prediction",
                                  "no_positive_label", "all_right"])
def test_precision_recall_f1_matches_jax(case):
    """P, R and F1 equal the JAX function's, zero denominators included."""
    rng = np.random.default_rng(6)
    pred = (rng.random(50) > 0.5).astype(np.int32)
    true = (rng.random(50) > 0.4).astype(np.int32)
    if case == "no_positive_prediction":
        pred[:] = 0
    if case == "no_positive_label":
        true[:] = 0
    if case == "all_right":
        pred = true.copy()
    got = tmetrics.precision_recall_f1(torch.from_numpy(pred),
                                       torch.from_numpy(true))
    want = jmetrics.precision_recall_f1(jnp.asarray(pred), jnp.asarray(true))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    p, r, f1 = tmetrics.precision_recall_f1(
        torch.tensor([1, 1, 0, 0, 1]), torch.tensor([1, 0, 0, 1, 1]))
    assert float(p) == pytest.approx(2 / 3) and float(f1) == pytest.approx(
        2 / 3) and float(r) == pytest.approx(2 / 3)


def test_significance_matches_jax():
    """erf and normal_cdf rtol 1e-6 / atol 1e-7; z_value within 1e-6."""
    x = normal(7, (100,), 3.0)
    np.testing.assert_allclose(tsig.erf(torch.from_numpy(x)).numpy(),
                               np.asarray(jsig.erf(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tsig.normal_cdf(torch.from_numpy(x), 0.5, 2.0).numpy(),
        np.asarray(jsig.normal_cdf(jnp.asarray(x), 0.5, 2.0)),
        rtol=RTOL, atol=ATOL)
    for c in (0.9, 0.95, 0.99):
        assert tsig.z_value(c) == pytest.approx(jsig.z_value(c), abs=1e-6)


# -- core/rng: the contracts of tests/test_rng_em.py ------------------------


def test_shuffle_select_k():
    """k distinct indices in range, the same for the same seed; k > n
    refused."""
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    idx = trng.shuffle_select_k(g(), 100, 10).numpy()
    assert len(idx) == 10 and len(set(idx.tolist())) == 10
    assert idx.min() >= 0 and idx.max() < 100
    np.testing.assert_array_equal(idx, trng.shuffle_select_k(g(), 100,
                                                             10).numpy())
    assert sorted(trng.shuffle_select_k(g(), 7, 7).tolist()) == list(range(7))
    with pytest.raises(ValueError):
        trng.shuffle_select_k(g(), 5, 6)


def test_sub_sample_size():
    """z(0.975) ~= 1.96 -> n = 1.96^2/4 / 0.05^2 ~= 384 (random.h:86-95),
    the JAX function's value exactly."""
    from lightctr_tpu.core import rng as jrng

    n = trng.sub_sample_size(0.05, 0.05)
    assert 380 <= n <= 390, n
    assert trng.sub_sample_size(0.05, 0.01) > n
    for a, e in ((0.05, 0.05), (0.01, 0.02), (0.1, 0.01)):
        assert trng.sub_sample_size(a, e) == jrng.sub_sample_size(a, e)


class Tree(NamedTuple):
    a: object
    b: object


def test_key_seq_and_split_tree_are_deterministic_and_independent():
    """Each stream is the same for one seed and differs across seeds; its
    generators draw different numbers; split_tree gives one generator a
    leaf, in the tree's structure."""
    def draws(seed, n=4):
        it = trng.key_seq(seed)
        return [float(torch.rand((), generator=next(it))) for _ in range(n)]

    assert draws(0) == draws(0)
    assert draws(0) != draws(1)
    assert len(set(draws(0))) == 4
    tree = {"x": 1, "y": Tree(a=2, b=[3, 4])}
    gens = trng.split_tree(torch.Generator().manual_seed(0), tree)
    assert isinstance(gens["y"], Tree) and len(gens["y"].b) == 2
    vals = [float(torch.rand((), generator=g)) for g in
            (gens["x"], gens["y"].a, *gens["y"].b)]
    assert len(set(vals)) == 4


# -- core/precision ------------------------------------------------------


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_policy_casts_floats_only_like_jax(compute):
    """``policy_for`` and the three casts: float leaves take the policy's
    dtype (the JAX policy's, by name), integer leaves stay."""
    jp, tp = jprecision.policy_for(compute), tprecision.policy_for(compute)
    tree = {"f": torch.ones(3), "i": torch.arange(3)}
    for which in ("compute", "wire", "param"):
        got = getattr(tp, f"cast_{which}")(tree)
        jdt = getattr(jp, f"{which}_dtype")
        assert str(got["f"].dtype).split(".")[-1] == jnp.dtype(jdt).name
        assert got["i"].dtype == torch.int64
    assert tprecision.DEFAULT_POLICY.compute_dtype == torch.float32
    assert tprecision.BF16_POLICY.compute_dtype == torch.bfloat16
