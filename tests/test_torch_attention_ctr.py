"""The port's sequence CTR model (``models/attention_ctr.py``) against the
JAX package on the CPU, mirroring tests/test_attention_ctr.py: the padding
mask, learning a planted sequence signal through ``CTRTrainer`` with Adam,
the refusals; then the forward and the gradients of every leaf held to
the JAX model's from the JAX init carried across.

Tolerance: rtol 1e-4 / atol 2e-4, the tanh bound of ROADMAP §C ("In the
reference"): ``jax.nn.gelu`` is the tanh approximation, and XLA's CPU tanh
is itself an approximation (up to 2.7e-7 from a float64 tanh), where
PyTorch's ``F.gelu(approximate="tanh")`` is not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu import optim as joptim
from lightctr_tpu.models import attention_ctr as jattn
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.ops import losses as jlosses
from lightctr_tpu_torch import optim as toptim
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import _common
from lightctr_tpu_torch.models import attention_ctr as tattn
from lightctr_tpu_torch.models.ctr_trainer import (CTRTrainer, grads_of,
                                                    leaves_requiring_grad)
from lightctr_tpu_torch.ops import losses as tlosses

TANH_TOL = dict(rtol=1e-4, atol=2e-4)


def seq_batch(rng, n=256, t=20, vocab=100):
    """tests/test_attention_ctr.py's batch: the label says whether
    'purchase-intent' items (ids < 10) appear in the valid prefix."""
    ids = rng.integers(10, vocab, size=(n, t)).astype(np.int32)
    lengths = rng.integers(5, t + 1, size=n)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    for i in range(n):
        if y[i] == 1:
            pos = rng.integers(0, lengths[i], size=2)
            ids[i, pos] = rng.integers(0, 10, size=2)
    ids[mask == 0] = 0
    return {"seq_ids": ids, "seq_mask": mask, "labels": y}


def tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def carried(jparams):
    return _common.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def flat(tree, prefix=""):
    """{"blocks/0/qkv/w": array, ...} of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (v.detach().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v))
    return out


def test_padding_mask_invariance():
    rng = np.random.default_rng(0)
    params, logits = tattn.build(torch.Generator().manual_seed(0), 50,
                                 dim=16, n_heads=2)
    b = seq_batch(rng, n=8, t=12, vocab=50)
    z1 = logits(params, tb(b)).detach().numpy()
    ids2 = b["seq_ids"].copy()
    ids2[b["seq_mask"] == 0] = 7
    z2 = logits(params, tb(dict(b, seq_ids=ids2))).detach().numpy()
    np.testing.assert_allclose(z1, z2, rtol=1e-4, atol=1e-5)


def test_learns_sequence_signal():
    rng = np.random.default_rng(1)
    batch = seq_batch(rng)
    params, logits = tattn.build(torch.Generator().manual_seed(0), 100,
                                 dim=32, n_heads=4)
    tr = CTRTrainer(params, logits, TrainConfig(learning_rate=0.01),
                    optimizer=toptim.adam(0.003), device="cpu")
    tr.health = None
    hist = tr.fit(batch, epochs=30, batch_size=64)
    ev = tr.evaluate(batch)
    assert hist["loss"][-1] < hist["loss"][0]
    assert ev["auc"] > 0.9, ev


def test_rejects_bad_head_count():
    with pytest.raises(ValueError, match="divisible"):
        tattn.build(torch.Generator().manual_seed(0), 10, dim=10, n_heads=4)


def test_rejects_overlong_sequence():
    params, logits = tattn.build(torch.Generator().manual_seed(0), 20,
                                 dim=8, n_heads=2, max_len=16)
    b = {"seq_ids": torch.zeros((2, 32), dtype=torch.int32),
         "seq_mask": torch.ones((2, 32)), "labels": torch.zeros(2)}
    with pytest.raises(ValueError, match="max_len"):
        logits(params, b)


def test_init_tree_matches_jax_shapes_and_scales():
    """The same tree (keys, list of blocks, shapes) as the JAX init, the
    embedding ~ N(0, 1/dim), positions ~ N(0, 0.02^2), unit norms."""
    jp = jattn.init(jax.random.PRNGKey(0), 500, dim=16, n_heads=4,
                    n_layers=3, max_len=40)
    tp = tattn.init(torch.Generator().manual_seed(0), 500, dim=16,
                    n_heads=4, n_layers=3, max_len=40)
    fj, ft = flat(jp), flat(tp)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert fj[k].shape == ft[k].shape, k
    assert abs(float(tp["embed"].std()) - 0.25) < 0.01
    assert abs(float(tp["pos"].std()) - 0.02) < 0.003
    assert torch.equal(tp["blocks"][2]["ln1"], torch.ones(16))


@pytest.mark.parametrize("n_heads", [2, 4])
def test_forward_and_gradients_match_jax(n_heads):
    """Logits, and the gradient of mean logloss in every leaf (embed,
    positions, each block's qkv / out / ffn / norms, the head), from the
    JAX init carried across, at the tanh bound."""
    rng = np.random.default_rng(2)
    b = seq_batch(rng, n=16, t=12, vocab=60)
    jp = jattn.init(jax.random.PRNGKey(3), 60, dim=16, n_heads=n_heads,
                    n_layers=2, max_len=12)
    jl = jattn.make_logits(n_heads)
    tl = tattn.make_logits(n_heads)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        return jlosses.logistic_loss(jl(p, jbatch), jbatch["labels"],
                                     reduction="mean")

    leaves = leaves_requiring_grad(carried(jp))
    z = tl(leaves, tb(b))
    tlosses.logistic_loss(z, torch.from_numpy(b["labels"]),
                          reduction="mean").backward()
    np.testing.assert_allclose(z.detach().numpy(),
                               np.asarray(jl(jp, jbatch)), **TANH_TOL)
    gt, gj = flat(grads_of(leaves)), flat(jax.grad(jloss)(jp))
    assert sorted(gt) == sorted(gj)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], err_msg=k, **TANH_TOL)


def test_adam_trajectory_matches_jax():
    """Six minibatch Adam steps of ``CTRTrainer`` from the JAX init (the
    CLI's seqctr path): losses and every parameter at the tanh bound."""
    rng = np.random.default_rng(4)
    b = seq_batch(rng, n=96, t=10, vocab=40)
    jp = jattn.init(jax.random.PRNGKey(5), 40, dim=16, n_heads=2,
                    n_layers=2, max_len=10)
    jt = JCTRTrainer(jp, jattn.make_logits(2), JConfig(learning_rate=0.01),
                     optimizer=joptim.adam(0.01))
    tt = CTRTrainer(carried(jp), tattn.make_logits(2),
                    TrainConfig(learning_rate=0.01),
                    optimizer=toptim.adam(0.01), device="cpu")
    jt.health = tt.health = None
    lj = jt.fit(b, epochs=2, batch_size=32)["loss"]
    lt = tt.fit(b, epochs=2, batch_size=32)["loss"]
    np.testing.assert_allclose(lt, lj, **TANH_TOL)
    fj, ft = flat(jt.params), flat(tt.params)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], err_msg=k, **TANH_TOL)
    # the Adam state carries across too (count, mu and nu over the list
    # of blocks)
    st = _common.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.opt_state), "cpu")
    assert int(st.count) == int(jt.opt_state.count) == 6
    np.testing.assert_array_equal(
        st.mu["blocks"][1]["qkv"]["w"].numpy(),
        np.asarray(jt.opt_state.mu["blocks"][1]["qkv"]["w"]))
