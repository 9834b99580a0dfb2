"""The port's ``embed.table`` against ``lightctr_tpu/embed/table.py`` on
the CPU: ``lookup``'s forward and its gradient (against ``jax.grad`` of
``jnp.take``), the touched-row SGD, Adagrad and DCASGD updates with and
without ``filter_preferred_grads``, the filter itself, and ``init_table``'s
contract.  Inputs from a numpy seed; the updates run in place in the port
and are held to the JAX functions' returns at rtol 1e-6 / atol 1e-7 (the
gradient sums and the filter bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import embed as jembed
from lightctr_tpu.embed import table as jtable
from lightctr_tpu_torch.embed import table as ttable
from lightctr_tpu_torch.ops import sparse_kernels as tsk

RTOL, ATOL = 1e-6, 1e-7


def ids_and_grads(seed, n=300, rows=64, dim=4, lo=0):
    """Duplicate-heavy ids (id 0 among them) and float32 gradients, some
    tiny and some huge so the filter has work to do."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, rows, size=n).astype(np.int32)
    g = rng.normal(size=(n, dim)).astype(np.float32)
    g[::17] *= 1e-9
    g[::23] *= 40.0
    return ids, g


@pytest.mark.parametrize("dim", [None, 1, 32])
def test_lookup_and_its_gradient_match_jax_take(dim):
    """Forward ``jnp.take`` exactly; the table's gradient of sum(rows * c)
    equals ``jax.grad`` of the same through ``jnp.take`` bit for bit (XLA's
    scatter-add sums each row's slots in slot order, as ``merge_rows``
    does); ids shaped [B, P] give rows [B, P, ...]."""
    rng = np.random.default_rng(dim or 0)
    shape = (500,) if dim is None else (500, dim)
    table = rng.normal(size=shape).astype(np.float32)
    ids = (rng.random((64, 39)) ** 4 * 500).astype(np.int32)
    c = rng.normal(size=ids.shape + shape[1:]).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_()
    got = ttable.lookup(tt, torch.from_numpy(ids))
    want = jtable.lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(c)).sum().backward()
    jgrad = jax.grad(lambda t: jnp.sum(jtable.lookup(t, jnp.asarray(ids))
                                       * c))(jnp.asarray(table))
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(jgrad))


def test_lookup_gradient_is_merge_rows_plain():
    """The backward is ``merge_rows`` on the flattened slots: on the CPU its
    plain version, which adds each row's slots in slot order from +0, as
    ``index_select``'s own backward does; int64 ids alike."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(100, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 100, size=(30, 5)))
    g = torch.from_numpy(rng.normal(size=(30, 5, 8)).astype(np.float32))
    t = table.clone().requires_grad_()
    ttable.lookup(t, ids).backward(g)
    want = tsk.merge_rows_plain(g.reshape(150, 8),
                                ids.reshape(-1).to(torch.int32), 100)
    assert torch.equal(t.grad, want)
    ref = table.clone().requires_grad_()
    ref.index_select(0, ids.reshape(-1)).reshape(30, 5, 8).backward(g)
    assert torch.equal(t.grad, ref.grad)
    # no gradient wanted, none computed
    out = ttable.lookup(table, ids)
    assert not out.requires_grad


@pytest.mark.parametrize("filter_grads", [False, True])
def test_sparse_sgd_update_matches_jax(filter_grads):
    ids, g = ids_and_grads(2)
    table = np.random.default_rng(3).normal(size=(64, 4)).astype(np.float32)
    want = jtable.sparse_sgd_update(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(g), 0.1,
                                    filter_grads=filter_grads)
    t = torch.from_numpy(table.copy())
    got = ttable.sparse_sgd_update(t, torch.from_numpy(ids),
                                   torch.from_numpy(g), 0.1,
                                   filter_grads=filter_grads)
    assert got is t  # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("filter_grads", [False, True])
def test_sparse_adagrad_update_matches_jax(filter_grads):
    ids, g = ids_and_grads(4)
    table = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
    js = jtable.init_adagrad_state(jnp.asarray(table))
    jt, js = jtable.sparse_adagrad_update(
        jnp.asarray(table), js, jnp.asarray(ids), jnp.asarray(g), 0.1,
        filter_grads=filter_grads)
    t = torch.from_numpy(table.copy())
    ts = ttable.init_adagrad_state(t)
    ttable.sparse_adagrad_update(t, ts, torch.from_numpy(ids),
                                 torch.from_numpy(g), 0.1,
                                 filter_grads=filter_grads)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ts.accum.numpy(), np.asarray(js.accum),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("filter_grads", [False, True])
def test_sparse_dcasgd_update_matches_jax(filter_grads):
    """Two workers' pushes in turn: the second sees the first's update
    through its stale shadow (paramserver.h:252-268)."""
    table = np.random.default_rng(6).normal(size=(32, 2)).astype(np.float32)
    jt = jnp.asarray(table)
    js = jtable.init_dcasgd_state(jt, n_workers=2)
    t = torch.from_numpy(table.copy())
    ts = ttable.init_dcasgd_state(t, n_workers=2)
    assert ts.shadow.shape == (2, 32, 2)
    for worker, seed in ((0, 7), (1, 8), (0, 9)):
        ids, g = ids_and_grads(seed, n=80, rows=32, dim=2)
        jt, js = jtable.sparse_dcasgd_update(
            jt, js, worker, jnp.asarray(ids), jnp.asarray(g), 0.1,
            dcasgd_lambda=0.5, filter_grads=filter_grads)
        ttable.sparse_dcasgd_update(t, ts, worker, torch.from_numpy(ids),
                                    torch.from_numpy(g), 0.1,
                                    dcasgd_lambda=0.5,
                                    filter_grads=filter_grads)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(ts.shadow.numpy(), np.asarray(js.shadow),
                                   rtol=RTOL, atol=ATOL)


def test_filter_preferred_grads_matches_jax():
    """Values at or below 1e-7 and at or above 15 in magnitude zeroed, bit
    for bit."""
    _, g = ids_and_grads(10, n=500)
    g[0, :3] = [1e-7, 15.0, -15.0]
    np.testing.assert_array_equal(
        ttable.filter_preferred_grads(torch.from_numpy(g)).numpy(),
        np.asarray(jtable.filter_preferred_grads(jnp.asarray(g))))


def test_init_table_contract():
    """N(0, 1/dim) rows from the generator, deterministic per seed; an
    explicit scale; a mesh refused (row-sharded tables are not ported)."""
    t = ttable.init_table(torch.Generator().manual_seed(0), 4096, 16)
    assert t.shape == (4096, 16) and t.dtype == torch.float32
    assert abs(float(t.std()) - 0.25) < 0.01
    assert torch.equal(t, ttable.init_table(torch.Generator().manual_seed(0),
                                            4096, 16))
    s = ttable.init_table(torch.Generator().manual_seed(0), 8, 2, scale=2.0)
    assert s.shape == (8, 2)
    with pytest.raises(ValueError, match="not yet ported"):
        ttable.init_table(torch.Generator(), 8, 2, mesh=object())
    # the JAX function's statistics at the same shape
    j = np.asarray(jembed.init_table(jax.random.PRNGKey(0), 4096, 16))
    assert abs(float(j.std()) - float(t.std())) < 0.01
