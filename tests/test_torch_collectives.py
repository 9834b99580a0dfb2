"""The port's collectives (``lightctr_tpu_torch.dist.collectives``) against
the JAX package's on the same numpy inputs: the byte accounting and the
exchange pick over a grid of arguments, then ``sparse_all_reduce`` (exact,
sum mode with pads, coded, coded with the EF carry), ``ring_all_reduce``
(plain and coded + EF) and ``psum_all_reduce`` in worlds of 2 and 4 gloo
ranks on the CPU — each world spawned once for the module through the
port's launcher, its ranks running ``tests/torch_dp_worlds.py`` — against
the JAX functions on the conftest's 8-device CPU mesh."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worlds as worlds
from lightctr_tpu.core.mesh import MeshSpec as JMeshSpec
from lightctr_tpu.core.mesh import make_mesh as jmake_mesh
from lightctr_tpu.dist import collectives as jcoll
from lightctr_tpu.ops import quantize as jquant
from lightctr_tpu_torch.core.mesh import spawn_world
from lightctr_tpu_torch.dist import collectives as tcoll

# -- byte accounting and the pick (pure Python, no world) --------------------

GRID = list(itertools.product(
    (1, 2, 4, 8),                    # n
    (1, 512, 79_872),                # k_padded
    (32, 4096, 1 << 20),             # vocab
    (1, 8, 32),                      # dim
    (None, 4, 8, 16),                # bits
))


@pytest.mark.parametrize("name", ["sparse_exchange_bytes",
                                  "dense_ring_bytes", "rs_default_caps",
                                  "prefer_sparse_exchange",
                                  "pick_exchange_algo", "sparse_rs_bytes"])
def test_byte_accounting_and_pick_match_jax(name):
    for n, k, vocab, dim, bits in GRID:
        if name == "sparse_exchange_bytes":
            args = [(n, k, dim, bits), (n, k, dim, bits, False)]
        elif name == "dense_ring_bytes":
            args = [(vocab, dim, n, bits)]
        elif name == "rs_default_caps":
            args = [(n, k, vocab), (n, k, vocab, 1.0)]
        elif name == "prefer_sparse_exchange":
            args = [(n, k, vocab, dim, bits, bits),
                    (n, k, vocab, dim, bits, None, 0.5)]
        elif name == "sparse_rs_bytes":
            args = [(n, k, max(1, k // 3), dim, bits),
                    (n, 7, 9, dim, bits, False)]
        else:
            args = [(n, k, vocab, dim, bits, bits),
                    (n, k, vocab, dim, None, None, 0.25)]
        for a in args:
            assert getattr(tcoll, name)(*a) == getattr(jcoll, name)(*a), a


def test_pick_for_fm_at_criteo_width_is_the_allgather():
    """FM at the Criteo layout (vocab 2^20, 4096 rows x 39 fields split
    over the ranks, dim 1 and 32), exact or 8-bit, at 2 and 4 ranks: both
    packages pick the sparse allgather, the path the port runs."""
    for n, dim, bits in itertools.product((2, 4), (1, 32), (None, 8)):
        k = 4096 * 39 // n
        want = jcoll.pick_exchange_algo(n, k, 1 << 20, dim, bits, bits)
        assert tcoll.pick_exchange_algo(n, k, 1 << 20, dim, bits,
                                        bits) == want
        assert want[0] == "sparse"
    with pytest.raises(ValueError, match="two-fabric"):
        tcoll.pick_exchange_algo(4, 16, 1024, 8, local_n=2)


# -- the spawned worlds -------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """(W, the JAX mesh, each rank's results) of one spawned world."""
    w = request.param
    out = tmp_path_factory.mktemp(f"collectives{w}")
    spawn_world(worlds.collectives_rank, w, "gloo", args=(str(out),),
                deadline_s=worlds.DEADLINE_S)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(w)]
    return w, jmake_mesh(JMeshSpec(data=w)), ranks


def jitted(fn, jmesh, **kw):
    """``fn(jmesh, *arrays, **kw)`` compiled once (eager shard_map runs
    op by op on the 8-device mesh, which is slow)."""
    return jax.jit(functools.partial(fn, jmesh, **kw))


def _stacked(w, key):
    return jnp.asarray(worlds.exchange_inputs(w)[key])


def _assert_ranks_agree(ranks, key):
    """Every rank holds rank 0's merged result, bit for bit."""
    for r in ranks[1:]:
        for a, b in zip(r[key], ranks[0][key]):
            np.testing.assert_array_equal(a, b)


def test_sparse_all_reduce_exact_matches_jax(world):
    w, jmesh, ranks = world
    gu, m = jitted(jcoll.sparse_all_reduce, jmesh)(_stacked(w, "uids"),
                                                   _stacked(w, "rows"))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["exact"][0], np.asarray(gu)[r])
        np.testing.assert_allclose(res["exact"][1], np.asarray(m)[r],
                                   rtol=1e-6, atol=1e-7)
    _assert_ranks_agree(ranks, "exact")


def test_sparse_all_reduce_sum_mode_with_pads_matches_jax(world):
    w, jmesh, ranks = world
    gu, m = jitted(jcoll.sparse_all_reduce, jmesh, average=False)(
        _stacked(w, "pad_uids"), _stacked(w, "pad_rows"))
    np.testing.assert_array_equal(ranks[0]["sum_pads"][0], np.asarray(gu)[0])
    np.testing.assert_allclose(ranks[0]["sum_pads"][1], np.asarray(m)[0],
                               rtol=1e-6, atol=1e-7)
    _assert_ranks_agree(ranks, "sum_pads")


@pytest.mark.parametrize("bits, mode", [(16, "uniform"), (8, "normal")])
def test_sparse_all_reduce_coded_matches_jax(world, bits, mode):
    """The dynamic-range coded exchange.  Uniform tables are bit-identical
    between the packages, so the 16-bit merge agrees to float rounding;
    normal tables differ by a few ulp (ndtri), so an 8-bit value near a
    boundary may take the next code: at most one bucket per value."""
    w, jmesh, ranks = world
    rows = _stacked(w, "rows")
    gu, m = jitted(jcoll.sparse_all_reduce, jmesh, compress_bits=bits,
                   compress_range="dynamic", compress_mode=mode)(
        _stacked(w, "uids"), rows)
    rng = 1.05 * float(jnp.max(jnp.abs(rows)))
    values = np.asarray(jquant.build_table(-rng, rng, bits, mode).values)
    tol = 1e-6 if mode == "uniform" else float(np.diff(values).max())
    got, want = ranks[0][f"coded{bits}"], np.asarray(m)[0]
    np.testing.assert_array_equal(got[0], np.asarray(gu)[0])
    np.testing.assert_allclose(got[1], want, rtol=0, atol=tol)
    assert np.mean(np.abs(got[1] - want) <= 1e-6) > 0.95
    _assert_ranks_agree(ranks, f"coded{bits}")


def test_sparse_all_reduce_ef_carry_matches_jax(world):
    """Fixed range 1.0, 8 bits uniform, with the per-rank EF residual over
    two calls: the clipped remainder of the first call re-enters the
    second (merged rows and every rank's residual)."""
    w, jmesh, ranks = world
    res = jcoll.sparse_ef_residual_init(jmesh, (48, 5))
    call = jitted(jcoll.sparse_all_reduce, jmesh, compress_bits=8,
                  compress_range=1.0, compress_mode="uniform")
    for step in range(2):
        gu, m, res = call(_stacked(w, "dd_uids"), _stacked(w, "dd_rows"),
                          residual=res)
        for r, out in enumerate(ranks):
            got_u, got_m, got_res = out["ef"][step]
            np.testing.assert_array_equal(got_u, np.asarray(gu)[r])
            np.testing.assert_allclose(got_m, np.asarray(m)[r], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got_res, np.asarray(res)[r],
                                       rtol=1e-6, atol=1e-6)
    assert np.abs(np.asarray(res)).max() > 0  # the clip fed the carry


def _tree(w, call):
    return {k: jnp.asarray(v) for k, v in
            worlds.exchange_inputs(w)["tree"][call].items()}


def test_ring_and_psum_all_reduce_match_jax(world):
    w, jmesh, ranks = world
    want_ring = jitted(jcoll.ring_all_reduce, jmesh)(_tree(w, 0))
    want_psum = jitted(jcoll.psum_all_reduce, jmesh)(_tree(w, 0))
    for r, out in enumerate(ranks):
        for k in ("a", "b"):
            np.testing.assert_allclose(out["ring_plain"][k],
                                       np.asarray(want_ring[k])[r],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(out["psum"][k],
                                       np.asarray(want_psum[k])[r],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["uniform", "normal"])
def test_ring_all_reduce_coded_ef_matches_jax(world, mode):
    """8-bit dynamic-range ring with the EF residual over three calls.
    Uniform tables are the JAX package's bit for bit; a normal table's
    ulp differences may move a value one bucket, so there each value is
    held to one bucket of that call's table."""
    w, jmesh, ranks = world
    res = jcoll.ef_residual_init(jmesh, _tree(w, 0))
    ring = jitted(jcoll.ring_all_reduce, jmesh, compress_bits=8,
                  compress_range="dynamic", compress_mode=mode)
    for call in range(3):
        tree = _tree(w, call)
        want, res = ring(tree, residual=res)
        tol = 1e-6
        if mode == "normal":
            flat = np.concatenate([np.abs(np.asarray(v)).reshape(w, -1)
                                   for v in tree.values()], axis=1)
            rng = 1.05 * (flat.max() + np.abs(np.asarray(res)).max())
            tol = 2 * float(np.diff(np.asarray(jquant.build_table(
                -rng, rng, 8, "normal").values)).max())
        for r, out in enumerate(ranks):
            got, got_res = out[f"ring_ef_{mode}"][call]
            for k in ("a", "b"):
                np.testing.assert_allclose(got[k], np.asarray(want[k])[r],
                                           rtol=0, atol=tol)
            np.testing.assert_allclose(got_res, np.asarray(res)[r], rtol=0,
                                       atol=tol)
        for out in ranks[1:]:
            for k in ("a", "b"):
                np.testing.assert_array_equal(
                    out[f"ring_ef_{mode}"][call][0][k],
                    ranks[0][f"ring_ef_{mode}"][call][0][k])
