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
from lightctr_tpu_torch.tools import world_stress

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


def test_spawn_world_holds_its_rendezvous_port_before_the_ranks_start(
        monkeypatch):
    """The launcher's rendezvous store is bound in the calling process
    before any rank starts, its port is the one the ranks are given, and
    the ranks join it and run: no other process can take that port in
    between.  (A port looked up free, closed, and bound again by rank 0
    seconds later could be taken by a server of a test suite running
    beside the world, which failed the world with EADDRINUSE.)"""
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from lightctr_tpu_torch.core import mesh

    assert not hasattr(mesh, "free_port")
    stores, starts = [], []
    make_store, start = dist.TCPStore, tmp.start_processes

    def recording_store(*args, **kwargs):
        stores.append(make_store(*args, **kwargs))
        return stores[-1]

    def checked_start(*args, **kwargs):
        assert len(stores) == 1, "no rendezvous store before the ranks"
        port = stores[0].port
        assert port in kwargs["args"], "the ranks are not given its port"
        with socket.socket() as s:
            with pytest.raises(OSError):
                s.bind(("127.0.0.1", port))
        starts.append(port)
        return start(*args, **kwargs)

    monkeypatch.setattr(dist, "TCPStore", recording_store)
    monkeypatch.setattr(tmp, "start_processes", checked_start)
    spawn_world(world_stress.all_reduce_rank, 2, "gloo", deadline_s=120.0)
    assert len(starts) == 1


# -- the reduce-scatter exchange ----------------------------------------------


def dense_oracle(vocab, dim, uids, rows):
    """The [vocab, dim] float64 array a (uids, rows) pair denotes under
    ``.add`` scatter semantics."""
    out = np.zeros((vocab, dim))
    np.add.at(out, np.asarray(uids).reshape(-1),
              np.asarray(rows, np.float64).reshape(-1, dim))
    return out


def _jax_rs_once(jmesh, w, name):
    """The JAX package's ``sparse_reduce_scatter`` on a scenario of
    :func:`torch_dp_worlds.rs_cases` -> [all_uids, merged, overflow,
    *carries], each stacked over the members."""
    u, r, kw = worlds.rs_cases(w)[name]
    kw = dict(kw)
    extra = {}
    if kw.pop("residual", False):
        extra["residual"] = jcoll.sparse_ef_residual_init(
            jmesh, (kw["vocab"],) + r.shape[2:])
    out = jitted(jcoll.sparse_reduce_scatter, jmesh, **kw)(
        jnp.asarray(u), jnp.asarray(r), **extra)
    return [np.asarray(x) for x in out]


def _assert_rs_matches(ranks, key, want, rtol=1e-6, atol=1e-7):
    """Every rank's ``[all_uids, merged, overflow, *carries]`` against the
    JAX members' (ids and overflow exact), and the merged result
    bit-identical across ranks."""
    for r, out in enumerate(ranks):
        got = out["rs"][key]
        np.testing.assert_array_equal(got[0], want[0][r])
        np.testing.assert_allclose(got[1], want[1][r], rtol=rtol, atol=atol)
        assert int(got[2]) == int(want[2][r])
        for g, x in zip(got[3:], want[3:]):
            np.testing.assert_allclose(g, x[r], rtol=rtol, atol=atol)
        for i in (0, 1):
            np.testing.assert_array_equal(got[i], ranks[0]["rs"][key][i])


@pytest.mark.parametrize("name, average", [("mean", True),
                                           ("dup_sum", False),
                                           ("pads_sum", False)])
def test_reduce_scatter_exact_matches_jax_and_the_dense_oracle(
        world, name, average):
    """``test_sparse_rs.py``'s parity over world sizes (the mean), its hot
    id pool merged once at the owner (sum), and its id-0 padding beside a
    real id 0 under a bucket of 2 (the pads must be dropped or they would
    overflow): the JAX members' result, overflow 0, and the float64 dense
    sum (mean) of every rank's pairs."""
    w, jmesh, ranks = world
    want = _jax_rs_once(jmesh, w, name)
    _assert_rs_matches(ranks, name, want)
    u, r, _ = worlds.rs_cases(w)[name]
    vocab = int(max(u.max(), want[0].max())) + 1
    dense = sum(dense_oracle(vocab, r.shape[2], u[m], r[m])
                for m in range(w)) / (w if average else 1)
    got = ranks[0]["rs"][name]
    assert int(got[2]) == 0
    np.testing.assert_allclose(dense_oracle(vocab, r.shape[2], got[0],
                                            got[1]),
                               dense, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [16, 8])
def test_reduce_scatter_compressed_payload_matches_jax(world, bits):
    """Both phases' payloads coded with a dynamic range: 16-bit uniform
    tables are the JAX package's bit for bit; an 8-bit normal table's ulp
    differences may move a value one bucket in either encode.  The 16-bit
    merge stays within 1e-3 of the exact exchange (the JAX test's
    bound)."""
    w, jmesh, ranks = world
    want = _jax_rs_once(jmesh, w, f"coded{bits}")
    tol = 1e-6
    if bits == 8:
        u, r, _ = worlds.rs_cases(w)[f"coded{bits}"]
        rng = 1.05 * float(np.abs(r).max())
        tol = 2 * float(np.diff(np.asarray(jquant.build_table(
            -rng, rng, 8, "normal").values)).max())
    _assert_rs_matches(ranks, f"coded{bits}", want, rtol=0, atol=tol)
    got = ranks[0]["rs"][f"coded{bits}"][1]
    assert np.mean(np.abs(got - want[1][0]) <= 1e-6) > 0.95
    if bits == 16:
        u, r, kw = worlds.rs_cases(w)["coded16"]
        exact = jitted(jcoll.sparse_reduce_scatter, jmesh,
                       bucket_cap=kw["bucket_cap"],
                       shard_cap=kw["shard_cap"])(jnp.asarray(u),
                                                  jnp.asarray(r))
        np.testing.assert_array_equal(ranks[0]["rs"]["coded16"][0],
                                      np.asarray(exact[0])[0])
        np.testing.assert_allclose(got, np.asarray(exact[1])[0], rtol=0,
                                   atol=1e-3)


def test_reduce_scatter_out_ids_meet_the_apply_contract(world):
    """``merge_apply``'s apply mode skips the pads (id 0 past slot 0) and
    takes every other uid to be distinct: the all-gathered owner shards
    hold each real id once, and in the exact exchange every pad's row is
    zero."""
    _, _, ranks = world
    for name in ("mean", "dup_sum", "pads_sum"):
        ids, rows = ranks[0]["rs"][name][:2]
        pad = (ids == 0) & (np.arange(ids.size) > 0)
        real = ids[~pad]
        assert np.unique(real).size == real.size, name
        assert not rows[pad].any(), name


def test_rs_ef_overflow_carries_full_value(world):
    """A bucket-overflow victim (uids 1, 5, 9 on one owner, a bucket of
    2) ships nothing; with the stage-1 carry its full value lands in the
    carry instead, and the kept entries carry only rounding."""
    w, jmesh, ranks = world
    want = _jax_rs_once(jmesh, w, "overflow_ef")
    _assert_rs_matches(ranks, "overflow_ef", want, atol=1e-6)
    bucket_w = 2 * 1.0 / (1 << 8)
    for out in ranks:
        gu, m, over, res = out["rs"]["overflow_ef"]
        assert int(over) > 0
        merged = dense_oracle(32, 2, gu, m)
        assert abs(merged[9, 0]) < 1e-6
        np.testing.assert_allclose(res[9], 0.5, rtol=0, atol=1e-6)
        assert np.abs(res[[1, 5]]).max() <= bucket_w / 2 + 1e-7


def _jax_ef_rounds(jmesh, w, name):
    """The JAX package's rounds of an EF drain scenario of
    ``RS_EF_CASES``, each ``[all_uids, merged, overflow, *carries]``."""
    spike, dim, rounds, kw, carries = worlds.RS_EF_CASES[name]

    def call(u, r, res, ores):
        extra = {}
        if "residual" in carries:
            extra["residual"] = res
        if "owner_residual" in carries:
            extra["owner_residual"] = ores
        return jcoll.sparse_reduce_scatter(jmesh, u, r, **worlds.RS_EF_KW,
                                           **kw, **extra)

    fn = jax.jit(call)
    uids = jnp.tile(jnp.asarray(worlds.RS_EF_UIDS), (w, 1))
    spike_rows = jnp.asarray(worlds.rs_ef_rows(w, spike, dim))
    carry = {c: jcoll.sparse_ef_residual_init(jmesh, (worlds.RS_EF_VOCAB,
                                                      dim))
             for c in ("residual", "owner_residual")}
    steps = []
    for t in range(rounds):
        out = fn(uids, spike_rows if t == 0 else jnp.zeros_like(spike_rows),
                 carry["residual"], carry["owner_residual"])
        carry.update(zip(carries, out[3:]))
        steps.append([np.asarray(x) for x in out])
    return steps


def _applied(steps, dim):
    """Rank 0's rounds summed as the dense update they denote."""
    return sum(dense_oracle(worlds.RS_EF_VOCAB, dim, s[0], s[1])
               for s in steps)


def _ef_rounds_match(ranks, jmesh, w, name):
    want = _jax_ef_rounds(jmesh, w, name)
    got = [out["rs"][f"ef_{name}"] for out in ranks]
    for t, want_t in enumerate(want):
        _assert_rs_matches([{"rs": {"x": g[t]}} for g in got], "x", want_t,
                           atol=1e-6)
    return got


TOUCHED = [1, 2, 7, 8]
BUCKET_W = 2 * 1.0 / (1 << 8)


def test_rs_ef_residual_drains_and_recovers_clip(world):
    """Stage-1 carry, the mean: a spike of 2.5 past the range 1.0 clips
    at the ranks' scatter encode; without the carry the clipped mass is
    lost, with it the remainder arrives over the following rounds and the
    carry drains to under a bucket."""
    w, jmesh, ranks = world
    plain = _ef_rounds_match(ranks, jmesh, w, "stage1_plain")
    ef = _ef_rounds_match(ranks, jmesh, w, "stage1")
    applied_no, applied = _applied(plain[0], 3), _applied(ef[0], 3)
    assert all(int(s[2]) == 0 for s in plain[0])
    assert applied_no[1, 0] < 1.0 * 1.01
    for rank_steps in ef:
        assert float(np.abs(rank_steps[-1][3]).max()) <= BUCKET_W
    np.testing.assert_allclose(applied[TOUCHED], 2.5, rtol=0,
                               atol=8 * w * BUCKET_W)
    assert applied[TOUCHED].mean() > 1.5 * applied_no[TOUCHED].mean()


def test_rs_owner_ef_drains_sum_mode_stage2_clip(world):
    """Stage-2 carry, the sum: 0.6 a rank stays inside the range, the
    merged sum 0.6 W does not, so the owner's encode clips; the owner
    carry delivers the rest and drains (each row only on its owner's
    carry)."""
    w, jmesh, ranks = world
    plain = _ef_rounds_match(ranks, jmesh, w, "stage2_plain")
    ef = _ef_rounds_match(ranks, jmesh, w, "stage2")
    applied_no, applied = _applied(plain[0], 3), _applied(ef[0], 3)
    assert applied_no[1, 0] < 1.0 * 1.01
    for rank_steps in ef:
        assert float(np.abs(rank_steps[-1][3][TOUCHED]).max()) <= BUCKET_W
    np.testing.assert_allclose(applied[TOUCHED], w * 0.6, rtol=0,
                               atol=6 * w * BUCKET_W)
    assert applied[TOUCHED].mean() > applied_no[TOUCHED].mean() + \
        0.8 * (w * 0.6 - 1.0)


def test_rs_both_stage_carries_compose_under_clip(world):
    """Both carries: 1.7 a rank clips stage 1 and the merged sum clips
    stage 2; the rounds still deliver the full sum."""
    w, jmesh, ranks = world
    ef = _ef_rounds_match(ranks, jmesh, w, "both")
    np.testing.assert_allclose(_applied(ef[0], 2)[TOUCHED], w * 1.7,
                               rtol=0, atol=16 * w * BUCKET_W)


def test_rs_owner_ef_rejected_in_mean_mode(world):
    """An owner carry in mean mode is refused, in both packages."""
    w, jmesh, ranks = world
    for out in ranks:
        assert "SUM-mode" in out["rs"]["owner_mean_error"]
    with pytest.raises(ValueError, match="SUM-mode"):
        jcoll.sparse_reduce_scatter(
            jmesh, jnp.tile(jnp.arange(1, 5), (w, 1)),
            jnp.ones((w, 4, 2)), vocab=8, average=True, compress_bits=8,
            compress_range=1.0,
            owner_residual=jcoll.sparse_ef_residual_init(jmesh, (8, 2)))


def test_permute_slot_order_matches_rs_ring_exchange(world):
    """The port's scatter phase (``permute`` by 1..n-1 in one batch)
    returns the JAX ``ppermute`` ring's slot order: slot i holds the
    bucket rank (idx - i) % n addressed to idx, for float32 buckets and
    for 16-bit codes (which cross gloo as bytes)."""
    from jax.sharding import PartitionSpec as P

    from lightctr_tpu.core.compat import shard_map

    w, jmesh, ranks = world
    buckets = worlds.rs_ring_buckets(w)
    fn = jax.jit(shard_map(
        lambda b: jcoll._rs_ring_exchange(b[0], "data", w)[None],
        mesh=jmesh, in_specs=P("data"), out_specs=P("data")))
    want = np.asarray(fn(jnp.asarray(buckets)))
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["rs"]["ring"], want[r])
        np.testing.assert_array_equal(out["rs"]["ring_u16"],
                                      want[r].astype(np.int32))
        slots = out["rs"]["ring"][:, 0]
        np.testing.assert_array_equal(
            slots, [100 * ((r - i) % w) + r for i in range(w)])


def test_owner_partition_round_trip():
    """``rs_owner_partition`` and ``rs_scatter_rows`` against the JAX
    functions (``dest``, ``order``, buckets and overflow equal, the
    stable order included), the buckets denoting the input exactly, and an
    undersized bucket counting its overflow; codes scatter with their
    fill (8 and 16 bits)."""
    rng = np.random.default_rng(5)
    n, vocab, k, dim = 4, 64, 24, 3
    u = np.unique(rng.integers(1, vocab, size=k))
    uids = np.zeros(k, np.int32)
    rows = np.zeros((k, dim), np.float32)
    uids[:u.size] = u
    rows[:u.size] = rng.normal(size=(u.size, dim))
    for cap in (k, 2):
        jd, jo, jb, jover = jax.jit(jcoll.rs_owner_partition,
                                    static_argnums=(1, 2))(
            jnp.asarray(uids), n, cap)
        dest, order, bucket_ids, over = tcoll.rs_owner_partition(
            torch.from_numpy(uids), n, cap)
        np.testing.assert_array_equal(dest.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(bucket_ids.numpy(), np.asarray(jb))
        assert int(over) == int(jover)
        counts = np.bincount(u % n, minlength=n)
        assert int(over) == int(np.maximum(counts - cap, 0).sum())
        b_rows = tcoll.rs_scatter_rows(torch.from_numpy(rows), dest, order,
                                       n, cap)
        np.testing.assert_array_equal(b_rows.numpy(), np.asarray(
            jcoll.rs_scatter_rows(jnp.asarray(rows), jd, jo, n, cap)))
        for dtype, jdtype in ((torch.uint8, jnp.uint8),
                              (torch.uint16, jnp.uint16)):
            codes = torch.from_numpy(
                rng.integers(0, 200, size=(k, dim)).astype(np.int32))
            got = tcoll.rs_scatter_rows(codes.to(dtype), dest, order, n,
                                        cap, fill=torch.tensor(
                                            7, dtype=torch.int32).to(dtype))
            want = jcoll.rs_scatter_rows(jnp.asarray(codes.numpy(), jdtype),
                                         jd, jo, n, cap,
                                         fill=jnp.asarray(7, jdtype))
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                          np.asarray(want).astype(np.int32))
        if cap == k:
            b_ids = bucket_ids.numpy()
            for d in range(n):
                nz = b_ids[d][np.any(b_rows.numpy()[d] != 0, axis=-1)]
                assert (nz % n == d).all()
            np.testing.assert_array_equal(
                dense_oracle(vocab, dim, b_ids, b_rows.numpy()),
                dense_oracle(vocab, dim, uids, rows))


def test_rs_fits_predicts_overflow():
    """The host capacity check, against the JAX package's on its cases
    (a spread stream fits, one owned by one rank does not, nor a union
    past the shard) and on random streams either side of the caps."""
    n = 4
    good = [np.arange(1, 9) + 8 * m for m in range(n)]
    skew = [np.arange(1, 9) * n for _ in range(n)]
    wide = [np.arange(1, 40) + 40 * m for m in range(n)]
    cases = [(good, 4, 16, True), (skew, 4, 16, False),
             (wide, 40, 10, False)]
    rng = np.random.default_rng(9)
    for _ in range(20):
        ids = [rng.integers(0, 200, size=30) for _ in range(n)]
        bucket, shard = int(rng.integers(4, 12)), int(rng.integers(20, 60))
        cases.append((ids, bucket, shard, None))
    for ids, bucket, shard, expect in cases:
        got = tcoll.rs_fits(ids, n, bucket, shard)
        assert got == jcoll.rs_fits(ids, n, bucket, shard)
        if expect is not None:
            assert got is expect
