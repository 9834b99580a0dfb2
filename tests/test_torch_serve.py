"""The port's serving slice (lightctr_tpu_torch/serve) against the JAX
package's, on the CPU: the hot-embedding cache's policy trajectory, both
score paths, a PS-backed server end to end, and the wire across packages
(a port client against a JAX server and the reverse).  Scores that cross
the wire are held to 2e-3, the fp16 wire's tolerance that tests/test_serve.py
uses; scores computed in process to 1e-5 (fp32, summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu import obs as jobs
from lightctr_tpu import serve as jserve
from lightctr_tpu.dist import wire as jwire
from lightctr_tpu.dist.ps_server import ParamServerService as JPSService
from lightctr_tpu.dist.ps_server import PSClient as JPSClient
from lightctr_tpu.embed.async_ps import AsyncParamServer as JAsyncPS
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.ops.activations import sigmoid as jsigmoid
from lightctr_tpu_torch import obs as tobs
from lightctr_tpu_torch import serve as tserve
from lightctr_tpu_torch.dist import wire as twire
from lightctr_tpu_torch.dist.ps_server import ParamServerService as TPSService
from lightctr_tpu_torch.dist.ps_server import PSClient as TPSClient
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer as TAsyncPS
from lightctr_tpu_torch.ops import sparse_kernels as tsk

F, K = 256, 8
ROW_DIM = 1 + K
WIRE_ATOL = 2e-3
TOL = dict(atol=1e-5, rtol=1e-5)


def _params(seed=5):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0.0, 0.1, F).astype(np.float32),
            "v": (rng.standard_normal((F, K)) / np.sqrt(K)).astype(np.float32)}


def _batch(rng, n=8, nnz=4):
    return {"fids": rng.integers(1, F, size=(n, nnz)).astype(np.int32),
            "vals": rng.random((n, nnz)).astype(np.float32)}


def _jax_forward(params, batch):
    b = {"fids": jnp.asarray(batch["fids"]),
         "vals": jnp.asarray(batch["vals"]),
         "mask": jnp.ones_like(jnp.asarray(batch["vals"]))}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jsigmoid(jfm.logits(jp, b)))


# -- cache -------------------------------------------------------------------


@pytest.mark.parametrize("device_rows", [True, False])
def test_cache_policy_trajectory_matches_jax_host_cache(rng, device_rows):
    """Same admission, eviction, decay and invalidation trajectory as the
    JAX host cache over 30 steps; only row residence differs."""
    jc = jserve.HotEmbeddingCache(dim=4, capacity=8, admit_min_freq=2,
                                  registry=jobs.MetricsRegistry(),
                                  device_rows=False)
    tc = tserve.HotEmbeddingCache(dim=4, capacity=8, admit_min_freq=2,
                                  registry=tobs.MetricsRegistry(),
                                  device_rows=device_rows, device="cpu")
    assert tc.device_rows is device_rows
    for step in range(30):
        uids = np.unique(rng.integers(0, 24, size=6))
        jc.note_touched(uids)
        tc.note_touched(uids)
        rj, pj = jc.lookup(uids)
        rt, pt = tc.lookup(uids)
        np.testing.assert_array_equal(pj, pt)
        np.testing.assert_array_equal(rj, rt)
        offer = (uids[:, None] * np.ones((1, 4)) + step).astype(np.float32)
        assert jc.insert(uids[~pj], offer[~pj]) == \
            tc.insert(uids[~pt], offer[~pt])
        if step == 20:
            assert jc.set_version((1,)) == tc.set_version((1,))
    sj, st = jc.stats(), tc.stats()
    for k in ("entries", "hits", "misses", "evictions", "rejected",
              "invalidations", "tracked_uids"):
        assert sj[k] == st[k], k
    assert st["device_rows"] is device_rows
    # the device read path: same rows, zero rows on misses
    probe = np.arange(0, 16, dtype=np.int64)
    rows_dev, present = tc.lookup_device(probe)
    rows_host, present_h = jc.lookup(probe)
    assert isinstance(rows_dev, torch.Tensor)
    np.testing.assert_array_equal(present, present_h)
    np.testing.assert_array_equal(rows_dev.numpy(), rows_host)
    assert not rows_dev.numpy()[~present].any()


def test_cache_device_block_defaults_on_and_recycles_slots():
    c = tserve.HotEmbeddingCache(dim=4, capacity=8,
                                 registry=tobs.MetricsRegistry(),
                                 device="cpu")
    assert c.device_rows and c.stats()["device_rows"]
    assert c._block.shape == (8, 4) and c._block.dtype == torch.float32
    c.set_version((1,))
    for i in range(3):   # 24 offers through an 8-slot pool
        assert c.insert(np.arange(i * 8, i * 8 + 8, dtype=np.int64),
                        np.full((8, 4), i, np.float32)) >= 0
    assert len(c) <= c.capacity
    assert c.set_version((2,)) and len(c) == 0
    # repeated uids in one offer: the last offer wins, as in the JAX cache
    c.insert(np.array([5, 5], np.int64),
             np.array([[1] * 4, [2] * 4], np.float32))
    rows, present = c.lookup(np.array([5], np.int64))
    assert present.all() and (rows == 2).all()


# -- model -------------------------------------------------------------------


def test_fm_ps_rows_helpers_match_jax():
    p = _params()
    assert tserve.fm_ps_row_leaves(K) == jserve.fm_ps_row_leaves(K)
    tk, tr = tserve.fused_fm_rows(p)
    jk, jr = jserve.fused_fm_rows(p)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_score_rows_matches_jax(rng, n):
    p = _params()
    _, rows_all = tserve.fused_fm_rows(p)
    kw = dict(row_leaves=jserve.fm_ps_row_leaves(K), row_dim=ROW_DIM)
    jm = jserve.ServingModel("fm", {}, **kw)
    tm = tserve.ServingModel("fm", {}, device="cpu", **kw)
    b = _batch(rng, n=n, nnz=6)
    uids = tm.touched_uids(b)
    np.testing.assert_array_equal(uids, jm.touched_uids(b))
    want = jm.score_rows(b, uids, rows_all[uids])
    got = tm.score_rows(b, uids, rows_all[uids])
    np.testing.assert_allclose(got, want, **TOL)
    # a tensor row block (the device cache's gather) scores the same
    got_t = tm.score_rows(b, uids, torch.from_numpy(rows_all[uids]))
    np.testing.assert_array_equal(got_t, got)


def test_local_score_matches_jax(rng):
    p = _params()
    b = _batch(rng, n=11)
    want = jserve.ServingModel("fm", p).score(b)
    got = tserve.ServingModel("fm", p, device="cpu").score(b)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _jax_forward(p, b), **TOL)


def test_unported_kinds_raise_listing_what_is_there():
    for kind in ("deepfm", "widedeep", "dcn"):
        with pytest.raises(ValueError, match="not yet ported.*'fm'"):
            tserve.ServingModel(kind, {}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        tserve.ServingModel("nope", {}, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.ServingModel("fm", _params())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.HotEmbeddingCache(dim=4, capacity=8)
    model = tserve.ServingModel("fm", _params(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.PredictionServer(model)
    with pytest.raises(ValueError, match="unsupported device"):
        tserve.HotEmbeddingCache(dim=4, capacity=8, device="meta")


# -- end to end --------------------------------------------------------------


def _ps_service(pkg_async, pkg_service, pkg_client, params):
    keys, rows = tserve.fused_fm_rows(params)
    svc = pkg_service(pkg_async(dim=ROW_DIM, n_workers=1, seed=0))
    admin = pkg_client(svc.address, ROW_DIM)
    admin.preload_arrays(keys, rows)
    return svc, admin


def test_port_server_behind_port_ps_matches_jax_forward(rng):
    p = _params()
    svc, admin = _ps_service(TAsyncPS, TPSService, TPSClient, p)
    srv = cli = None
    try:
        srv = tserve.PredictionServer(
            tserve.ServingModel("fm", {},
                                row_leaves=tserve.fm_ps_row_leaves(K),
                                row_dim=ROW_DIM, device="cpu"),
            ps=TPSClient(svc.address, ROW_DIM), max_batch=16,
            max_wait_us=100, queue_cap=64, deadline_ms=5000, device="cpu")
        assert srv.cache.device_rows and srv.cache._block.device.type == "cpu"
        cli = tserve.PredictClient(srv.address)
        b = _batch(rng, n=4)
        before = tsk.launches("gather_rows")
        np.testing.assert_allclose(cli.predict(b), _jax_forward(p, b),
                                   atol=WIRE_ATOL)
        st0 = srv.cache.stats()
        assert st0["misses"] > 0
        # repeat: every row is a hit off the cache block, scores unchanged
        np.testing.assert_allclose(cli.predict(b), _jax_forward(p, b),
                                   atol=WIRE_ATOL)
        assert srv.cache.stats()["hits"] == st0["misses"]
        # CPU tensors take the plain version: no kernel launch counted
        assert tsk.launches("gather_rows") == before
    finally:
        if cli is not None:
            cli.close()
        if srv is not None:
            srv.close()
        admin.close()
        svc.close()


def test_wire_across_packages_both_ways(rng):
    """A port PredictClient against a JAX PredictionServer whose JAX
    PSClient pulls from a port PS, and a JAX PredictClient against a port
    PredictionServer over a JAX PS: the same scores both ways."""
    p = _params()
    b = _batch(rng, n=6)
    row_leaves = jserve.fm_ps_row_leaves(K)
    port_svc, port_admin = _ps_service(TAsyncPS, TPSService, JPSClient, p)
    jax_svc, jax_admin = _ps_service(JAsyncPS, JPSService, TPSClient, p)
    jsrv = tsrv = tcli = jcli = None
    try:
        # JAX PSClient -> port PS: the preloaded rows come back
        keys = np.arange(F, dtype=np.int64)
        _, pulled = port_admin.pull_arrays(keys, worker_epoch=0,
                                           worker_id=None, create=False)
        np.testing.assert_allclose(pulled, tserve.fused_fm_rows(p)[1],
                                   atol=1e-3)
        jsrv = jserve.PredictionServer(
            jserve.ServingModel("fm", {}, row_leaves=row_leaves,
                                row_dim=ROW_DIM),
            ps=JPSClient(port_svc.address, ROW_DIM), max_batch=16,
            max_wait_us=100, queue_cap=64, deadline_ms=5000)
        tsrv = tserve.PredictionServer(
            tserve.ServingModel("fm", {}, row_leaves=row_leaves,
                                row_dim=ROW_DIM, device="cpu"),
            ps=TPSClient(jax_svc.address, ROW_DIM), max_batch=16,
            max_wait_us=100, queue_cap=64, deadline_ms=5000, device="cpu")
        tcli = tserve.PredictClient(jsrv.address)
        jcli = jserve.PredictClient(tsrv.address)
        port_to_jax = tcli.predict(b)
        jax_to_port = jcli.predict(b)
        ref = _jax_forward(p, b)
        np.testing.assert_allclose(port_to_jax, ref, atol=WIRE_ATOL)
        np.testing.assert_allclose(jax_to_port, ref, atol=WIRE_ATOL)
        np.testing.assert_allclose(port_to_jax, jax_to_port, atol=WIRE_ATOL)
    finally:
        for c in (tcli, jcli):
            if c is not None:
                c.close()
        for s in (jsrv, tsrv):
            if s is not None:
                s.close()
        for c in (port_admin, jax_admin):
            c.close()
        port_svc.close()
        jax_svc.close()


def test_wire_frames_byte_identical_across_packages(rng):
    arrays = {"fids": rng.integers(0, 1 << 20, (5, 39)).astype(np.int32),
              "vals": rng.random((5, 39)).astype(np.float32)}
    assert twire.pack_predict_batch(arrays) == \
        jwire.pack_predict_batch(arrays)
    uids = np.unique(rng.integers(0, 1 << 30, 200)).astype(np.int64)
    rows = rng.standard_normal((len(uids), ROW_DIM)).astype(np.float32)
    assert twire.pack_rows(uids, rows) == jwire.pack_rows(uids, rows)
    assert twire.pack_keys(uids) == jwire.pack_keys(uids)
    assert twire.pack_ids(uids) == jwire.pack_ids(uids)
    assert twire.pack_values(rows) == jwire.pack_values(rows)
    t_frame, t_dec = twire.pack_rows_coded(uids, rows, 8)
    j_frame, j_dec = jwire.pack_rows_coded(uids, rows, 8)
    assert t_frame == j_frame
    np.testing.assert_array_equal(t_dec, j_dec)
