"""The port's online learning plane on the CPU (``tests/test_online.py``'s
cases on ``lightctr_tpu_torch.online`` over the port's PS, serving cache
and server): the write-log subscription wire op (long-poll, floor
overflow), apply ages under clock skew, the freshness subscriber's
per-key invalidation and its stats-polling degrade, the shadow-gated swap
(parity accepted, corruption refused) and ``swap_params``, the
continuous trainer (FM learning the live rows, Wide&Deep exporting for a
watcher-driven swap, config validation), the series lint, and the
two-process train-and-serve acceptance (child scripts free of JAX, each
with its own deadline).  Then the port's ``OnlineTrainer`` step by step
against the JAX ``OnlineTrainer``: two PS services preloaded with the
same rows, the same batches, 8 steps of FM and of Wide&Deep; losses and
the PS rows within rtol 1e-4 / atol 2e-5 (XLA's ``logistic``/``exp`` and
torch's ``sigmoid`` differ in the last place, as recorded for the quality
plane).

The tiered store's subscription case runs on the port's
``TieredEmbeddingStore`` (numpy mode) behind the port's service."""

import ast
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from lightctr_tpu_torch import obs, online, serve
from lightctr_tpu_torch.data.streaming import iter_libffm_batches
from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.models import fm, widedeep
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.ops.activations import sigmoid

REPO_ROOT = str(Path(__file__).resolve().parent.parent)

F, K = 256, 8
ROW_DIM = 1 + K
RTOL, ATOL = 1e-4, 2e-5


def _fm_params(seed=5):
    return fm.init(torch.Generator().manual_seed(seed), F, K)


def _fm_forward(params, batch):
    b = {"fids": torch.as_tensor(batch["fids"]),
         "vals": torch.as_tensor(batch["vals"]),
         "mask": torch.ones(batch["vals"].shape)}
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    return sigmoid(fm.logits(p, b)).numpy()


def _batch(rng, n=4, nnz=4):
    return {"fids": rng.integers(1, F, size=(n, nnz)).astype(np.int32),
            "vals": np.ones((n, nnz), np.float32)}


def _write_fm_stream(path, rng, rows=512, nnz=4):
    """A learnable synthetic libFFM stream: labels follow a logistic in a
    fixed per-fid weight, so PS-trained rows provably move."""
    w_true = rng.normal(size=F)
    with open(path, "w") as f:
        for _ in range(rows):
            fids = rng.integers(1, F, size=nnz)
            z = w_true[fids].sum()
            y = int(1.0 / (1.0 + np.exp(-z)) > rng.random())
            f.write(f"{y} " + " ".join(f"0:{d}:1.0" for d in fids) + "\n")


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _ps_backed_server(svc):
    return serve.PredictionServer(
        serve.ServingModel("fm", {}, row_leaves=serve.fm_ps_row_leaves(K),
                           row_dim=ROW_DIM, device="cpu"),
        ps=PSClient(svc.address, ROW_DIM), max_batch=16, max_wait_us=100,
        queue_cap=64, deadline_ms=5000, cache_capacity=F, device="cpu",
    )


# -- the series lint -------------------------------------------------------------


def test_online_series_declared_and_emitted():
    from lightctr_tpu import online as jonline

    emitted = set()
    for name in ("trainer.py", "swap.py", "freshness.py"):
        path = os.path.join(REPO_ROOT, "lightctr_tpu_torch", "online", name)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("inc", "gauge_set", "observe")
                    and node.args):
                continue
            arg = node.args[0]
            if (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
                    and arg.func.id == "labeled" and arg.args):
                arg = arg.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                emitted.add(arg.value)
    assert emitted == set(online.ONLINE_SERIES)
    assert online.ONLINE_SERIES == jonline.ONLINE_SERIES


# -- the wire op -------------------------------------------------------------------


def test_subscribe_long_polls_and_returns_stamped_deltas():
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    svc = ParamServerService(store)
    cli = PSClient(svc.address, ROW_DIM, timeout=10.0)
    try:
        rep = cli.subscribe_deltas(1 << 62, timeout_ms=0)
        assert rep["covered"] and rep["entries"] == []
        since = rep["write_version"]
        t_before = time.time()
        cli.push_arrays(0, np.array([7, 9], np.int64),
                        np.ones((2, ROW_DIM), np.float32), worker_epoch=0)
        rep = cli.subscribe_deltas(since, timeout_ms=2000)
        assert rep["covered"]
        (ver, uids, ts), = [e for e in rep["entries"] if e[0] > since]
        assert uids == [7, 9]
        assert t_before - 1.0 <= ts <= time.time() + 1.0
        assert rep["write_version"] == ver == since + 1
        t0 = time.monotonic()
        rep = cli.subscribe_deltas(rep["write_version"], timeout_ms=200)
        assert rep["entries"] == []
        assert time.monotonic() - t0 >= 0.15
    finally:
        cli.close()
        svc.close()


def test_subscribe_floor_overflow_reports_uncovered():
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    store.WRITE_LOG_MAX_ENTRIES = 1
    svc = ParamServerService(store)
    cli = PSClient(svc.address, ROW_DIM, timeout=10.0)
    try:
        since = cli.subscribe_deltas(1 << 62, timeout_ms=0)["write_version"]
        for i in range(3):
            cli.push_arrays(0, np.array([i + 1], np.int64),
                            np.ones((1, ROW_DIM), np.float32),
                            worker_epoch=0)
        rep = cli.subscribe_deltas(since, timeout_ms=1000)
        assert not rep["covered"]
        assert rep["floor"] > since and rep["entries"] == []
    finally:
        cli.close()
        svc.close()


def test_tiered_store_serves_subscriptions(tmp_path, rng):
    """MSG_SUBSCRIBE long-polls a tiered shard instead of being rejected
    into the stats-polling degrade — pushes, preloads and evictions all
    land in the delta, and a live FreshnessSubscriber stays in
    ``subscribe`` mode against it."""
    from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore

    store = TieredEmbeddingStore(
        dim=ROW_DIM, hot_rows=16, path=str(tmp_path / "sub" / "store"),
        updater="adagrad", n_workers=1, seed=0, device_hot=False,
    )
    svc = ParamServerService(store)
    cli = PSClient(svc.address, ROW_DIM, timeout=10.0)
    try:
        rep = cli.subscribe_deltas(1 << 62, timeout_ms=0)  # arm: no wait
        assert rep["covered"] and rep["entries"] == []
        assert "server_time" in rep
        since = rep["write_version"]
        cli.push_arrays(0, np.array([7, 9], np.int64),
                        np.ones((2, ROW_DIM), np.float32), worker_epoch=0)
        rep = cli.subscribe_deltas(since, timeout_ms=2000)
        assert rep["covered"]
        (ver, uids, _ts), = [e for e in rep["entries"] if e[0] > since]
        assert uids == [7, 9] and ver == since + 1
        # eviction invalidates through the same log (a migrated-away key
        # must not survive as a stale cached row)
        store.evict_batch(np.array([7], np.int64))
        rep = cli.subscribe_deltas(ver, timeout_ms=2000)
        assert [7] in [e[1] for e in rep["entries"]]
        # the stats record carries the same shape (the poll degrade path)
        wd = cli.stats()["write_delta"]
        assert wd["entries"] and "server_time" in wd

        # a live subscriber against the tiered shard: arms, stays in
        # subscribe mode, applies per-key deltas — no stats_poll degrade
        keys, rows = serve.fused_fm_rows(
            {k: v.numpy() for k, v in _fm_params().items()})
        cli.preload_arrays(keys, rows)
        srv = _ps_backed_server(svc)
        sub = online.FreshnessSubscriber(
            srv, [svc.address], ROW_DIM, slo_s=30.0, poll_ms=300,
        ).start()
        pc = None
        try:
            _wait(lambda: sub.stats()["versions"][0] >= 0, 5,
                  "subscriber arm on tiered shard")
            assert sub.stats()["modes"][0] == "subscribe"
            pc = serve.PredictClient(srv.address)
            b = _batch(rng, n=4)
            pc.predict(b)
            n0 = len(srv.cache)
            assert n0 > 1
            victim = int(np.unique(b["fids"])[0])
            cli.push_arrays(0, np.array([victim], np.int64),
                            np.zeros((1, ROW_DIM), np.float32),
                            worker_epoch=1)
            _wait(lambda: len(srv.cache) == n0 - 1, 5,
                  "tiered push-based delta drop")
            assert sub.stats()["modes"][0] == "subscribe"
        finally:
            if pc is not None:
                pc.close()
            sub.stop()
            srv.close()
    finally:
        cli.close()
        svc.close()
        store.close()


def test_apply_age_is_server_relative_under_clock_skew():
    keys, rows = serve.fused_fm_rows(_fm_params())
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    svc = ParamServerService(store)
    admin = PSClient(svc.address, ROW_DIM)
    admin.preload_arrays(keys, rows)
    srv = _ps_backed_server(svc)
    sub = online.FreshnessSubscriber(srv, [svc.address], ROW_DIM,
                                     slo_s=30.0)  # replies injected
    try:
        skew = 1000.0
        t_srv = time.time() - skew
        sub._apply(0, {"write_version": 5, "floor": 0, "covered": True,
                       "entries": [], "server_time": t_srv})
        sub._apply(0, {
            "write_version": 6, "floor": 0, "covered": True,
            "entries": [[6, [int(keys[0])], t_srv]],
            "server_time": t_srv + 0.25,
        })
        age = sub.age_s()
        assert age is not None and age < 5.0
        h = srv.registry.snapshot()["histograms"].get(
            "serve_freshness_apply_age_seconds")
        if h:
            assert h["sum"] < 5.0, h
        sub._apply(0, {"write_version": 7, "floor": 0, "covered": True,
                       "entries": [[7, [int(keys[0])], time.time()]]})
        assert sub.age_s() < 5.0
    finally:
        sub.stop()
        srv.close()
        admin.close()
        svc.close()


# -- the freshness subscriber ------------------------------------------------------


def test_subscriber_drives_per_key_invalidation_and_feeds_slo(rng):
    keys, rows = serve.fused_fm_rows(_fm_params())
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    svc = ParamServerService(store)
    admin = PSClient(svc.address, ROW_DIM)
    admin.preload_arrays(keys, rows)
    srv = _ps_backed_server(svc)
    assert srv.version_poll_s == 0.0
    sub = online.FreshnessSubscriber(
        srv, [svc.address], ROW_DIM, slo_s=30.0, poll_ms=300).start()
    cli = None
    try:
        _wait(lambda: sub.stats()["versions"][0] >= 0, 5, "subscriber arm")
        cli = serve.PredictClient(srv.address)
        b = _batch(rng, n=4)
        cli.predict(b)
        n0 = len(srv.cache)
        assert n0 > 1
        victim = int(np.unique(b["fids"])[0])
        admin.push_arrays(0, np.array([victim], np.int64),
                          np.zeros((1, ROW_DIM), np.float32),
                          worker_epoch=0)
        _wait(lambda: len(srv.cache) == n0 - 1, 5, "push-based delta drop")
        st = sub.stats()
        assert st["applied_entries"] == 1 and st["dropped_rows"] == 1
        assert st["full_refreshes"] == 0
        assert srv.cache.stats()["invalidations"] == 0
        det = srv.health.verdict()["detectors"]["freshness_slo"]
        assert det["checks"] > 0 and det["status"] == health_mod.OK
        counters = srv.registry.snapshot()["counters"]
        assert counters["serve_freshness_deltas_applied_total"] == 1
        assert counters["serve_freshness_rows_dropped_total"] == 1
        # floor overflow: FULL drop, counted under reason="floor"
        cli.predict(b)
        store.WRITE_LOG_MAX_ENTRIES = 0
        store.WRITE_LOG_MAX_UIDS = 0
        admin.push_arrays(0, np.array([victim], np.int64),
                          np.zeros((1, ROW_DIM), np.float32),
                          worker_epoch=0)
        _wait(lambda: sub.stats()["full_refreshes"] == 1, 5,
              "floor-overflow full refresh")
        assert len(srv.cache) == 0
        counters = srv.registry.snapshot()["counters"]
        assert counters[obs.labeled("serve_freshness_full_refresh_total",
                                    reason="floor")] == 1
    finally:
        if cli is not None:
            cli.close()
        sub.stop()
        srv.close()
        admin.close()
        svc.close()


def test_subscriber_degrades_to_stats_polling_without_the_surface(rng):
    keys, rows = serve.fused_fm_rows(_fm_params())
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    store.wait_write_delta = None
    svc = ParamServerService(store)
    admin = PSClient(svc.address, ROW_DIM)
    admin.preload_arrays(keys, rows)
    srv = _ps_backed_server(svc)
    sub = online.FreshnessSubscriber(
        srv, [svc.address], ROW_DIM, slo_s=30.0, poll_ms=300,
        degraded_poll_s=0.05).start()
    cli = None
    try:
        _wait(lambda: sub.stats()["modes"][0] == "stats_poll", 5,
              "degrade to stats polling")
        _wait(lambda: sub.stats()["versions"][0] >= 0, 5, "poll-mode arm")
        cli = serve.PredictClient(srv.address)
        b = _batch(rng, n=4)
        cli.predict(b)
        n0 = len(srv.cache)
        victim = int(np.unique(b["fids"])[0])
        admin.push_arrays(0, np.array([victim], np.int64),
                          np.zeros((1, ROW_DIM), np.float32),
                          worker_epoch=0)
        _wait(lambda: len(srv.cache) == n0 - 1, 5, "poll-mode delta drop")
        assert sub.stats()["applied_entries"] >= 1
        cli.predict(b)
        assert len(srv.cache) > 0
        store.WRITE_LOG_MAX_ENTRIES = 0
        store.WRITE_LOG_MAX_UIDS = 0
        admin.push_arrays(0, np.array([victim], np.int64),
                          np.zeros((1, ROW_DIM), np.float32),
                          worker_epoch=0)
        _wait(lambda: sub.stats()["full_refreshes"] >= 1, 5,
              "poll-mode floor-overrun full refresh")
        assert len(srv.cache) == 0
    finally:
        if cli is not None:
            cli.close()
        sub.stop()
        srv.close()
        admin.close()
        svc.close()


# -- the swap gate -----------------------------------------------------------------


def _wd_params(seed=7, field_cnt=3, factor_dim=4, hidden=50):
    p = widedeep.init(torch.Generator().manual_seed(seed), F, field_cnt,
                      factor_dim, hidden=hidden)
    return {k: (v.numpy() if not isinstance(v, dict)
                else {kk: vv.numpy() for kk, vv in v.items()})
            for k, v in p.items()}


def _wd_replay(rng, n=2):
    return [{
        "fids": rng.integers(1, F, size=(4, 3)).astype(np.int32),
        "vals": np.ones((4, 3), np.float32),
        "rep_fids": rng.integers(1, F, size=(4, 3)).astype(np.int32),
        "rep_mask": np.ones((4, 3), np.float32),
    } for _ in range(n)]


def test_swapper_accepts_parity_and_refuses_corruption(tmp_path, rng):
    np_params = _wd_params()
    model = serve.ServingModel("widedeep", np_params, device="cpu")
    replay = _wd_replay(rng)
    before = [model.score(r) for r in replay]
    reg = obs.MetricsRegistry()
    sw = online.ModelSwapper(model, replay, tolerance=5e-3, registry=reg)
    d = str(tmp_path)
    good = online.publish_export(d, np_params, model="widedeep", step=1,
                                 device="cpu")
    assert sw.offer(good) is True
    assert model.version == 1
    for r, s in zip(replay, before):
        np.testing.assert_allclose(model.score(r), s, atol=5e-3)
    bad = dict(np_params)
    bad["fc1"] = {"w": np_params["fc1"]["w"] + 3.0,
                  "b": np_params["fc1"]["b"]}
    assert sw.offer(online.publish_export(d, bad, model="widedeep", step=2,
                                          device="cpu")) is False
    nan = dict(np_params)
    nan["fc2"] = {"w": np.full_like(np_params["fc2"]["w"], np.nan),
                  "b": np_params["fc2"]["b"]}
    assert sw.offer(online.publish_export(d, nan, model="widedeep", step=3,
                                          codec="fp32",
                                          device="cpu")) is False
    torn = os.path.join(d, "torn.npz")
    with open(torn, "wb") as f:
        f.write(b"\x00" * 64)
    assert sw.offer(torn) is False
    wrong = online.publish_export(d, {"w": np.zeros(4, np.float32)},
                                  model="fm", step=4, device="cpu")
    assert sw.offer(wrong) is False
    st = sw.stats()
    assert st["attempts"] == 5 and st["accepted"] == 1
    assert st["refusals"] == {"parity": 1, "nonfinite": 1, "load": 1,
                              "kind": 1}
    assert model.version == 1
    counters = reg.snapshot()["counters"]
    assert counters["online_swap_attempts_total"] == 5
    assert counters["online_swap_accepted_total"] == 1
    assert counters[obs.labeled("online_swap_refused_total",
                                reason="parity")] == 1
    assert online.read_latest(d).endswith("model_0000000004.npz")


def test_published_artifact_is_byte_equal_to_the_jax_packages(tmp_path):
    """``publish_export`` writes through ``save_compressed_npz``, whose
    artifact is the JAX package's byte for byte."""
    from lightctr_tpu.online import publish_export as jpublish

    np_params = _wd_params()
    a = online.publish_export(str(tmp_path / "t"), np_params,
                              model="widedeep", step=3, device="cpu")
    b = jpublish(str(tmp_path / "j"), np_params, model="widedeep", step=3)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert (os.path.basename(online.read_latest(str(tmp_path / "t")))
            == os.path.basename(b))


def test_swap_params_is_structural_and_bumps_version():
    params = _fm_params(0)
    model = serve.ServingModel("fm", params, device="cpu")
    with pytest.raises(ValueError, match="structural"):
        model.swap_params({"w": np.zeros(F, np.float32)})
    v = model.swap_params({"w": np.zeros(F, np.float32),
                           "v": params["v"].numpy()})
    assert v == model.version == 1


# -- the continuous trainer --------------------------------------------------------


def test_online_trainer_fm_learns_the_live_rows(tmp_path, rng):
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    svc = ParamServerService(store)
    admin = PSClient(svc.address, ROW_DIM)
    keys, rows0 = serve.fused_fm_rows(_fm_params())
    admin.preload_arrays(keys, rows0)
    p = str(tmp_path / "train.ffm")
    _write_fm_stream(p, rng, rows=512)
    reg = obs.MetricsRegistry()
    tr = online.OnlineTrainer(admin, "fm", K, worker_id=0, registry=reg,
                              device="cpu")
    losses = []
    try:
        for mb in iter_libffm_batches(p, 64, 4, loop=True):
            losses.append(tr.step(mb))
            if tr.steps >= 24:  # 3 wrapped epochs
                break
        assert tr.steps == 24
        assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.05
        _, rows1 = admin.snapshot_arrays()
        assert np.abs(rows1 - rows0).max() > 1e-3
        counters = reg.snapshot()["counters"]
        assert counters["online_steps_total"] == 24
        assert counters["online_examples_total"] == 24 * 64
        st = tr.stats()
        assert set(st["phase_seconds"]) == {"pull", "step", "push"}
        assert all(v > 0 for v in st["phase_seconds"].values())
    finally:
        admin.close()
        svc.close()


def test_online_trainer_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        online.OnlineTrainer(None, "fm", 8)


def test_online_trainer_widedeep_exports_and_watcher_swaps(tmp_path, rng):
    FL = 4
    wparams = _wd_params(3, FL, K, hidden=16)
    keys, rows = serve.fused_fm_rows(
        {"w": wparams["w"], "v": wparams["embed"]})
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=0)
    svc = ParamServerService(store)
    admin = PSClient(svc.address, ROW_DIM)
    admin.preload_arrays(keys, rows)
    p = str(tmp_path / "wd.ffm")
    with open(p, "w") as f:
        for i in range(256):
            fids = rng.integers(1, F, size=FL)
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{d}:1.0" for j, d in enumerate(fids)) + "\n")
    export_dir = str(tmp_path / "exports")
    dense0 = {k: wparams[k] for k in ("fc1", "fc2")}
    tr = online.OnlineTrainer(
        admin, "widedeep", K, field_cnt=FL, dense_params=dense0,
        dense_lr=0.01, export_dir=export_dir, export_every=5,
        export_codec="fp32", registry=obs.MetricsRegistry(), device="cpu")
    try:
        tr.run(iter_libffm_batches(p, 32, FL, loop=True), max_steps=11,
               prefetch=2)
        assert tr.exports == 2
        assert online.read_latest(export_dir).endswith(
            "model_0000000010.npz")
        model = serve.ServingModel(
            "widedeep", {k: tr.dense[k] for k in ("fc1", "fc2")},
            row_leaves={"w": (0, 1, True), "embed": (1, ROW_DIM, False)},
            row_dim=ROW_DIM, device="cpu")
        replay = [{
            "fids": rng.integers(1, F, size=(4, FL)).astype(np.int32),
            "vals": np.ones((4, FL), np.float32),
            "rep_fids": rng.integers(1, F, size=(4, FL)).astype(np.int32),
            "rep_mask": np.ones((4, FL), np.float32),
        }]
        sw = online.ModelSwapper(
            model, replay, tolerance=0.5,
            pull_rows=lambda uids: admin.pull_arrays(
                uids, worker_epoch=0, worker_id=None, create=False)[1],
            registry=obs.MetricsRegistry())
        sw.watch(export_dir, poll_s=0.05)
        try:
            _wait(lambda: sw.stats()["attempts"] >= 1, 10, "watcher pickup")
            assert sw.stats()["accepted"] == 1 and model.version == 1
        finally:
            sw.stop_watch()
    finally:
        admin.close()
        svc.close()


def test_online_trainer_validates_config():
    with pytest.raises(ValueError, match="field_cnt"):
        online.OnlineTrainer(None, "widedeep", 8)
    with pytest.raises(ValueError, match="dense"):
        online.OnlineTrainer(None, "fm", 8, export_every=5)
    with pytest.raises(ValueError, match="kind"):
        online.OnlineTrainer(None, "gbm", 8)


# -- the port's OnlineTrainer against the JAX one, step by step --------------------


def _pair_services(rows_keys, rows):
    """Two PS services (the port's and the JAX package's), one seed, the
    same rows preloaded; returns ((port svc, client), (jax svc, client))."""
    from lightctr_tpu.dist.ps_server import ParamServerService as JSvc
    from lightctr_tpu.dist.ps_server import PSClient as JClient
    from lightctr_tpu.embed.async_ps import AsyncParamServer as JStore

    tsvc = ParamServerService(AsyncParamServer(dim=ROW_DIM, n_workers=1,
                                               seed=0))
    jsvc = JSvc(JStore(dim=ROW_DIM, n_workers=1, seed=0))
    tcli, jcli = PSClient(tsvc.address, ROW_DIM), JClient(jsvc.address,
                                                          ROW_DIM)
    tcli.preload_arrays(rows_keys, rows)
    jcli.preload_arrays(rows_keys, rows)
    return (tsvc, tcli), (jsvc, jcli)


def _rows_of(cli, keys):
    return cli.pull_arrays(keys, worker_epoch=0, worker_id=None,
                           create=False)[1]


@pytest.mark.parametrize("kind", ["fm", "widedeep"])
def test_online_trainer_matches_the_jax_trainer_step_by_step(kind, tmp_path,
                                                             rng):
    from lightctr_tpu.online import OnlineTrainer as JOnlineTrainer

    FL = 4
    if kind == "fm":
        keys, rows = serve.fused_fm_rows(_fm_params())
        path = str(tmp_path / "fm.ffm")
        _write_fm_stream(path, rng, rows=8 * 64)
        batches = list(iter_libffm_batches(path, 64, 4))
        kw, jkw = {}, {}
    else:
        wparams = _wd_params(3, FL, K, hidden=16)
        keys, rows = serve.fused_fm_rows(
            {"w": rng.normal(size=F).astype(np.float32) * 0.1,
             "v": wparams["embed"]})
        path = str(tmp_path / "wd.ffm")
        w_true = rng.normal(size=F)
        with open(path, "w") as f:
            for _ in range(8 * 32):
                fids = rng.integers(1, F, size=FL)
                y = int(w_true[fids].sum() > 0)
                f.write(f"{y} " + " ".join(
                    f"{j}:{d}:1.0" for j, d in enumerate(fids)) + "\n")
        batches = list(iter_libffm_batches(path, 32, FL))
        dense0 = {k: wparams[k] for k in ("fc1", "fc2")}
        kw = dict(field_cnt=FL, dense_params=dense0, dense_lr=0.05)
        jkw = dict(field_cnt=FL, dense_params={
            k: {kk: np.array(vv) for kk, vv in v.items()}
            for k, v in dense0.items()}, dense_lr=0.05)
    assert len(batches) == 8
    (tsvc, tcli), (jsvc, jcli) = _pair_services(keys, rows)
    try:
        tr = online.OnlineTrainer(tcli, kind, K, registry=obs.MetricsRegistry(),
                                  device="cpu", **kw)
        jtr = JOnlineTrainer(jcli, kind, K, **jkw)
        for i, mb in enumerate(batches):
            lt, lj = tr.step(mb), jtr.step(mb)
            np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} loss")
        np.testing.assert_allclose(_rows_of(tcli, keys), _rows_of(jcli, keys),
                                   rtol=RTOL, atol=ATOL)
        if kind == "widedeep":
            for leaf in ("fc1", "fc2"):
                for k in ("w", "b"):
                    np.testing.assert_allclose(
                        tr.dense[leaf][k], np.asarray(jtr.dense[leaf][k]),
                        rtol=RTOL, atol=ATOL)
        assert tr.stats()["steps"] == jtr.stats()["steps"] == 8
    finally:
        tcli.close()
        jcli.close()
        tsvc.close()
        jsvc.close()


# -- acceptance: continuous train-and-serve across processes ---------------------


SERVER_SCRIPT = """
import sys
sys.path.insert(0, %(root)r)
import numpy as np, torch
torch.set_num_threads(1)
from lightctr_tpu_torch import online, serve
from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.models import fm, widedeep
from lightctr_tpu_torch.obs import exporter

F, K, ROW_DIM = %(F)d, %(K)d, %(ROW_DIM)d
params = fm.init(torch.Generator().manual_seed(5), F, K)
keys, rows = serve.fused_fm_rows(params)
store = AsyncParamServer(dim=ROW_DIM, n_workers=4, seed=0,
                         staleness_threshold=1000000)
svc = ParamServerService(store)
admin = PSClient(svc.address, ROW_DIM)
admin.preload_arrays(keys, rows)
srv = serve.PredictionServer(
    serve.ServingModel("fm", {}, row_leaves=serve.fm_ps_row_leaves(K),
                       row_dim=ROW_DIM, device="cpu"),
    ps=PSClient(svc.address, ROW_DIM), max_batch=16, max_wait_us=100,
    queue_cap=256, deadline_ms=5000, cache_capacity=4096, device="cpu")
sub = online.FreshnessSubscriber(
    srv, [svc.address], ROW_DIM, slo_s=%(slo)f, hard_slo_factor=2.0,
    poll_ms=400).start()
wparams = widedeep.init(torch.Generator().manual_seed(7), F, 3, 4)
wd_model = serve.ServingModel("widedeep", wparams, device="cpu")
wd_srv = serve.PredictionServer(wd_model, max_batch=16, max_wait_us=100,
                                queue_cap=256, deadline_ms=5000,
                                device="cpu")
rrng = np.random.default_rng(1)
replay = [{
    "fids": rrng.integers(1, F, size=(4, 3)).astype(np.int32),
    "vals": np.ones((4, 3), np.float32),
    "rep_fids": rrng.integers(1, F, size=(4, 3)).astype(np.int32),
    "rep_mask": np.ones((4, 3), np.float32),
} for _ in range(2)]
swapper = online.ModelSwapper(wd_model, replay, tolerance=5e-3,
                              registry=wd_srv.registry)
swapper.watch(%(export_dir)r, poll_s=0.1)
ops = exporter.install(0)
print("ADDR", svc.address[1], srv.address[1], wd_srv.address[1],
      ops.address[1], flush=True)
sys.stdin.read()
swapper.stop_watch(); sub.stop()
srv.close(); wd_srv.close(); admin.close(); svc.close()
"""

TRAINER_SCRIPT = """
import sys
import time
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
from lightctr_tpu_torch import online
from lightctr_tpu_torch.data.streaming import iter_libffm_batches
from lightctr_tpu_torch.dist.ps_server import PSClient

ps = PSClient(("127.0.0.1", %(ps_port)d), %(ROW_DIM)d)
tr = online.OnlineTrainer(ps, "fm", %(K)d, worker_id=0, device="cpu")


def paced(stream):
    # a batch every 20 ms at most: the loop never stops, but leaves the
    # cores to the suite running beside it
    for mb in stream:
        time.sleep(0.02)
        yield mb


print("READY", flush=True)
tr.run(paced(iter_libffm_batches(%(train)r, 64, 4, loop=True)))
"""


def test_child_scripts_import_no_jax():
    fill = {"root": REPO_ROOT, "F": F, "K": K, "ROW_DIM": ROW_DIM,
            "slo": 1.0, "export_dir": "x", "ps_port": 1, "train": "x"}
    for script in (SERVER_SCRIPT, TRAINER_SCRIPT):
        tree = ast.parse(textwrap.dedent(script) % fill)
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)}
        assert not roots & {"jax", "jaxlib", "optax", "lightctr_tpu"}


def _readline(proc, timeout_s, what):
    """One stdout line of ``proc``, or fail after ``timeout_s``."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout_s):
            raise AssertionError(f"timed out waiting for {what}")
    finally:
        sel.close()
    return proc.stdout.readline()


def test_two_process_online_acceptance(tmp_path, rng):
    """A trainer PROCESS churns hot keys through the PS while a serving
    process scores from the same live rows, and this process checks:

      1. after SIGSTOPping the trainer, the served scores equal the
         forward computed from rows pulled straight off the PS, within
         the freshness budget;
      2. ``/healthz`` DEGRADES while the trainer stays stopped and
         RECOVERS after SIGCONT;
      3. a corrupted dense export is REFUSED by the shadow gate while a
         faithful one swaps in.
    """
    export_dir = str(tmp_path / "exports")
    os.makedirs(export_dir)
    train = str(tmp_path / "train.ffm")
    _write_fm_stream(rng=np.random.default_rng(2), path=train, rows=2048)
    slo_s = 1.5
    # one thread a child: the trainer loops flat out, and the suite runs
    # beside it
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    server = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(SERVER_SCRIPT) % {
            "root": REPO_ROOT, "F": F, "K": K, "ROW_DIM": ROW_DIM,
            "slo": slo_s, "export_dir": export_dir}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
    trainer = None
    cli = wd_cli = admin = None
    try:
        line = _readline(server, 60, "the server's addresses").split()
        assert line and line[0] == "ADDR", line
        ps_port, serve_port, wd_port, ops_port = map(int, line[1:5])
        trainer = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(TRAINER_SCRIPT) % {
                "root": REPO_ROOT, "ps_port": ps_port, "K": K,
                "ROW_DIM": ROW_DIM, "train": train}],
            stdout=subprocess.PIPE, text=True, env=env)
        assert _readline(trainer, 60, "the trainer").split() == ["READY"]
        cli = serve.PredictClient(("127.0.0.1", serve_port))
        probe = _batch(np.random.default_rng(3), n=4)
        s0 = cli.predict(probe)
        _wait(lambda: np.abs(cli.predict(probe) - s0).max() > 1e-3,
              60, "served scores to reflect training")

        # 1) freeze the trainer: the served scores converge onto the
        # forward of the live rows within the freshness budget (the rows
        # pulled again each round: a push already on the wire when the
        # trainer stopped may still land)
        os.kill(trainer.pid, signal.SIGSTOP)
        admin = PSClient(("127.0.0.1", ps_port), ROW_DIM)
        uids = np.unique(probe["fids"].reshape(-1).astype(np.int64))

        def live_forward():
            _, live_rows = admin.pull_arrays(uids, worker_epoch=0,
                                             worker_id=None, create=False)
            trained = {"w": np.zeros(F, np.float32),
                       "v": np.zeros((F, K), np.float32)}
            trained["w"][uids] = live_rows[:, 0]
            trained["v"][uids] = live_rows[:, 1:]
            return _fm_forward(trained, probe)

        deadline = time.monotonic() + slo_s + 3.0
        got = expected = None
        while time.monotonic() < deadline:
            expected = live_forward()
            got = cli.predict(probe)
            if np.abs(got - expected).max() < 2e-3:
                break
            time.sleep(0.1)
        np.testing.assert_allclose(got, expected, atol=2e-3)

        # 2) the freshness SLO degrades, then recovers after SIGCONT
        def fresh_status():
            # an unhealthy verdict answers 503 with the same body
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{ops_port}/healthz",
                        timeout=5) as r:
                    body = r.read()
            except urllib.error.HTTPError as e:
                body = e.read()
            comps = json.loads(body)["components"]
            det = ((comps.get(f"serve_{serve_port}") or {}).get(
                "detectors") or {}).get("freshness_slo")
            return (det or {}).get("status")

        _wait(lambda: fresh_status() in (health_mod.DEGRADED,
                                         health_mod.UNHEALTHY),
              slo_s * 4 + 15, "/healthz to degrade on freshness")
        os.kill(trainer.pid, signal.SIGCONT)
        _wait(lambda: fresh_status() == health_mod.OK, 30,
              "/healthz to recover after SIGCONT")

        # 3) the swap gate across the process boundary
        np_params = _wd_params(7, 3, 4)
        corrupt = dict(np_params)
        corrupt["fc1"] = {"w": np_params["fc1"]["w"] + 3.0,
                          "b": np_params["fc1"]["b"]}
        online.publish_export(export_dir, corrupt, model="widedeep",
                              step=1, codec="fp32", device="cpu")
        wd_cli = serve.PredictClient(("127.0.0.1", wd_port))

        def swap_counters():
            c = wd_cli.stats()["telemetry"]["counters"]
            return (c.get("online_swap_attempts_total", 0),
                    c.get("online_swap_accepted_total", 0),
                    c.get(obs.labeled("online_swap_refused_total",
                                      reason="parity"), 0))

        _wait(lambda: swap_counters()[2] >= 1, 20,
              "corrupted export refused by the shadow gate")
        assert swap_counters()[1] == 0
        online.publish_export(export_dir, np_params, model="widedeep",
                              step=2, codec="fp32", device="cpu")
        _wait(lambda: swap_counters()[1] == 1, 20, "faithful export swap")
        scores = wd_cli.predict({
            "fids": rng.integers(1, F, size=(2, 3)).astype(np.int32),
            "vals": np.ones((2, 3), np.float32),
            "rep_fids": rng.integers(1, F, size=(2, 3)).astype(np.int32),
            "rep_mask": np.ones((2, 3), np.float32),
        })
        assert np.isfinite(scores).all() and scores.shape == (2,)
    finally:
        for c in (cli, wd_cli, admin):
            if c is not None:
                c.close()
        if trainer is not None:
            try:
                os.kill(trainer.pid, signal.SIGCONT)
            except OSError:
                pass
            trainer.kill()
            trainer.wait(timeout=10)
        if server.poll() is None:
            try:
                server.stdin.close()
                server.wait(timeout=15)
            except (OSError, subprocess.TimeoutExpired):
                server.kill()
                server.wait(timeout=10)
