"""The port's resource & saturation plane on the CPU
(``tests/test_resources.py``'s cases on ``lightctr_tpu_torch.obs.
resources``), with the JAX module beside it where both judge the same
input: the series lint, the three detectors fed the same signals, the
compile tracker over input signatures (``TrackedCallable``) and the kernel
builds ``ops/sparse_kernels`` reports, ``track_jit``, the queues and event
ring, the memory sampler, ``resource_rollup`` on the same member payloads,
the trainers' arming (ctor and env; an armed run trains bit for bit as an
unarmed one in every single-device step variant), the storm acceptance
(a shape-churning callable trips ``/healthz`` and lands a flight bundle
while a pow2-padded control stays ok), the serve queue saturating before
it sheds, and ``metrics_report --resources`` on the port's dump.

The tiered store's prefetch queue and memory source run on the port's
store in both modes; the reduce shard's memory source waits for its
module's port (ROADMAP §A.8)."""

import ast
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from lightctr_tpu.obs import resources as jresources
from lightctr_tpu_torch import obs, serve
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.obs import events, exporter, flight, health, resources
from lightctr_tpu_torch.ops import sparse_kernels as sk

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_ROOT = REPO_ROOT / "lightctr_tpu_torch"
F, K = 256, 8
TABLES = {"w": ["fids"], "v": ["fids"]}


def _monitor(**kw):
    kw.setdefault("registry", obs.MetricsRegistry())
    kw.setdefault("flight_min_interval_s", 0.0)
    return health.HealthMonitor(**kw)


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    try:
        return code, json.loads(body)
    except json.JSONDecodeError:
        return code, body.decode()


def _toy_trainer(d=32, **kw):
    params = {"w": np.zeros((d,), np.float32)}
    return CTRTrainer(params, lambda p, b: b["x"] @ p["w"],
                      TrainConfig(learning_rate=0.1), device="cpu", **kw)


# -- series lint ---------------------------------------------------------------


def _emitted(path: Path, prefix: str) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
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
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value.startswith(prefix):
            out.add(arg.value)
    return out


def test_every_resource_series_is_declared_and_emitted():
    emitted = _emitted(PORT_ROOT / "obs" / "resources.py", "resource_")
    declared = set(resources.RESOURCE_SERIES)
    assert emitted, "no resource_* emissions found (lint is miswired)"
    assert emitted == declared, (emitted ^ declared)
    assert len(resources.RESOURCE_SERIES) == len(declared)
    assert resources.RESOURCE_SERIES == jresources.RESOURCE_SERIES


def test_every_name_of_the_jax_module_is_ported():
    jnames = {n for n in vars(jresources) if not n.startswith("__")}
    tnames = {n for n in vars(resources) if not n.startswith("__")}
    assert jnames - tnames == set()


# -- detectors, against the JAX ones on the same signals ---------------------

STORM = [(3, 3, 3, {}), (10, 1, 1, {}), (20, 16, 2, {}),
         (40, 8, 6, {"a": 1, "b": 5}), (60, 8, 9, {})]
QUEUE = [("tiny", 1, 1), ("q", 10, 10), ("q", 9, 10), ("q", 2, 10),
         ("q", 9, 10), ("q", 9, 10), ("q", 9, 10), ("q", 10, 10),
         ("q", 10, 10), ("q", 10, 10), ("other", 1, 10)]
MEMORY = [({"host_rss": 10 ** 9}, {}),
          ({"host_rss": 50, "tiered_hot": 10},
           {"host_rss": 100, "tiered_hot": 100}),
          ({"host_rss": 50, "tiered_hot": 90},
           {"host_rss": 100, "tiered_hot": 100}),
          ({"host_rss": 99}, {"host_rss": 100})]


def _both(name, kw):
    return (getattr(resources, name)(**kw), getattr(jresources, name)(**kw))


def test_recompile_storm_detector_matches_jax_and_bands():
    t, j = _both("RecompileStormDetector",
                 dict(warmup_steps=4, max_per_step=0.5, hard_factor=2.0,
                      min_steps=2))
    got = []
    for total, steps, compiles, per_fn in STORM:
        sig = {"recompile": {"total_steps": total, "steps": steps,
                             "compiles": compiles, "per_fn": per_fn}}
        a, b = t.check(sig), j.check(sig)
        assert a == b
        got.append(a[0])
    assert got == [health.OK, health.OK, health.OK, health.DEGRADED,
                   health.UNHEALTHY]


def test_queue_saturation_detector_matches_jax_and_sustains():
    t, j = _both("QueueSaturationDetector",
                 dict(degraded_fill=0.8, unhealthy_fill=0.95, sustain=3,
                      min_capacity=2))
    got = []
    for q, depth, cap in QUEUE:
        sig = {"queue_saturation": {"queue": q, "depth": depth,
                                    "capacity": cap}}
        a, b = t.check(sig), j.check(sig)
        assert a == b
        got.append(a[0])
    assert got[6] == health.DEGRADED and got[-1] == health.UNHEALTHY
    assert got[:6] == [health.OK] * 6


def test_memory_pressure_detector_matches_jax_and_judges_budgets():
    t, j = _both("MemoryPressureDetector", dict(degraded=0.85,
                                                unhealthy=0.95))
    got = []
    for sizes, budgets in MEMORY:
        sig = {"memory_pressure": {"bytes": sizes, "budgets": budgets}}
        a, b = t.check(sig), j.check(sig)
        assert a == b
        got.append(a)
    assert got[0][1]["skipped"] == "no budgets"
    assert got[2][0] == health.DEGRADED
    assert got[2][1]["worst_kind"] == "tiered_hot"
    assert got[3][0] == health.UNHEALTHY and got[3][1]["fraction"] == 0.99


def test_resource_detectors_are_known():
    for cls in resources.RESOURCE_DETECTORS:
        assert health.KNOWN_DETECTORS[cls.name] is cls


# -- the compile tracker -------------------------------------------------------


def test_tracked_callable_counts_input_signatures():
    f = resources.TrackedCallable(lambda x, y=None: x * 2)
    assert f._cache_size() == 0
    f(torch.zeros(3))
    f(torch.ones(3))                       # same signature
    assert f._cache_size() == 1
    f(torch.zeros(4))                      # a new shape
    f(torch.zeros(4, dtype=torch.float64))  # a new dtype
    f(np.zeros(4, np.float32))             # an array
    f(torch.zeros(4), y={"a": torch.zeros(2)})
    assert f._cache_size() == 5
    assert float(f(torch.tensor(3.0))) == 6.0


def test_compile_tracker_counts_signature_growth_and_feeds_monitor():
    reg = obs.MetricsRegistry()
    hm = _monitor(component="ct_unit_t", trip_after=1, recover_after=1)
    tr = resources.CompileTracker(
        component="ct_unit_t", registry=reg, monitor=hm, poll_every=0,
        detector_overrides={"recompile_storm": {
            "warmup_steps": 0, "max_per_step": 0.5, "min_steps": 1}})
    f = resources.TrackedCallable(lambda x: x * 2.0)
    tr.track("f", f)
    try:
        with obs.override(True):
            for i in range(3):  # a NEW shape every step: the storm
                f(torch.zeros(i + 1))
                tr.note_step()
            # a kernel library load reported by the kernel registry
            sk._notify_build(0.25)
            sig = tr.poll()
        assert sig["per_fn"]["f"] == 3 and sig["steps"] == 3
        assert sig["backend"] == 1
        snap = reg.snapshot()
        assert snap["counters"][obs.labeled(
            "resource_jit_compiles_total", fn="f")] == 3
        assert snap["gauges"][obs.labeled(
            "resource_jit_cache_entries", fn="f")] == 3
        assert snap["counters"]["resource_backend_compiles_total"] == 1
        assert snap["histograms"]["resource_compile_seconds"]["count"] == 1
        v = hm.verdict()
        assert v["detectors"]["recompile_storm"]["status"] == health.DEGRADED
        assert "resources:ct_unit_t" in flight.registered_registries()
        assert "ct_unit_t" in resources.resource_payload()["resources"]
        s = tr.snapshot()
        assert s["resources"] is True and s["fns"]["f"]["compiles"] == 3
        assert s["backend_compiles"] == 1 and s["compile_seconds"] == 0.25
    finally:
        tr.close()
        hm.close()
    assert "resources:ct_unit_t" not in flight.registered_registries()
    assert "ct_unit_t" not in resources.resource_payload()["resources"]


def test_kernel_loads_report_build_seconds(monkeypatch, tmp_path):
    """``sk.load`` reports each library it loads (nvcc seconds, when the
    build ran in this process, plus the ctypes load) to the listeners."""
    seen = []
    listener = lambda event, seconds: seen.append((event, seconds))  # noqa
    sk.add_build_listener(listener)
    lib = object()
    monkeypatch.setattr(sk, "compile_source",
                        lambda source: str(tmp_path / "x.so"))
    monkeypatch.setattr(sk.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setitem(sk.KERNELS, "gather_rows",
                        sk.KERNELS["gather_rows"]._replace(
                            bind=lambda lib: None))
    monkeypatch.setattr(sk, "_libs", {})
    sk._pending_build_s[str(tmp_path / "x.so")] = 1.5
    try:
        assert sk.load("gather_rows") is lib
    finally:
        sk.remove_build_listener(listener)
    assert len(seen) == 1 and seen[0][0] == "kernel_build"
    assert seen[0][1] >= 1.5


def test_track_jit_wraps_and_registers_with_the_process_tracker():
    g = resources.track_jit("unit_g_t", lambda x: x + 1)
    try:
        assert isinstance(g, resources.TrackedCallable)
        assert float(g(torch.tensor(1.0))) == 2.0
        assert g._cache_size() == 1
        snap = resources.default_tracker().snapshot()
        assert "unit_g_t" in snap["fns"]
        # a callable that already counts is registered as it is
        h = resources.TrackedCallable(lambda x: x)
        assert resources.track_jit("unit_h_t", h) is h
    finally:
        resources.default_tracker().untrack("unit_g_t")
        resources.default_tracker().untrack("unit_h_t")


# -- instrumented queues + event ring ----------------------------------------


def test_instrumented_queue_series_and_saturation_feed():
    reg = obs.MetricsRegistry()
    hm = _monitor(component="iq_unit_t", trip_after=1, recover_after=1)
    q = resources.InstrumentedQueue(
        "unit_q_t", capacity=4, registry=reg, monitor=hm,
        detector_overrides={"queue_saturation": {
            "degraded_fill": 0.7, "sustain": 2}})
    try:
        with obs.override(True):
            q.note_enqueue(3)
            q.set_depth(2)
            assert hm.status() == health.OK
            q.set_depth(4)
            q.set_depth(4)
            q.note_wait(0.01)
            q.note_drop()
        assert q.fill() == 1.0
        snap = reg.snapshot()
        lab = lambda n: obs.labeled(n, queue="unit_q_t")  # noqa: E731
        assert snap["gauges"][lab("resource_queue_depth")] == 4
        assert snap["gauges"][lab("resource_queue_capacity")] == 4
        assert snap["counters"][lab("resource_queue_enqueued_total")] == 3
        assert snap["counters"][lab("resource_queue_dropped_total")] == 1
        assert snap["histograms"][lab("resource_queue_wait_seconds")][
            "count"] == 1
        assert hm.verdict()["detectors"]["queue_saturation"]["status"] \
            == health.UNHEALTHY
        assert "queue:unit_q_t" in resources.resource_payload()["resources"]
    finally:
        q.close()
        hm.close()
    assert "queue:unit_q_t" not in resources.resource_payload()["resources"]


def test_event_ring_watch_folds_overwrites_into_drops():
    log = events.EventLog(capacity=4)
    w = resources.EventRingWatch(log=log, name="unit_ring_t",
                                 registry=obs.MetricsRegistry(),
                                 register=False)
    try:
        with obs.override(True):
            for i in range(7):
                log.emit("tick", i=i)
            w.sample()
        p = w.queue.payload()
        assert p["capacity"] == 4 and p["depth"] == len(log.records())
        assert p["dropped"] == log.dropped > 0
    finally:
        w.close()


# -- memory sampler ------------------------------------------------------------


def test_memory_sampler_sources_budgets_and_detector():
    reg = obs.MetricsRegistry()
    hm = _monitor(component="mem_unit_t", trip_after=1, recover_after=1)
    ms = resources.MemorySampler(
        registry=reg, monitor=hm, budgets={"blob": 100.0},
        name="mem_unit_t", register=False)
    ms.add_source("blob", lambda: 96)
    ms.add_source("tiered", lambda: {"hot": 10, "warm": 20})
    ms.add_source("broken", lambda: 1 / 0)
    try:
        with obs.override(True):
            flat = ms.sample()
        assert flat["blob"] == 96 and flat["tiered_hot"] == 10
        assert flat["tiered_warm"] == 20 and flat["host_rss"] > 0
        assert "broken" not in flat
        # no CUDA here: no device kind and no device budget, never a guess
        assert not any(k.startswith("hbm") for k in flat)
        assert resources.device_hbm_bytes() is None
        assert ms.budget_devices(0.9) == {}
        snap = reg.snapshot()
        assert snap["gauges"][obs.labeled(
            "resource_memory_bytes", kind="blob")] == 96
        assert snap["gauges"][obs.labeled(
            "resource_memory_budget_bytes", kind="blob")] == 100
        det = hm.verdict()["detectors"]["memory_pressure"]
        assert det["status"] == health.UNHEALTHY
        assert det["detail"]["worst_kind"] == "blob"
        assert ms.payload()["bytes"]["blob"] == 96
    finally:
        ms.close()
        hm.close()


@pytest.mark.parametrize("device_hot", [False, True])
def test_tiered_store_prefetch_queue_and_memory_source(rng, device_hot):
    from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore

    store = TieredEmbeddingStore(dim=8, hot_rows=16, device_hot=device_hot,
                                 device="cpu")
    try:
        keys = rng.integers(0, 1000, size=32).astype(np.int64)
        with obs.override(True):
            t = store.dispatch_prefetch(keys)
            assert t > 0 and store.prefetch_wait(t, timeout=10.0)
        p = store._pf_iq.payload()
        assert p["enqueued"] >= 1 and p["waits"] >= 1
        snap = store.registry.snapshot()
        assert obs.labeled("resource_queue_capacity",
                           queue="tiered_prefetch") in snap["gauges"]
        mb = store.memory_bytes()
        assert mb["hot"] == 16 * 8 * 8 and "warm" in mb and "cold" in mb
        assert ("device_block" in mb) == device_hot
        # the store is a one-call MemorySampler source
        ms = resources.MemorySampler(registry=obs.MetricsRegistry(),
                                     include_host=False, register=False)
        ms.add_source("tiered", store.memory_bytes)
        with obs.override(True):
            flat = ms.sample()
        assert flat["tiered_hot"] == mb["hot"]
        ms.close()
    finally:
        store.close()


def test_reduce_shard_peak_round_is_a_memory_source():
    """The hierarchical exchange's reduce shard reports its peak round
    bytes as a memory source, as the JAX shard does."""
    from lightctr_tpu.dist.hier import SparseReduceShard as JShard
    from lightctr_tpu_torch.dist.hier import SparseReduceShard

    shard, jshard = SparseReduceShard(n_hosts=1), JShard(n_hosts=1)
    try:
        mb = shard.memory_bytes()
        assert mb == jshard.memory_bytes() == {"peak_round": 0}
        assert mb["peak_round"] == shard.stats()["peak_round_bytes"]
        ms = resources.MemorySampler(registry=obs.MetricsRegistry(),
                                     include_host=False, register=False)
        ms.add_source("shard", shard.memory_bytes)
        with obs.override(True):
            assert ms.sample()["shard_peak_round"] == 0
        ms.close()
    finally:
        shard.close()
        jshard.close()


def test_device_sources_read_the_cuda_allocator(monkeypatch):
    """On a card the sampler's ``hbm_devN`` kinds are the allocator's
    current bytes, and ``budget_devices`` a fraction of each device's
    total memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 1000 * (i + 1)})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (0, 10_000 * (i + 1)))
    assert resources.device_hbm_bytes() == {"dev0": 1000, "dev1": 2000}
    ms = resources.MemorySampler(registry=obs.MetricsRegistry(),
                                 include_host=False, register=False)
    assert ms.budget_devices(0.5) == {"hbm_dev0": 5000.0,
                                      "hbm_dev1": 10000.0}
    with obs.override(True):
        assert ms.sample() == {"hbm_dev0": 1000, "hbm_dev1": 2000}
    ms.close()


# -- cluster rollup ------------------------------------------------------------


def test_resource_rollup_matches_jax_on_the_same_members():
    members = {
        "a": {"snapshot": {
            "gauges": {obs.labeled("resource_queue_depth", queue="q"): 9,
                       obs.labeled("resource_queue_capacity", queue="q"): 10},
            "counters": {obs.labeled("resource_jit_compiles_total",
                                     fn="f"): 2}}},
        "b": {"snapshot": {
            "gauges": {obs.labeled("resource_queue_depth", queue="q"): 1,
                       obs.labeled("resource_queue_capacity", queue="q"): 10},
            "counters": {obs.labeled("resource_jit_compiles_total",
                                     fn="f"): 7}}},
        "quiet": {"snapshot": {"gauges": {"trainer_loss": 0.5},
                               "counters": {}}},
    }
    out = resources.resource_rollup(members)
    assert out == jresources.resource_rollup(members)
    assert out["worst_saturation"] == {"member": "a", "queue": "q",
                                       "fill": 0.9}
    assert out["most_compiles"] == {"member": "b", "compiles": 7}
    assert "quiet" not in out["members"]


# -- trainer integration -------------------------------------------------------


def test_trainer_arms_tracker_by_ctor_and_env(monkeypatch, rng):
    d, n = 32, 64
    batch = {"x": rng.normal(size=(n, d)).astype(np.float32),
             "labels": (rng.random(n) > 0.5).astype(np.float32)}
    monkeypatch.delenv("LIGHTCTR_RESOURCES", raising=False)
    tr = _toy_trainer(d, resources=True)
    assert tr.resources is not None
    try:
        assert {"trainer_step", "trainer_logits"} <= set(
            tr.resources.snapshot()["fns"])
        with obs.override(True):
            for _ in range(3):
                tr.train_step(batch)
            tr.predict_proba(batch)
            sig = tr.resources.poll()
        snap = tr.resources.snapshot()
        assert snap["steps"] == 3
        # one signature over the steps, one for the scorer
        assert snap["fns"]["trainer_step"]["cache_entries"] == 1
        assert snap["fns"]["trainer_logits"]["cache_entries"] == 1
        assert sig["compiles"] == 2
    finally:
        tr.resources.close()
    tr2 = _toy_trainer(d)
    assert tr2.resources is None
    monkeypatch.setenv("LIGHTCTR_RESOURCES", "1")
    tr3 = _toy_trainer(d)
    assert tr3.resources is not None
    tr3.resources.close()
    tr4 = _toy_trainer(d, resources=False)  # an explicit ctor arg wins
    assert tr4.resources is None


def _fm_batches(rng, n=6, b=32, p=5, vocab=64):
    return [{"fids": rng.integers(0, vocab, (b, p)).astype(np.int32),
             "vals": rng.random((b, p)).astype(np.float32),
             "mask": (rng.random((b, p)) > 0.2).astype(np.float32),
             "labels": (rng.random(b) > 0.5).astype(np.float32)}
            for _ in range(n)]


VARIANTS = {
    "plain": (CTRTrainer, {}),
    "fused_adagrad": (CTRTrainer, {"fused_adagrad": True}),
    "quality": (CTRTrainer, {"quality_bins": 16}),
    "sparse": (SparseTableCTRTrainer, {"sparse_tables": TABLES}),
    "sparse_quality": (SparseTableCTRTrainer,
                       {"sparse_tables": TABLES, "quality_bins": 16}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("traced", [False, True])
def test_armed_trainer_equals_unarmed_bit_for_bit(variant, traced, rng):
    """Both planes armed (compile tracker, program catalog, census,
    donation binding) change nothing a step computes: losses, params and
    optimizer state equal the unarmed run's bit for bit, through
    ``train_step`` (plain and span-traced), ``fit`` minibatches and the
    full-batch scan."""
    from lightctr_tpu_torch.obs import trace as obs_trace

    cls, kw = VARIANTS[variant]
    batches = _fm_batches(rng)
    p0 = tfm.init(torch.Generator().manual_seed(3), 64, 4)
    runs = []
    for armed in (False, True):
        tr = cls(p0, tfm.logits, TrainConfig(learning_rate=0.1, seed=1),
                 device="cpu", resources=armed, device_telemetry=armed,
                 **kw)
        with obs.override(True), obs_trace.override_rate(
                1.0 if traced else 0.0):
            losses = [float(tr.train_step(b)) for b in batches]
            full = {k: np.concatenate([b[k] for b in batches])
                    for k in batches[0]}
            losses += list(tr.fit_fullbatch_scan(full, 2))
            losses += tr.fit(full, epochs=1, batch_size=64)["loss"]
        runs.append((losses, tr))
    (l0, t0), (l1, t1) = runs
    assert l0 == l1
    for k in t0.params:
        assert torch.equal(t0.params[k], t1.params[k]), k
    from lightctr_tpu_torch.optim.updaters import tree_leaves
    for a, b in zip(tree_leaves(t0.opt_state), tree_leaves(t1.opt_state)):
        assert torch.equal(a, b)
    # train_step and the fit minibatches record steps; the scan does not
    assert t1.resources.snapshot()["steps"] == len(batches) + 3
    ana = t1.device_catalog.analyze()["trainer_step"]
    assert ana["available"] and ana["flops"] > 0
    for c in (t1.resources, t1.device_catalog, t1.device_census):
        c.close()
    if t1.quality is not None:
        t1.quality.close()
        t0.quality.close()


# -- acceptance: shape churn trips the storm, pow2 padding stays ok -----------


def test_recompile_storm_acceptance_healthz_flight_and_control(tmp_path):
    """A shape-churning callable (the unpadded-batch leak) trips the
    RecompileStormDetector — a real /healthz 503 and an anomaly-time
    flight bundle whose resources section trace_report reads — while a
    pow2-padded control sees its two-rung ladder during warmup and stays
    OK (the JAX acceptance, with the same control)."""
    import tools.trace_report as trace_report

    fdir = tmp_path / "flight"
    srv = exporter.OpsServer(port=0)
    flight.install(str(fdir), catch_signals=False)
    events.configure()
    overrides = {"recompile_storm": {
        "warmup_steps": 2, "max_per_step": 0.3, "hard_factor": 1.5,
        "min_steps": 2}}
    hm_storm = _monitor(component="res_storm_t", trip_after=1,
                        recover_after=100)
    hm_ok = _monitor(component="res_padded_t", trip_after=1,
                     recover_after=100)
    tr_storm = resources.CompileTracker(
        component="res_storm_t", registry=hm_storm.registry,
        monitor=hm_storm, poll_every=0, detector_overrides=overrides)
    tr_ok = resources.CompileTracker(
        component="res_padded_t", registry=hm_ok.registry, monitor=hm_ok,
        poll_every=0, detector_overrides=overrides)
    churn = resources.TrackedCallable(lambda x: (x * x).sum())
    padded = resources.TrackedCallable(lambda x: (x + 1.0).sum())
    tr_storm.track("churn_step", churn)
    tr_ok.track("padded_step", padded)
    try:
        with obs.override(True):
            for i in range(8):
                churn(torch.zeros((3 + i, 2)))
                tr_storm.note_step()
                padded(torch.zeros((8 if i % 2 else 16,)))
                tr_ok.note_step()
                if (i + 1) % 2 == 0:
                    tr_storm.poll()
                    tr_ok.poll()
        v = hm_storm.verdict()
        assert v["status"] == health.UNHEALTHY
        det = v["detectors"]["recompile_storm"]
        assert det["status"] == health.UNHEALTHY
        assert det["detail"]["worst_fn"] == "churn_step"
        assert hm_ok.verdict()["status"] == health.OK
        assert tr_ok.snapshot()["fns"]["padded_step"]["cache_entries"] == 2
        base = f"http://{srv.address[0]}:{srv.address[1]}"
        code, body = _get(base + "/healthz")
        assert code == 503
        assert body["components"]["res_storm_t"]["status"] \
            == health.UNHEALTHY
        assert body["components"]["res_padded_t"]["status"] == health.OK
        code, rz = _get(base + "/resourcez")
        assert code == 200
        assert rz["resources"]["res_storm_t"]["fns"]["churn_step"][
            "compiles"] >= 6
        assert rz["resources"]["res_padded_t"]["fns"]["padded_step"][
            "compiles"] == 2
        bundles = sorted(fdir.glob("flight-*.jsonl"))
        assert bundles, "no anomaly-time flight bundle"
        rep = trace_report.summarize_flight(str(bundles[-1]))
        assert rep["reason"].startswith("health:res_storm_t:")
        assert rep["resources"]["resources:res_storm_t"]["resources"] is True
        assert rep["health"]["res_storm_t"]["status"] == health.UNHEALTHY
    finally:
        tr_storm.close()
        tr_ok.close()
        hm_storm.close()
        hm_ok.close()
        flight.uninstall()
        events.configure()
        srv.close()


def test_online_step_width_leak_is_a_storm(rng):
    """The online trainer's step is tracked under its JAX name: the
    padded unique-row block keeps one signature over steps."""
    from lightctr_tpu_torch import online
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

    store = AsyncParamServer(dim=1 + K, n_workers=1, seed=0)
    svc = ParamServerService(store)
    ps = PSClient(svc.address, 1 + K)
    try:
        tr = online.OnlineTrainer(ps, "fm", K, registry=obs.MetricsRegistry(),
                                  device="cpu")
        for i in range(4):
            tr.step({"fids": rng.integers(1, F, (16, 4)).astype(np.int32),
                     "vals": np.ones((16, 4), np.float32),
                     "mask": np.ones((16, 4), np.float32),
                     "labels": (rng.random(16) > .5).astype(np.float32)})
        snap = resources.default_tracker().snapshot()["fns"]
        assert tr._grads_fn._cache_size() == 1
        assert "online_grads_fm" in snap
    finally:
        ps.close()
        svc.close()


# -- acceptance: serve saturation degrades BEFORE shedding -------------------


def test_serve_queue_saturation_trips_before_shed(rng):
    params = tfm.init(torch.Generator().manual_seed(5), F, K)
    hm = _monitor(component="serve_sat_t", trip_after=1, recover_after=100)
    hm.add_detector(resources.QueueSaturationDetector(
        degraded_fill=0.4, unhealthy_fill=2.0, sustain=2),
        recover_after=100)
    srv = serve.PredictionServer(
        serve.ServingModel("fm", params, device="cpu"), max_batch=4,
        max_wait_us=100, queue_cap=32, deadline_ms=20000,
        score_delay_s=0.2, health=hm, device="cpu")
    ops = exporter.OpsServer(port=0)

    def _batch(r, n):
        return {"fids": r.integers(1, F, size=(n, 4)).astype(np.int32),
                "vals": np.ones((n, 4), np.float32)}

    try:
        with obs.override(True):
            warm = serve.PredictClient(srv.address)
            warm.predict(_batch(rng, 1))
            warm.close()

            def one(i):
                cli = serve.PredictClient(srv.address)
                try:
                    cli.predict(_batch(np.random.default_rng(i), 2))
                finally:
                    cli.close()

            ts = [threading.Thread(target=one, args=(i,)) for i in range(12)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        det = hm.verdict()["detectors"]["queue_saturation"]
        assert det["status"] == health.DEGRADED
        assert det["transitions"] >= 1
        assert det["detail"]["queue"] == f"{srv._flight_name}_queue"
        counters = srv.registry.snapshot()["counters"]
        assert not any(k.startswith("serve_shed") for k in counters)
        assert counters[obs.labeled(
            "resource_queue_enqueued_total",
            queue=f"{srv._flight_name}_queue")] >= 25
        code, rz = _get(f"http://{ops.address[0]}:{ops.address[1]}"
                        "/resourcez")
        assert code == 200
        assert f"queue:{srv._flight_name}_queue" in rz["resources"]
        # the scorer ladders are on the process tracker under JAX names
        fns = resources.default_tracker().snapshot()["fns"]
        assert "serve_score_local_fm" in fns
    finally:
        srv.close()
        ops.close()
        hm.close()


# -- report tooling ------------------------------------------------------------


def test_metrics_report_resources_on_the_ports_dump(tmp_path, capsys):
    import tools.metrics_report as metrics_report

    reg = obs.MetricsRegistry()
    with obs.override(True):
        tr = resources.CompileTracker(component="rep_t", registry=reg,
                                      poll_every=0)
        f = resources.TrackedCallable(lambda x: x - 1.0)
        tr.track("rep_fn", f)
        for i in range(2):
            f(torch.zeros(i + 2))
            tr.note_step()
        sk._notify_build(0.5)
        sk._notify_build(0.25)
        tr.poll()
        q = resources.InstrumentedQueue("rep_q_t", capacity=8, registry=reg,
                                        register=False)
        q.set_depth(6)
        q.note_enqueue(10)
        q.note_drop(1)
        q.note_wait(0.004)
        ms = resources.MemorySampler(registry=reg, budgets={"blob": 200.0},
                                     include_host=False, register=False)
        ms.add_source("blob", lambda: 150)
        ms.sample()
    tr.close()
    ms.close()
    snap = reg.snapshot()
    rep = metrics_report.summarize_resources(snap)
    assert rep["jit"]["fns"]["rep_fn"] == {"compiles": 2,
                                           "cache_entries": 2}
    assert rep["jit"]["backend_compiles"] == 2
    assert rep["queues"]["rep_q_t"]["fill"] == 0.75
    assert rep["queues"]["rep_q_t"]["dropped"] == 1
    assert rep["fullest_queue"] == {"queue": "rep_q_t", "fill": 0.75}
    assert rep["memory"]["blob"] == {"bytes": 150, "budget_bytes": 200,
                                     "fraction": 0.75}
    path = tmp_path / "snap.json"
    path.write_text(json.dumps({"telemetry": snap}))
    assert metrics_report.main(["--resources", str(path)]) == 0
    out = capsys.readouterr().out
    assert '"fullest_queue"' in out and '"rep_fn"' in out
