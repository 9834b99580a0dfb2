"""The port's device & program plane on the CPU (``tests/test_device.py``'s
cases on ``lightctr_tpu_torch.obs.device``), with the JAX module beside it
where both judge the same input: the series lint both ways, the detectors
fed the same signals, the program catalog's honesty (recorded from the
first armed call, nothing on the CPU against a made-up peak, a program
never run armed "unavailable") and its roofline against an explicit peak,
the hand-written kernels' costs in a trainer step's analysis, the census
(buckets, a shared storage counted once, ``untagged`` unavailable without
an allocator), ``hbm_pressure`` into a real ``/healthz`` 503 and a flight
bundle, in-place verification (B5's apply clean, a copying control a
miss, the wrapper the identity when dark), ``POST /profilez`` (arm, 409
busy — also against another ``torch.profiler`` session — and 429), the
auto-capture, the trainers' arming by ctor and env, ``device_rollup`` on
the same member payloads as the JAX rollup, the H100 peaks, and the port's
``/devicez`` payload through the repo's ``tools/device_report.py`` and
``metrics_report --device``."""

import json
import os
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from lightctr_tpu.obs import device as jdevice
from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.obs import device, events, exporter, flight, health
from lightctr_tpu_torch.ops import sparse_kernels as sk
from lightctr_tpu_torch.serve.model import ServingModel

from test_torch_resources import _emitted

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_ROOT = REPO_ROOT / "lightctr_tpu_torch"
F, K = 256, 8


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


def _post(url, timeout=10.0):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    return code, json.loads(body)


def _toy_trainer(d=32, **kw):
    params = {"w": np.zeros((d,), np.float32)}
    return CTRTrainer(params, lambda p, b: b["x"] @ p["w"],
                      TrainConfig(learning_rate=0.1), device="cpu", **kw)


def _toy_batch(rng, d=32, n=64):
    return {"x": rng.normal(size=(n, d)).astype(np.float32),
            "labels": (rng.random(n) > 0.5).astype(np.float32)}


# -- series lint ---------------------------------------------------------------


def test_every_device_series_is_declared_and_emitted():
    emitted = _emitted(PORT_ROOT / "obs" / "device.py", "device_")
    declared = set(device.DEVICE_SERIES)
    assert emitted, "no device_* emissions found (lint is miswired)"
    assert emitted == declared, (emitted ^ declared)
    assert len(device.DEVICE_SERIES) == len(declared)
    assert device.DEVICE_SERIES == jdevice.DEVICE_SERIES


def test_every_name_of_the_jax_module_is_ported():
    jnames = {n for n in vars(jdevice) if not n.startswith("__")}
    tnames = {n for n in vars(device) if not n.startswith("__")}
    # the JAX module's lowering helpers have nothing to lower here
    assert jnames - tnames == {"_tree_leaves", "_cost_dict", "_memory_dict",
                               "_MEMORY_FIELDS"}


# -- detectors -------------------------------------------------------------------


def test_device_detectors_are_known():
    assert health.KNOWN_DETECTORS["hbm_pressure"] \
        is device.HbmPressureDetector
    assert health.KNOWN_DETECTORS["donation_miss"] \
        is device.DonationMissDetector


HBM = [({"embed": 10 ** 12}, {}),
       ({"embed": 10, "total": 10}, {"embed": 100}),
       ({"embed": 90, "total": 95}, {"embed": 100}),
       ({"embed": 99}, {"embed": 100})]
DONATION = [("p", False), ("p", True), ("q", True), ("p", False),
            ("q", False)]


def test_hbm_pressure_detector_matches_jax():
    t = device.HbmPressureDetector(degraded=0.85, unhealthy=0.95)
    j = jdevice.HbmPressureDetector(degraded=0.85, unhealthy=0.95)
    got = []
    for sizes, budgets in HBM:
        sig = {"hbm_pressure": {"bytes": sizes, "budgets": budgets}}
        a = t.check(sig)
        assert a == j.check(sig)
        got.append(a)
    assert got[0][1]["skipped"] == "no budgets"
    assert [g[0] for g in got] == [health.OK, health.OK, health.DEGRADED,
                                   health.UNHEALTHY]
    assert got[3][1]["fraction"] == 0.99


def test_donation_miss_detector_matches_jax_per_program():
    t, j = device.DonationMissDetector(), jdevice.DonationMissDetector()
    got = []
    for prog, miss in DONATION:
        sig = {"donation": {"program": prog, "miss": miss}}
        a = t.check(sig)
        assert a == j.check(sig)
        got.append(a)
    assert [g[0] for g in got] == [health.OK, health.DEGRADED,
                                   health.DEGRADED, health.DEGRADED,
                                   health.OK]
    assert got[2][1]["programs"] == ["p", "q"]
    assert got[3][1]["programs"] == ["q"]


# -- program catalog -------------------------------------------------------------


def test_peak_specs_are_h100_fp32_and_kept_apart():
    sxm = device.peak_spec("NVIDIA H100 80GB HBM3")
    assert sxm == (67e12, 3.35e12)
    assert device.peak_spec("NVIDIA H100 PCIe") == (51e12, 2.0e12)
    assert device.peak_spec("NVIDIA H100 NVL") == (60e12, 3.9e12)
    assert device.peak_spec(None) is None
    assert device.peak_spec("cpu") is None
    assert device.peak_spec("TPU v5 lite") is None  # no TPU rows here
    assert "fp32" in device.PEAK_PRECISION


def test_program_catalog_records_the_first_call_and_reports_honestly():
    """run() records the analysis from the first call itself (no replay);
    a registered program never run armed is unavailable; the CPU has no
    peak spec, so utilization is None — unavailable, never fake."""
    reg = obs.MetricsRegistry()
    cat = device.ProgramCatalog(component="cat_unit_t", registry=reg,
                                poll_every=1, device="cpu")
    calls = []

    def f(a, b):
        calls.append(1)
        return a @ b

    x = torch.zeros((64, 64))
    try:
        with obs.override(True):
            out = cat.run("mm", f, (x, x))
            assert out.shape == (64, 64) and len(calls) == 1
            cat.run("mm", f, (x, x))  # later calls: the plain call
            assert len(calls) == 2
            cat.note_step(0.01, "mm")
            ana = cat.analyze()["mm"]
            assert ana["available"] is True
            assert ana["flops"] == 2 * 64 ** 3  # the matmul FLOP count
            assert ana["bytes_accessed"] == 3 * 64 * 64 * 4
            assert ana["intensity"] > 0
            mem = ana["memory"]
            assert mem["argument"] == 64 * 64 * 4  # one storage, twice
            assert mem["output"] == 64 * 64 * 4 and mem["alias"] == 0
            assert "temp" not in mem  # no allocator statistics on the CPU
            rec = cat.snapshot()["programs"]["mm"]
            assert rec["analyzed"] is True and rec["steps"] == 1
            assert rec["achieved_flops_per_s"] > 0
            assert cat.peak is None and rec["utilization"] is None
            rs = reg.snapshot()
            assert rs["gauges"][obs.labeled(
                "device_program_flops", program="mm")] == ana["flops"]
            assert obs.labeled("device_program_utilization", program="mm") \
                not in rs["gauges"]
            assert rs["histograms"][obs.labeled(
                "device_program_time_seconds", program="mm")]["count"] == 1
            cat.offer("host_fn", lambda: None)
            out = cat.analyze("host_fn")["host_fn"]
            assert out["available"] is False
            assert "never called" in out["unavailable"]
            cat.offer("not_callable", 3)
            assert cat.analyze("not_callable")["not_callable"][
                "unavailable"] == "not callable"
            assert "device:cat_unit_t" in flight.registered_registries()
            assert "cat_unit_t" in device.device_payload()["device"]
            assert "/devicez" in exporter.json_routes()
    finally:
        cat.close()
    assert "device:cat_unit_t" not in flight.registered_registries()


def test_program_catalog_roofline_against_explicit_peak():
    reg = obs.MetricsRegistry()
    cat = device.ProgramCatalog(component="cat_peak_t", registry=reg,
                                peak_flops=1e12, peak_hbm_bps=1e11,
                                device="cpu")
    x = torch.zeros((32, 32))
    try:
        with obs.override(True):
            cat.run("mm", lambda a, b: a @ b, (x, x))
            cat.note_step(0.001, "mm")
            ana = cat.analyze()["mm"]
            rec = cat.snapshot()["programs"]["mm"]
            cat.payload()
        assert abs(rec["utilization"] - (ana["flops"] / 0.001) / 1e12) < 1e-9
        assert abs(rec["bandwidth_utilization"]
                   - (ana["bytes_accessed"] / 0.001) / 1e11) < 1e-9
        assert reg.snapshot()["gauges"][obs.labeled(
            "device_program_utilization", program="mm")] == \
            rec["utilization"]
    finally:
        cat.close()


def test_trainer_step_analysis_carries_the_kernels_costs(rng):
    """A sparse trainer step's analysis lists each hand-written kernel it
    dispatched with the bytes ``sk.kernel_cost`` counts for its inputs,
    and the library ops a plain version runs are not counted again."""
    p0 = tfm.init(torch.Generator().manual_seed(2), 64, 4)
    tr = SparseTableCTRTrainer(
        p0, tfm.logits, TrainConfig(learning_rate=0.1),
        sparse_tables={"w": ["fids"], "v": ["fids"]}, device="cpu",
        device_telemetry=True)
    b = {"fids": rng.integers(0, 64, (16, 3)).astype(np.int32),
         "vals": np.ones((16, 3), np.float32),
         "mask": np.ones((16, 3), np.float32),
         "labels": (rng.random(16) > .5).astype(np.float32)}
    try:
        with obs.override(True):
            tr.train_step(b)
        ana = tr.device_catalog.analyze()["trainer_step"]
        ks = ana["kernels"]
        assert ks["dedup_ids"] == {"calls": 1, "bytes": 48 * 12,
                                   "flops": 0.0}
        assert ks["merge_apply"]["calls"] == 2  # w and v
        assert ks["merge_rows"]["calls"] == 2   # the lookups' backward
        # merge_apply's apply mode: real rows read+written 4x, grads, uids
        u = np.unique(b["fids"])
        real = len(u)
        assert ks["merge_apply"]["bytes"] == (
            (real * 4 * 4 + 48 * 4 + real * 4)
            + (real * 4 * 4 * 4 + 48 * 4 + real * 4 * 4))
        assert ana["bytes_accessed"] == ana["library"]["bytes"] + sum(
            k["bytes"] for k in ks.values())
        assert ana["memory"]["alias"] > 0  # the tables updated in place
    finally:
        tr.device_catalog.close()
        tr.device_census.close()


def test_kernel_cost_recorder_is_one_at_a_time():
    with sk.record_costs(lambda *a: None):
        with pytest.raises(RuntimeError, match="already set"):
            with sk.record_costs(lambda *a: None):
                pass
    # dark: the dispatch hands back the implementation itself
    assert sk.dispatch("gather_rows", torch.device("cpu")) \
        is sk.KERNELS["gather_rows"].plain


# -- live-buffer census ------------------------------------------------------------


def test_census_buckets_by_tag_counts_shared_storage_once():
    reg = obs.MetricsRegistry()
    cen = device.LiveBufferCensus(registry=reg, name="cen_unit_t",
                                  sample_every=2, register=False)
    w = torch.ones((128, 16))             # 8 KiB
    view = w[:, :4]                       # a view of the same storage
    other = torch.zeros(10, dtype=torch.int32)
    cen.register_tag("weights", lambda: {"w": w, "view": view})
    cen.register_tag("ids", lambda: [other, w])  # w already claimed
    try:
        with obs.override(True):
            cen.maybe_sample()
            assert cen.snapshot().get("available") is None
            cen.maybe_sample()
        last = cen.snapshot()
        assert last["available"] is True and last["census"] == "cen_unit_t"
        assert last["tags"]["weights"] == {"bytes": 128 * 16 * 4,
                                           "count": 1}
        assert last["tags"]["ids"] == {"bytes": 40, "count": 1}
        # no allocator total on the CPU: untagged is not invented
        assert last["untagged_bytes"] == "unavailable"
        assert last["total_scope"] == "tagged"
        assert last["total_bytes"] == 128 * 16 * 4 + 40
        rs = reg.snapshot()
        assert rs["gauges"][obs.labeled(
            "device_live_buffer_bytes", tag="weights")] == 128 * 16 * 4
        assert obs.labeled("device_live_buffer_bytes", tag="untagged") \
            not in rs["gauges"]
        assert obs.labeled("device_live_buffer_bytes", tag="total") \
            in rs["gauges"]
    finally:
        cen.close()


def test_census_untagged_is_the_allocators_remainder(monkeypatch):
    monkeypatch.setattr(device, "_allocated_bytes", lambda: 10_000)
    cen = device.LiveBufferCensus(registry=obs.MetricsRegistry(),
                                  name="cen_alloc_t", register=False)
    w = torch.ones(100)
    cen.register_tag("w", lambda: w)
    with obs.override(True):
        s = cen.sample()
    # the tagged tensor lives on the host here, so the device allocator's
    # bytes are all untagged
    assert s["untagged_bytes"] == 10_000 and s["total_scope"] == "allocator"
    assert s["total_bytes"] == 10_000 + 400
    cen.close()


def test_hbm_pressure_acceptance_healthz_flight_and_trace_report(tmp_path):
    import tools.trace_report as trace_report

    fdir = tmp_path / "flight"
    srv = exporter.OpsServer(port=0)
    flight.install(str(fdir), catch_signals=False)
    events.configure()
    hm = _monitor(component="dev_hbm_t", trip_after=1, recover_after=100)
    cen = device.LiveBufferCensus(
        registry=hm.registry, monitor=hm, name="hbm_acc_t",
        budgets={"workload": 256.0 * 1024}, sample_every=1)
    big = torch.zeros((1024, 256))  # 1 MiB >> 256 KiB budget
    cen.register_tag("workload", lambda: big)
    try:
        with obs.override(True):
            cen.sample()
        det = hm.verdict()["detectors"]["hbm_pressure"]
        assert det["status"] == health.UNHEALTHY
        assert det["detail"]["worst_kind"] == "workload"
        assert det["detail"]["fraction"] >= 4.0
        base = f"http://{srv.address[0]}:{srv.address[1]}"
        code, body = _get(base + "/healthz")
        assert code == 503
        assert body["components"]["dev_hbm_t"]["status"] == health.UNHEALTHY
        code, dz = _get(base + "/devicez")
        assert code == 200
        sec = dz["device"]["census:hbm_acc_t"]
        assert sec["device"] is True
        assert sec["tags"]["workload"]["bytes"] == 1024 * 256 * 4
        bundles = sorted(fdir.glob("flight-*.jsonl"))
        assert bundles, "no anomaly-time flight bundle"
        rep = trace_report.summarize_flight(str(bundles[-1]))
        assert rep["reason"].startswith("health:dev_hbm_t:")
        assert rep["device"]["device:census:hbm_acc_t"]["device"] is True
    finally:
        cen.close()
        hm.close()
        flight.uninstall()
        events.configure()
        srv.close()


# -- in-place (donation) verification ----------------------------------------------


def test_donation_b5_apply_stays_clean_and_a_copy_trips():
    """B5's touched-row apply (``merge_apply``, in place on the table and
    its accumulator) writes the storages it was handed: checks pass, no
    misses.  A control that computes the same update into new tensors,
    wrapped as if it wrote in place, is a miss and trips donation_miss."""
    hm = _monitor(component="dev_don_t", trip_after=1, recover_after=100)
    watch = device.DonationWatch(registry=hm.registry, monitor=hm,
                                 name="don_acc_t")

    def apply_in_place(table, accum, uids, g):
        return sk.merge_apply(table, accum, uids, g, lr=0.1, eps=1e-7)

    def apply_copy(table, accum, uids, g):
        return sk.merge_apply(table.clone(), accum.clone(), uids, g,
                              lr=0.1, eps=1e-7)

    ok_fn = device.verify_donation("merge_apply_ok_t", apply_in_place,
                                   donate_argnums=(0, 1), watch=watch,
                                   sample_every=1)
    broken = device.verify_donation("merge_apply_broken_t", apply_copy,
                                    donate_argnums=(0, 1), watch=watch,
                                    sample_every=1)
    uids = torch.tensor([0, 3, 5, 0], dtype=torch.int32)
    g = torch.ones((4, 8))
    try:
        with obs.override(True):
            t1, a1, _ = ok_fn(torch.ones((16, 8)), torch.zeros((16, 8)),
                              uids, g)
            t2, a2, _ = broken(torch.ones((16, 8)), torch.zeros((16, 8)),
                               uids, g)
        assert torch.equal(t1, t2) and torch.equal(a1, a2)
        snap = watch.snapshot()
        assert snap["programs"]["merge_apply_ok_t"] == {"checks": 1,
                                                        "misses": 0}
        assert snap["programs"]["merge_apply_broken_t"] == {"checks": 1,
                                                            "misses": 1}
        det = hm.verdict()["detectors"]["donation_miss"]
        assert det["status"] == health.DEGRADED
        assert det["detail"]["worst_program"] == "merge_apply_broken_t"
        counters = hm.registry.snapshot()["counters"]
        assert counters[obs.labeled("device_donation_miss_total",
                                    program="merge_apply_broken_t")] == 1
    finally:
        watch.close()
        hm.close()


def test_donation_sampling_and_a_swapped_storage(monkeypatch):
    watch = device.DonationWatch(registry=obs.MetricsRegistry(),
                                 register=False)

    def swap(x):
        x.data = x.data.clone()  # a new storage behind the same tensor
        return x

    f = device.verify_donation("swap_t", swap, donate_argnums=(0,),
                               watch=watch, sample_every=2)
    with obs.override(True):
        for _ in range(3):
            f(torch.ones(4))
    assert watch.snapshot()["programs"]["swap_t"] == {"checks": 2,
                                                      "misses": 2}


def test_verify_donation_is_identity_when_dark(monkeypatch):
    monkeypatch.delenv("LIGHTCTR_DEVICE", raising=False)
    f = lambda x: x.add_(1)  # noqa: E731
    assert device.verify_donation("p", f, donate_argnums=(0,)) is f
    w = device.DonationWatch(register=False)
    assert device.verify_donation("p", f, donate_argnums=(), watch=w) is f
    monkeypatch.setenv("LIGHTCTR_DEVICE", "1")
    assert device.verify_donation("p", f, donate_argnums=(0,)) is not f


# -- profiler trigger ----------------------------------------------------------------


def test_post_profilez_captures_next_steps_and_rate_limits(tmp_path, rng):
    device.reset_profile_trigger()
    trig = device.profile_trigger(base_dir=str(tmp_path / "prof"),
                                  min_interval_s=3600.0)
    srv = exporter.OpsServer(port=0)
    tr = _toy_trainer()
    batch = _toy_batch(rng)
    url = f"http://{srv.address[0]}:{srv.address[1]}/profilez"
    try:
        with obs.override(True):
            tr.train_step(batch)
            code, body = _post(url + "?steps=2")
            assert code == 200 and body["armed"]["steps"] == 2
            code, body = _post(url)
            assert code == 409 and body["refused"] == "busy"
            assert trig.engaged()
            for _ in range(3):  # start boundary + 2 covered steps
                tr.train_step(batch)
        p = trig.payload()
        assert p["active"] is None and not trig.engaged()
        assert len(p["captures"]) == 1
        cap = p["captures"][0]
        assert cap["files"] > 0 and os.path.isdir(cap["dir"])
        assert cap["reason"] == "ops:profilez"
        names = {e.get("name") for e in json.loads(
            Path(cap["trace"]).read_text())["traceEvents"]}
        assert any(str(n).startswith("aten::") for n in names)
        code, body = _post(url)
        assert code == 429 and body["refused"] == "rate_limited"
        assert body["retry_after_s"] > 0
        counters = obs.default_registry().snapshot()["counters"]
        assert counters["device_profile_captures_total"] >= 1
        assert counters[obs.labeled("device_profile_refused_total",
                                    reason="rate_limited")] >= 1
    finally:
        srv.close()
        device.reset_profile_trigger()


def test_profilez_refuses_while_another_profiler_session_runs(tmp_path):
    """Only one torch.profiler session runs at a time: a caller's own
    session (chip_smoke's profiles, say) makes the trigger refuse 409."""
    reg = obs.MetricsRegistry()
    trig = device.ProfileTrigger(base_dir=str(tmp_path), registry=reg,
                                 min_interval_s=0.0, register=False)
    with obs.override(True):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            code, body = trig.handle_post({})
        assert code == 409 and body["refused"] == "busy"
        assert "another" in body["detail"]
        code, _ = trig.handle_post({"steps": ["1"]})
        assert code == 200
    trig.close()


def test_profilez_refuses_cleanly_without_profiler(monkeypatch, tmp_path):
    reg = obs.MetricsRegistry()
    trig = device.ProfileTrigger(base_dir=str(tmp_path), registry=reg,
                                 min_interval_s=0.0, register=False)
    monkeypatch.setattr(device.ProfileTrigger, "available",
                        lambda self: (False, "no profiler here"))
    with obs.override(True):
        code, body = trig.handle_post({})
    assert code == 409 and body["refused"] == "unavailable"
    assert "no profiler here" in body["detail"]
    assert reg.snapshot()["counters"][obs.labeled(
        "device_profile_refused_total", reason="unavailable")] == 1
    trig.close()


def test_anomaly_listener_fires_and_auto_capture_arms(tmp_path, monkeypatch):
    seen = []

    def listener(component, detector, prev, new, detail):
        seen.append((component, detector, prev, new))

    device.reset_profile_trigger()
    trig = device.profile_trigger(base_dir=str(tmp_path / "auto"),
                                  min_interval_s=0.0)
    health.register_anomaly_listener(listener)
    monkeypatch.setenv("LIGHTCTR_PROFILE_AUTO", "1")
    device.maybe_auto_capture_from_env()
    hm = _monitor(component="auto_cap_t", trip_after=1, recover_after=1)
    device.ensure_device_detectors(hm)
    try:
        with obs.override(True):
            hm.observe(hbm_pressure={"bytes": {"t": 99, "total": 99},
                                     "budgets": {"t": 100}})
        assert ("auto_cap_t", "hbm_pressure", health.OK,
                health.UNHEALTHY) in seen
        assert trig.engaged()
        assert trig.payload()["armed_steps"] == trig.default_steps
    finally:
        device.uninstall_auto_capture()
        health.unregister_anomaly_listener(listener)
        hm.close()
        device.reset_profile_trigger()


# -- trainer integration -------------------------------------------------------------


def test_trainer_arms_device_plane_by_ctor_and_env(monkeypatch, rng):
    monkeypatch.delenv("LIGHTCTR_DEVICE", raising=False)
    batch = _toy_batch(rng)
    tr = _toy_trainer(device_telemetry=True)
    assert tr.device_catalog is not None and tr.device_census is not None
    assert tr.device.type == "cpu"  # device= stays the torch device
    try:
        with obs.override(True):
            for _ in range(3):
                tr.train_step(batch)
        snap = tr.device_catalog.snapshot()
        assert snap["programs"]["trainer_step"]["steps"] == 3
        ana = tr.device_catalog.payload()["programs"]["trainer_step"][
            "analysis"]
        assert ana["available"] and ana["flops"] > 0
        assert ana["memory"]["argument"] > 0
        cen = tr.device_census.sample()
        state = sum(t.numel() * t.element_size() for t in
                    device.tensor_leaves((tr.params, tr.opt_state)))
        assert cen["tags"]["trainer_state"]["bytes"] == state
        v = tr.health.verdict()
        assert {"hbm_pressure", "donation_miss"} <= set(v["detectors"])
    finally:
        tr.device_catalog.close()
        tr.device_census.close()
    tr2 = _toy_trainer()
    assert tr2.device_catalog is None and tr2.device_census is None
    monkeypatch.setenv("LIGHTCTR_DEVICE", "1")
    tr3 = _toy_trainer()
    assert tr3.device_catalog is not None
    tr3.device_catalog.close()
    tr3.device_census.close()


class _StubEvent:
    """A CUDA event's surface for :class:`device.StepClock`: recorded at
    the next of ``times`` (ms), complete once ``done`` is set."""

    def __init__(self, times, log):
        self.t = times.pop(0)
        self.done = False
        self.log = log

    def record(self):
        self.log.append(("record", self.t))

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append(("sync", self.t))
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_step_clock_drains_completed_intervals_without_a_sync():
    log, made = [], []

    def event():
        made.append(_StubEvent(times, log))
        return made[-1]

    times = [0.0, 10.0, 25.0, 45.0, 70.0]
    clock = device.StepClock(max_lag=2, event=event)
    assert clock.mark() == []  # in flight: nothing waits for it
    made[0].done = True
    assert clock.mark() == []  # the first completed event has no interval
    made[1].done = True
    assert clock.mark() == [0.010]
    assert not any(k == "sync" for k, _ in log)
    # the card falls behind: past max_lag the oldest is waited for
    assert clock.mark() == []
    assert clock.mark() == [pytest.approx(0.015)]
    assert ("sync", 25.0) in log


def test_trainer_catalog_takes_the_cards_interval(rng):
    """On a card the catalog's step time is the interval between the
    completion events of consecutive steps (stubbed here), not the host's
    launch time; on the CPU it is the host's."""
    batch = _toy_batch(rng)
    tr = _toy_trainer(device_telemetry=True)
    times = [0.0, 10.0, 25.0, 45.0]
    made = []

    def event():
        made.append(_StubEvent(times, []))
        made[-1].done = True
        return made[-1]

    tr._step_clock = device.StepClock(event=event)
    try:
        with obs.override(True):
            for _ in range(4):
                tr.train_step(batch)
        prog = tr.device_catalog.snapshot()["programs"]["trainer_step"]
        assert len(made) == 4 and prog["steps"] == 3
        want = 0.010
        for dt in (0.015, 0.020):
            want = 0.9 * want + 0.1 * dt
        assert prog["ewma_seconds"] == pytest.approx(want)
    finally:
        tr.device_catalog.close()
        tr.device_census.close()
    cpu = _toy_trainer(device_telemetry=True)
    try:
        with obs.override(True):
            cpu.train_step(batch)
        assert cpu._step_clock is None
        prog = cpu.device_catalog.snapshot()["programs"]["trainer_step"]
        assert prog["steps"] == 1 and 0 < prog["ewma_seconds"] < 5
    finally:
        cpu.device_catalog.close()
        cpu.device_census.close()


def test_serving_model_records_its_scorer_when_armed(monkeypatch, rng):
    monkeypatch.setenv("LIGHTCTR_DEVICE", "1")
    device.reset_default_catalog()
    try:
        sm = ServingModel("fm", tfm.init(torch.Generator().manual_seed(3),
                                         F, K), device="cpu")
        sb = {"fids": rng.integers(1, F, size=(8, 4)).astype(np.int32),
              "vals": np.ones((8, 4), np.float32)}
        with obs.override(True):
            a = sm.score(sb)
            b = sm.score(sb)
        np.testing.assert_array_equal(a, b)
        ana = device.default_catalog().analyze()["serve_score_local_fm"]
        assert ana["available"] and ana["bytes_accessed"] > 0
    finally:
        device.reset_default_catalog()


# -- cluster rollup ------------------------------------------------------------------


def test_device_rollup_matches_jax_on_the_same_members():
    members = {
        "a": {"snapshot": {"gauges": {
            obs.labeled("device_program_utilization", program="step"): 0.4,
            obs.labeled("device_live_buffer_bytes", tag="embed"): 1000,
            obs.labeled("device_live_buffer_bytes", tag="untagged"): 900,
            obs.labeled("device_live_buffer_bytes", tag="total"): 1500},
            "counters": {}}},
        "b": {"snapshot": {"gauges": {
            obs.labeled("device_program_utilization", program="step"): 0.1},
            "counters": {obs.labeled("device_donation_miss_total",
                                     program="merge"): 3}}},
        "quiet": {"snapshot": {"gauges": {"trainer_loss": 0.5},
                               "counters": {}}},
    }
    out = device.device_rollup(members)
    assert out == jdevice.device_rollup(members)
    assert out["lowest_utilization"] == {
        "member": "b", "program": "step", "utilization": 0.1}
    assert out["donation_misses"] == {
        "member": "b", "program": "merge", "misses": 3}
    assert out["biggest_live"] == {"member": "a", "tag": "embed",
                                   "bytes": 1000}
    assert "quiet" not in out["members"]


# -- report tooling ------------------------------------------------------------------


def _golden(rng, tmp_path):
    """One registry and one /devicez payload carrying the whole plane: a
    real trainer step and a real serve scorer recorded, census, donation,
    profile refusals, against an explicit peak."""
    reg = obs.MetricsRegistry()
    cat = device.ProgramCatalog(component="rep_dev_t", registry=reg,
                                poll_every=0, peak_flops=1e12,
                                peak_hbm_bps=1e11, device="cpu")
    tr = _toy_trainer(16)
    batch = _toy_batch(rng, 16, 8)
    sm = ServingModel("fm", tfm.init(torch.Generator().manual_seed(3), F,
                                     K), device="cpu")
    sb = {"fids": torch.from_numpy(
              rng.integers(1, F, size=(8, 4)).astype(np.int32)),
          "vals": torch.ones((8, 4)), "mask": torch.ones((8, 4))}
    with obs.override(True):
        cat.run("trainer_step", tr._step,
                (tr.params, tr.opt_state, tr._put(batch)))
        cat.note_step(0.002, "trainer_step")
        cat.run("serve_score_local_fm", sm._jit_local, (sm.params, sb))
        cat.note_step(0.001, "serve_score_local_fm")
        cen = device.LiveBufferCensus(registry=reg, name="rep_cen_t",
                                      budgets={"weights": 1e9},
                                      register=False)
        cen.register_tag("weights", lambda: tr.params)
        cen.sample()
        watch = device.DonationWatch(registry=reg, name="rep_don_t",
                                     register=False)
        watch.note("merge_apply", aliased=True, donated=2)
        watch.note("merge_apply", aliased=False, donated=2)
        trig = device.ProfileTrigger(base_dir=str(tmp_path / "rep_prof"),
                                     registry=reg, min_interval_s=3600.0,
                                     register=False)
        trig.arm()
        trig.arm()
    payload = {"rep_dev_t": cat.payload(), "census:rep_cen_t": cen.payload(),
               "rep_don_t": watch.payload(), "profile": trig.payload()}
    for c in (cat, cen, watch, trig):
        c.close()
    return reg, payload


def test_metrics_report_device_on_the_ports_registry(tmp_path, capsys, rng):
    import tools.metrics_report as metrics_report

    reg, _ = _golden(rng, tmp_path)
    snap = reg.snapshot()
    rep = metrics_report.summarize_device(snap)
    for prog in ("trainer_step", "serve_score_local_fm"):
        p = rep["programs"][prog]
        assert p["flops"] > 0 and p["bytes_accessed"] > 0
        assert p["intensity"] > 0
        assert p["memory"]["argument"] > 0
        assert p["time"]["count"] == 1
    assert rep["live"]["weights"]["bytes"] == 16 * 4
    assert rep["live"]["weights"]["budget_bytes"] == 10 ** 9
    assert rep["donation"]["merge_apply"] == {"checks": 2, "misses": 1}
    assert rep["profile"]["refused"]["busy"] == 1
    path = tmp_path / "snap.json"
    path.write_text(json.dumps({"telemetry": snap}))
    assert metrics_report.main(["--device", str(path)]) == 0
    out = capsys.readouterr().out
    assert '"trainer_step"' in out and '"serve_score_local_fm"' in out


def test_device_report_tool_renders_the_ports_devicez(tmp_path, capsys,
                                                      rng):
    import tools.device_report as device_report

    _, payload = _golden(rng, tmp_path)
    path = tmp_path / "devicez.json"
    path.write_text(json.dumps({"device": payload}))
    assert device_report.main([str(path)]) == 0
    cap = capsys.readouterr()
    assert "trainer_step" in cap.err and "serve_score_local_fm" in cap.err
    assert "live buffers" in cap.err and "donation checks" in cap.err
    json.loads(cap.out)
    assert device_report.main([str(path), "--json"]) == 0
    cap = capsys.readouterr()
    assert cap.err == ""
    rep = json.loads(cap.out)
    cat = rep["catalogs"][0]
    assert cat["component"] == "rep_dev_t"
    progs = {r["program"]: r for r in cat["programs"]}
    assert progs["trainer_step"]["flops"] > 0
    assert progs["trainer_step"]["utilization"] is not None
