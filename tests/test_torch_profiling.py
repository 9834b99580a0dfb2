"""The port's profiling hooks on the CPU (``tests/test_profiling.py``'s
cases on ``lightctr_tpu_torch.utils.profiling``): ``wall_clock``'s freeze
semantics, the no-op-safe ``annotate`` (also a span emitter), ``trace``'s
``trace_capture`` event and its Chrome trace on disk, its degradation when
the profiler is unavailable or refuses to start (another capture active),
and ``profiler_available``'s contract.  The package exports the names the
JAX package's ``utils`` exports (its profiling and system modules'), and
the system readers agree with the JAX package's on the CPU."""

import json
import logging
import os
import time

import pytest
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.obs import events
from lightctr_tpu_torch.obs import trace as obs_trace
from lightctr_tpu_torch.utils import profiling
from lightctr_tpu_torch.utils.profiling import annotate, wall_clock


def test_utils_exports_the_jax_packages_profiling_names():
    import lightctr_tpu.utils as jutils
    import lightctr_tpu.utils.profiling as jprof
    import lightctr_tpu_torch.utils as tutils

    jnames = {n for n in jutils.__all__
              if getattr(jutils, n).__module__ == jprof.__name__}
    assert jnames == {"annotate", "trace", "wall_clock"}
    # the package exports every name the JAX package's does (the
    # profiling names and utils.system's), each from the matching module
    assert set(tutils.__all__) == set(jutils.__all__)
    for n in jutils.__all__:
        assert getattr(tutils, n).__module__ == getattr(
            jutils, n).__module__.replace("lightctr_tpu.", "lightctr_tpu_torch.")
    for n in ("trace", "wall_clock", "profiler_available"):
        assert callable(getattr(profiling, n))


def test_system_readers_match_the_jax_packages():
    from lightctr_tpu.utils import system as jsys
    from lightctr_tpu_torch.utils import system as tsys

    mem = tsys.host_memory_usage()
    assert set(mem) == set(jsys.host_memory_usage()) and mem["MemTotal"] > 0
    assert tsys.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert tsys.device_memory_stats() is None


def test_wall_clock_counts_elapsed():
    w = wall_clock()
    w.start()
    time.sleep(0.02)
    c = w.cycles()
    assert c >= 0.015
    time.sleep(0.01)
    assert w.cycles() > c


def test_wall_clock_freezes_at_context_exit():
    with wall_clock() as w:
        time.sleep(0.02)
    frozen = w.cycles()
    assert frozen >= 0.015
    time.sleep(0.02)
    assert w.cycles() == frozen


def test_wall_clock_cycles_before_start_raises():
    with pytest.raises(RuntimeError):
        wall_clock().cycles()


def test_wall_clock_restart_resets():
    with wall_clock() as w:
        time.sleep(0.01)
    w.start()
    assert w.cycles() < 0.01


def test_annotate_preserves_results_and_nests():
    def f(x):
        with annotate("gather"):
            y = x * 2.0
        with annotate("apply"):
            return y + 1.0

    assert float(f(torch.tensor(3.0))) == 7.0
    with annotate("outer"):
        with annotate("inner"):
            pass


def test_annotate_emits_spans_when_tracing_sampled():
    obs_trace.reset()
    with obs.override(True), obs_trace.override_rate(1.0):
        with annotate("phase/outer", step=3):
            with annotate("phase/inner"):
                pass
    spans = {s["name"]: s for s in obs_trace.finished()}
    assert set(spans) == {"phase/outer", "phase/inner"}
    assert spans["phase/inner"]["parent"] == spans["phase/outer"]["span"]
    assert spans["phase/outer"]["attrs"] == {"step": 3}
    obs_trace.reset()


def _captures():
    return [r for r in events.get_event_log().records()
            if r["kind"] == "trace_capture"]


def test_trace_emits_trace_capture_event_and_writes_a_chrome_trace(
        tmp_path):
    events.configure()
    try:
        with obs.override(True):
            with profiling.trace(str(tmp_path / "profile"),
                                 create_perfetto_link=False, device="cpu"):
                with annotate("region/in_trace"):
                    torch.ones(64).sum()
        recs = _captures()
        assert len(recs) == 1
        assert recs[0]["log_dir"].endswith("profile")
        assert recs[0]["perfetto_link"] is False
        path = tmp_path / "profile" / "trace.json"
        body = json.loads(path.read_text())
        names = {e.get("name") for e in body["traceEvents"]}
        assert "region/in_trace" in names
        assert not profiling.capture_active()
    finally:
        events.configure()


def test_trace_degrades_to_noop_without_the_profiler(tmp_path, monkeypatch,
                                                     caplog):
    monkeypatch.setattr(torch.autograd, "kineto_available", lambda: False)
    events.configure()
    try:
        with obs.override(True), caplog.at_level(
                logging.WARNING, logger="lightctr_tpu_torch.utils.profiling"):
            with profiling.trace(str(tmp_path / "p")):
                ran = True
        assert ran
        assert any("no-op" in r.message for r in caplog.records)
        recs = _captures()
        assert recs and recs[0]["unavailable"] is True
        assert not (tmp_path / "p").exists()
    finally:
        events.configure()


def test_trace_degrades_when_another_capture_is_active(tmp_path, caplog):
    """One torch.profiler session runs at a time: a trace() inside another
    caller's raw session is a logged no-op with the degradation recorded,
    never an exception into the caller's step."""
    events.configure()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert profiling.capture_active()
            with obs.override(True), caplog.at_level(
                    logging.WARNING,
                    logger="lightctr_tpu_torch.utils.profiling"):
                with profiling.trace(str(tmp_path / "p")):
                    ran = True
        assert ran
        assert any("no-op" in r.message for r in caplog.records)
        degraded = [r for r in _captures() if r.get("unavailable")]
        assert degraded and "another" in degraded[0]["error"]
        assert not profiling.capture_active()
    finally:
        events.configure()


def test_profiler_available_contract(monkeypatch):
    ok, why = profiling.profiler_available()
    assert ok is True and why == "ok"
    monkeypatch.setattr(torch.profiler, "profile", None)
    ok, why = profiling.profiler_available()
    assert ok is False and "profile" in why


def test_session_refuses_a_second_capture(tmp_path):
    a = profiling.Session(str(tmp_path / "a"), device="cpu")
    b = profiling.Session(str(tmp_path / "b"), device="cpu")
    a.start()
    try:
        with pytest.raises(RuntimeError, match="another"):
            b.start()
    finally:
        path = a.stop()
    assert os.path.exists(path)
    b.start()
    assert b.stop() is not None
