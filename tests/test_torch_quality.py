"""The port's model-quality plane on the CPU, against the JAX package.

``tests/test_quality.py``'s cases on ``lightctr_tpu_torch.obs.quality``,
each also against the JAX module on the same inputs: the sketch (its
segment sum on ``merge_rows``'s plain version here) against the JAX
``quality_sketch`` and the numpy twin; the accumulators, statistics,
detectors, trackers and drift monitor; the series lint; ``/qualityz``; the
rollup; the acceptance run (a shift and a label flip trip the plane, a
control stays ok).  Then the trainers' ``quality_bins=``: an armed run
trains bit for bit as an unarmed one, and its tracker is held to the JAX
trainer's; the server's ``drift=``.  The multi-rank armed runs ride the
worlds of ``tests/test_torch_dp_trainer.py``.

Tolerances: the sketch's count, label and probability rows bit for bit
where the probabilities are equal, its logloss row within rtol 1e-6 (XLA's
``log``/``log1p`` and torch's differ in the last place); through a trainer
(whose sigmoid differs from XLA's in the last place, so an example may
change bins) the totals exactly, AUC within 1e-3, logloss and the
calibration ratio within rtol 1e-4."""

import ast
import json
import math
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu.obs import quality as jquality
from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.obs import events, exporter, flight, health, quality

REPO_ROOT = Path(__file__).resolve().parent.parent
TABLES = {"w": ["fids"], "v": ["fids"]}
LL_RTOL = 1e-6          # the sketch's logloss row
AUC_ATOL = 1e-3         # through a trainer
TRAINER_RTOL = 1e-4     # logloss and calibration through a trainer


def _monitor(**kw):
    kw.setdefault("registry", obs.MetricsRegistry())
    kw.setdefault("flight_min_interval_s", 0.0)
    return health.HealthMonitor(**kw)


def _get(url, timeout=5.0):
    """(status_code, parsed_json_or_text) tolerating HTTP error codes."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    try:
        return code, json.loads(body)
    except json.JSONDecodeError:
        return code, body.decode()


def _calibrated_stream(rng, n, a=2.0, b=5.0):
    """Scores from Beta(a, b) with labels drawn at the score."""
    p = rng.beta(a, b, size=n)
    y = (rng.random(n) < p).astype(np.float64)
    return p, y


# -- the sketch ---------------------------------------------------------------


@pytest.mark.parametrize("bins", [32, 512])
def test_sketch_matches_the_jax_sketch_and_the_numpy_twin(rng, bins):
    """On equal float32 probabilities (bin edges, 0 and 1 among them) the
    port's sketch equals the JAX ``quality_sketch``: counts, label sums
    and probability sums bit for bit, logloss sums within rtol 1e-6; and
    the numpy twin within ``test_quality.py``'s rtol 1e-4 / atol 1e-3."""
    edges = np.arange(bins + 1, dtype=np.float32) / bins
    p = np.concatenate([rng.random(4096).astype(np.float32), edges,
                        np.nextafter(edges, np.float32(2)),
                        np.nextafter(edges, np.float32(-1))])
    p = np.clip(p, 0.0, 1.0).astype(np.float32)
    y = (rng.random(p.size) > 0.6).astype(np.float32)
    got = quality.quality_sketch(torch.from_numpy(p), torch.from_numpy(y),
                                 bins).numpy()
    want = np.asarray(jax.jit(lambda a, b: jquality.quality_sketch(
        a, b, bins))(p, y))
    assert got.shape == want.shape == (quality.sketch_width(bins),)
    rows, wrows = got.reshape(4, bins), want.reshape(4, bins)
    np.testing.assert_array_equal(rows[:3].view(np.int32),
                                  wrows[:3].view(np.int32))
    np.testing.assert_allclose(rows[3], wrows[3], rtol=LL_RTOL)
    # the float64 twin on the random part (at p = 1 with y = 0 the float32
    # clamp 1 - 1e-7 rounds to 1 - 2^-23, in both packages' sketches)
    r, ry = torch.from_numpy(p[:4096]), torch.from_numpy(y[:4096])
    host = quality.sketch_from_scores(p[:4096], y[:4096], bins)
    np.testing.assert_allclose(quality.quality_sketch(r, ry, bins).numpy(),
                               host, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(
        host, jquality.sketch_from_scores(p[:4096], y[:4096], bins))
    acc = quality.QualityAccumulator(bins)
    acc.update(got)
    assert acc.count == p.size
    assert abs(acc.pos_hist.sum() - float(y.sum())) < 1e-3


def test_sketch_runs_on_merge_rows_in_slot_order(monkeypatch, rng):
    """The segment sum is one ``merge_rows`` call of the stacked [n, 4]
    rows into ``bins`` segments (the kernel on a card; its plain version
    here), and a second sketch of the same inputs is the same bits."""
    from lightctr_tpu_torch.ops import sparse_kernels

    calls = []
    real = sparse_kernels.merge_rows

    def spy(rows, inv, num_segments):
        calls.append((tuple(rows.shape), inv.dtype, num_segments))
        return real(rows, inv, num_segments)

    monkeypatch.setattr(sparse_kernels, "merge_rows", spy)
    p = torch.from_numpy(rng.random(1000).astype(np.float32))
    y = torch.from_numpy((rng.random(1000) > 0.5).astype(np.float32))
    a = quality.quality_sketch(p, y, 64)
    b = quality.quality_sketch(p, y, 64)
    assert calls == [((1000, 4), torch.int32, 64)] * 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_streaming_auc_within_0_005_of_exact(rng):
    """The rank-statistic AUC off the binned sketch sits within 0.005 of
    the exact pairwise AUC, and equals the JAX accumulator's."""
    n = 4096
    p, y = _calibrated_stream(rng, n)
    acc = quality.QualityAccumulator(quality.DEFAULT_BINS)
    jacc = jquality.QualityAccumulator(quality.DEFAULT_BINS)
    for chunk in np.array_split(np.arange(n), 8):
        acc.update_scores(p[chunk], y[chunk])
        jacc.update_scores(p[chunk], y[chunk])
    pos, neg = p[y > 0.5], p[y <= 0.5]
    diff = pos[:, None] - neg[None, :]
    exact = ((diff > 0).sum() + 0.5 * (diff == 0).sum()) / (
        len(pos) * len(neg))
    assert abs(acc.auc() - exact) < 0.005
    assert acc.auc() == jacc.auc()
    empty = quality.QualityAccumulator(16)
    empty.update_scores(p[:8], np.ones(8))
    assert math.isnan(empty.auc())


def test_accumulator_calibration_ece_logloss_and_merge(rng):
    n = 4000
    p = rng.random(n)
    y = (rng.random(n) < p).astype(np.float64)
    a = quality.QualityAccumulator(128)
    a.update_scores(p, y)
    assert a.count == n and a.updates == 1
    assert abs(a.calibration_ratio() - 1.0) < 0.1
    assert a.ece() < 0.05
    pc = np.clip(p, 1e-7, 1 - 1e-7)
    ll = float(np.mean(-(y * np.log(pc) + (1 - y) * np.log1p(-pc))))
    assert abs(a.logloss() - ll) < 1e-6
    z = np.log(pc / (1 - pc))
    cold = 1.0 / (1.0 + np.exp(-z / 4.0))
    a2 = quality.QualityAccumulator(128)
    a2.update_scores(cold, y)
    assert abs(a2.auc() - a.auc()) < 0.01
    assert abs(a2.calibration_ratio() - 1.0) < 0.1
    assert a2.ece() > a.ece() + 0.05
    m = quality.QualityAccumulator(128)
    m.merge(a)
    m.merge(a2)
    assert m.count == 2 * n and m.updates == 2
    snap = a.snapshot()
    assert snap["quality"] is True and snap["examples"] == n
    assert snap["calibration"], "calibration table rides the snapshot"
    ja = jquality.QualityAccumulator(128)
    ja.update_scores(p, y)
    assert snap == ja.snapshot()
    assert a.ece() == ja.ece()
    a.reset()
    assert a.count == 0 and math.isnan(a.calibration_ratio())


def test_psi_sym_kl_and_fold_hist(rng):
    ref = rng.integers(10, 100, size=32).astype(np.float64)
    assert quality.psi(ref, ref * 3.0) < 1e-6  # scale-free
    assert quality.symmetric_kl(ref, ref) < 1e-9
    moved = np.zeros(32)
    moved[:4] = ref.sum() / 4
    assert quality.psi(ref, moved) > 0.5
    assert quality.symmetric_kl(ref, moved) > 0.5
    assert quality.psi(ref, moved) == jquality.psi(ref, moved)
    assert quality.symmetric_kl(ref, moved) == \
        jquality.symmetric_kl(ref, moved)
    h = np.arange(12, dtype=np.float64)
    folded = quality.fold_hist(h, 4)
    assert folded.shape == (4,) and folded.sum() == h.sum()
    np.testing.assert_array_equal(folded, jquality.fold_hist(h, 4))
    assert quality.fold_hist(np.ones(10), 4).sum() == 10.0


def test_resolve_bins_explicit_beats_env(monkeypatch):
    monkeypatch.delenv("LIGHTCTR_QUALITY", raising=False)
    assert quality.resolve_bins() is None
    assert quality.resolve_bins(24) == 24
    assert quality.resolve_bins(0) is None
    monkeypatch.setenv("LIGHTCTR_QUALITY", "16")
    assert quality.resolve_bins() == 16
    assert quality.resolve_bins(0) is None  # explicit off wins
    monkeypatch.setenv("LIGHTCTR_QUALITY", "true")
    assert quality.resolve_bins() == quality.DEFAULT_BINS
    monkeypatch.setenv("LIGHTCTR_QUALITY", "0")
    assert quality.resolve_bins() is None


# -- detectors ----------------------------------------------------------------


def test_calibration_detector_bands():
    det = quality.CalibrationDetector(tolerance=0.25, min_count=100)
    sig = lambda r, n=1000: {"calibration": {"ratio": r, "count": n}}
    assert det.check(sig(5.0, n=10))[0] == health.OK  # warmup skip
    assert det.check(sig(1.1))[0] == health.OK
    assert det.check(sig(1.4))[0] == health.DEGRADED
    assert det.check(sig(1 / 1.4))[0] == health.DEGRADED  # symmetric
    assert det.check(sig(0.55))[0] == health.UNHEALTHY
    assert det.check(sig(float("nan")))[0] == health.UNHEALTHY
    assert det.check(sig(-1.0))[0] == health.UNHEALTHY


def test_auc_regression_detector_bands():
    det = quality.AUCRegressionDetector(auc_margin=0.02,
                                        logloss_margin=0.10, min_count=100)

    def sig(auc=0.75, ll=0.5, n=1000):
        return {"auc_quality": {"auc": auc, "baseline_auc": 0.75,
                                "logloss_ewma": ll,
                                "logloss_baseline": 0.5, "count": n}}

    assert det.check(sig(n=10))[0] == health.OK  # warmup skip
    assert det.check(sig())[0] == health.OK
    assert det.check(sig(auc=0.72))[0] == health.DEGRADED
    assert det.check(sig(auc=0.70))[0] == health.UNHEALTHY
    assert det.check(sig(ll=0.575))[0] == health.DEGRADED
    st, detail = det.check(sig(ll=0.65))
    assert st == health.UNHEALTHY and detail["logloss_rel"] > 0.2


def test_drift_detector_names_worst_field():
    det = quality.DriftDetector(min_count=100)
    sig = lambda fields, n=1000: {"drift": {"fields": fields, "count": n}}
    assert det.check(sig({"score": 0.05}))[0] == health.OK
    assert det.check(sig({"a": 0.3}, n=10))[0] == health.OK  # warmup
    assert det.check(sig({}))[0] == health.OK  # nothing scored yet
    st, detail = det.check(sig({"a": 0.3, "b": 0.1}))
    assert st == health.DEGRADED and detail["worst_field"] == "a"
    st, detail = det.check(sig({"a": 0.1, "uid": 0.9}))
    assert st == health.UNHEALTHY and detail["worst_field"] == "uid"


def test_detectors_are_registered_and_installed_idempotently():
    """The three detectors sit in the port's ``KNOWN_DETECTORS`` under the
    JAX names; ``ensure_quality_detectors`` installs each once."""
    for cls in quality.QUALITY_DETECTORS:
        assert health.KNOWN_DETECTORS[cls.name] is cls
    assert [c.name for c in quality.QUALITY_DETECTORS] == \
        [c.name for c in jquality.QUALITY_DETECTORS]
    hm = _monitor(component="qd_t")
    try:
        quality.ensure_quality_detectors(hm)
        quality.ensure_quality_detectors(hm)
        names = set(hm.verdict()["detectors"])
        assert {"calibration", "auc_regression", "drift"} <= names
    finally:
        hm.close()


def test_quality_series_lint_both_directions():
    """Every series the port's quality.py emits is declared in
    QUALITY_SERIES and every declared series is emitted; the set is the
    JAX module's."""
    tree = ast.parse((REPO_ROOT / "lightctr_tpu_torch" / "obs"
                      / "quality.py").read_text())
    emitted = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "labeled"):
            arg = node.args[0]
            assert isinstance(arg, ast.Constant) and isinstance(
                arg.value, str)
            emitted.add(arg.value)
    declared = set(quality.QUALITY_SERIES)
    assert len(declared) == len(quality.QUALITY_SERIES), "duplicate entry"
    assert emitted == declared
    assert quality.QUALITY_SERIES == jquality.QUALITY_SERIES


def test_every_name_of_the_jax_module_is_ported():
    jnames = {n for n in vars(jquality) if not n.startswith("__")}
    tnames = {n for n in vars(quality) if not n.startswith("__")}
    assert jnames - tnames - {"jax", "jnp"} == set()


# -- tracker + drift monitor ---------------------------------------------------


def test_tracker_rolls_windows_freezes_baseline_and_registers(rng):
    reg = obs.MetricsRegistry()
    qt = quality.QualityTracker(component="trk_t", num_bins=64,
                                registry=reg, window_updates=2,
                                min_window_count=10)
    jqt = jquality.QualityTracker(component="trk_t_jax", num_bins=64,
                                  registry=jquality.MetricsRegistry(),
                                  window_updates=2, min_window_count=10)
    try:
        p, y = _calibrated_stream(rng, 256)
        for t in (qt, jqt):
            t.update_scores(p[:128], y[:128])
            t.update_scores(p[128:], y[128:])
        assert qt.windows == 1 and qt.baseline is not None
        base_auc = qt.baseline["auc"]
        for t in (qt, jqt):
            t.update_scores(p[:128], y[:128])
            t.update_scores(p[128:], y[128:])
        assert qt.windows == 2
        assert qt.baseline["auc"] == base_auc  # frozen, not rolling
        snap = reg.snapshot()
        assert snap["counters"][obs.labeled(
            "quality_examples_total", component="trk_t")] == 512
        assert snap["counters"][obs.labeled(
            "quality_windows_total", component="trk_t")] == 2
        for g in ("quality_calibration_ratio", "quality_auc",
                  "quality_logloss_ewma", "quality_logloss_baseline"):
            assert obs.labeled(g, component="trk_t") in snap["gauges"], g
        assert obs.labeled("quality_drift_score", component="trk_t",
                           field="score") in snap["gauges"]
        s = qt.snapshot()
        assert s["quality"] is True and s["component"] == "trk_t"
        assert s["windows"] == 2 and s["last_window"]["examples"] == 256
        assert s["baseline"]["auc"] is not None
        js = jqt.snapshot()
        for k in ("windows", "logloss_ewma", "baseline", "last_window",
                  "auc", "calibration"):
            assert s[k] == js[k], k
        assert "trk_t" in quality.quality_payload()["quality"]
        assert "quality:trk_t" in flight.registered_registries()
    finally:
        qt.close()
        jqt.close()
    assert "trk_t" not in quality.quality_payload()["quality"]
    assert "quality:trk_t" not in flight.registered_registries()


def test_drift_monitor_freezes_reference_then_scores_windows(rng):
    reg = obs.MetricsRegistry()
    hm = _monitor(component="dm_t", trip_after=1, recover_after=1)
    dm = quality.DriftMonitor(component="dm_t_serve", score_bins=16,
                              coverage_buckets=16, reference_examples=512,
                              window_examples=512, monitor=hm, registry=reg)
    jdm = jquality.DriftMonitor(component="dm_t_jax", score_bins=16,
                                coverage_buckets=16, reference_examples=512,
                                window_examples=512,
                                registry=jquality.MetricsRegistry())
    try:
        feeds = [(rng.beta(2, 5, 512), rng.integers(0, 1000, 512)),
                 (rng.beta(2, 5, 512), rng.integers(0, 1000, 512)),
                 (rng.beta(8, 2, 512), rng.integers(0, 4, 512))]
        for i, (s, u) in enumerate(feeds):
            dm.observe(scores=s, fields={"fids": u})
            jdm.observe(scores=s, fields={"fids": u})
            if i == 0:
                assert dm.snapshot()["reference_frozen"] is True
            if i == 1:
                assert dm.windows == 1
                assert dm.last_scores["score"] < 0.2
                assert dm.last_scores["fids"] < 0.2
                assert hm.status() == health.OK
            assert dm.last_scores == jdm.last_scores
        assert dm.windows == 2
        assert dm.last_scores["fids"] > 0.5
        assert hm.status() == health.UNHEALTHY
        v = hm.verdict()["detectors"]["drift"]
        assert v["detail"]["worst_field"] in ("fids", "score")
        cov = reg.snapshot()["counters"][obs.labeled(
            "quality_coverage_total", component="dm_t_serve", field="fids")]
        assert cov == 3 * 512
        assert dm.snapshot()["reference"] == jdm.snapshot()["reference"]
    finally:
        dm.close()
        jdm.close()
        hm.close()


# -- routes and rollup --------------------------------------------------------


def test_qualityz_route_serves_registered_providers(rng):
    srv = exporter.OpsServer(port=0)
    qt = quality.QualityTracker(component="qz_t", num_bins=16,
                                registry=obs.MetricsRegistry(),
                                window_updates=1, min_window_count=8)
    try:
        p, y = _calibrated_stream(rng, 64)
        qt.update_scores(p, y)
        code, body = _get(
            f"http://{srv.address[0]}:{srv.address[1]}/qualityz")
        assert code == 200
        sect = body["quality"]["qz_t"]
        assert sect["examples"] == 64 and sect["windows"] == 1
    finally:
        qt.close()
        srv.close()


def test_quality_rollup_extracts_members_and_worst_drift():
    members = {
        "shard_0": {"snapshot": {
            "counters": {obs.labeled("quality_examples_total",
                                     component="trainer"): 100},
            "gauges": {obs.labeled("quality_drift_score",
                                   component="serve", field="fids"): 0.7},
        }},
        "shard_1": {"snapshot": {
            "gauges": {obs.labeled("quality_drift_score",
                                   component="serve", field="score"): 0.2,
                       "ps_store_pending_depth": 3.0},
        }},
        "shard_2": {"snapshot": {"counters": {"ps_pulls_total": 5}}},
    }
    roll = quality.quality_rollup(members)
    assert set(roll["members"]) == {"shard_0", "shard_1"}
    assert roll["worst_drift"] == {"member": "shard_0", "field": "fids",
                                   "score": 0.7}
    assert roll == jquality.quality_rollup(members)
    assert quality.quality_rollup({})["worst_drift"] is None


# -- acceptance: shift + flip trip the plane, control stays ok ------------------


def test_quality_plane_acceptance_shift_and_flip(tmp_path, rng):
    """A covariate shift and a label flip trip the drift and calibration
    detectors on the perturbed component (``/healthz`` 503 and an
    anomaly-time flight bundle whose quality section reads back), while
    an unperturbed control component stays ok."""
    import tools.trace_report as trace_report

    fdir = tmp_path / "flight"
    srv = exporter.OpsServer(port=0)
    flight.install(str(fdir), catch_signals=False)
    events.configure()
    overrides = {"calibration": {"min_count": 256},
                 "auc_regression": {"min_count": 256, "auc_margin": 0.08},
                 "drift": {"min_count": 256}}
    hm_bad = _monitor(component="tqual_bad", trip_after=1, recover_after=1)
    hm_ok = _monitor(component="tqual_ok", trip_after=1, recover_after=1)
    mk = dict(num_bins=128, window_updates=1, min_window_count=256,
              detector_overrides=overrides)
    qt_bad = quality.QualityTracker(component="tqual_bad", monitor=hm_bad,
                                    registry=hm_bad.registry, **mk)
    qt_ok = quality.QualityTracker(component="tqual_ok", monitor=hm_ok,
                                   registry=hm_ok.registry, **mk)
    dk = dict(score_bins=16, coverage_buckets=16, reference_examples=512,
              window_examples=512, detector_overrides=overrides)
    dm_bad = quality.DriftMonitor(component="tqual_bad_serve",
                                  monitor=hm_bad, registry=hm_bad.registry,
                                  **dk)
    dm_ok = quality.DriftMonitor(component="tqual_ok_serve", monitor=hm_ok,
                                 registry=hm_ok.registry, **dk)

    def healthy_batch(n=512):
        p, y = _calibrated_stream(rng, n)
        return p, y, rng.integers(0, 1000, size=n)

    try:
        for _ in range(4):
            p, y, u = healthy_batch()
            qt_bad.update_scores(p, y)
            dm_bad.observe(scores=p, fields={"uid": u})
            p, y, u = healthy_batch()
            qt_ok.update_scores(p, y)
            dm_ok.observe(scores=p, fields={"uid": u})
        assert hm_bad.status() == health.OK
        assert hm_ok.status() == health.OK
        assert dm_bad.snapshot()["reference_frozen"]
        for _ in range(2):
            p, y, _ = healthy_batch()
            qt_bad.update_scores(p, 1.0 - y)
            dm_bad.observe(scores=rng.beta(8, 2, 512),
                           fields={"uid": rng.integers(0, 4, size=512)})
            p, y, u = healthy_batch()
            qt_ok.update_scores(p, y)
            dm_ok.observe(scores=p, fields={"uid": u})
        v = hm_bad.verdict()
        assert v["status"] == health.UNHEALTHY
        assert v["detectors"]["calibration"]["status"] == health.UNHEALTHY
        assert v["detectors"]["drift"]["status"] == health.UNHEALTHY
        assert v["detectors"]["auc_regression"]["status"] != health.OK
        assert hm_ok.status() == health.OK
        base = f"http://{srv.address[0]}:{srv.address[1]}"
        code, body = _get(base + "/healthz")
        assert code == 503
        assert body["components"]["tqual_bad"]["status"] == \
            health.UNHEALTHY
        assert body["components"]["tqual_ok"]["status"] == health.OK
        code, qz = _get(base + "/qualityz")
        assert code == 200
        for name in ("tqual_bad", "tqual_ok", "tqual_bad_serve",
                     "tqual_ok_serve"):
            assert name in qz["quality"], name
        bundles = sorted(fdir.glob("flight-*.jsonl"))
        assert bundles, "no anomaly-time flight bundle"
        rep = trace_report.summarize_flight(str(bundles[-1]))
        assert rep["reason"].startswith("health:tqual_bad:")
        assert "quality:tqual_bad" in rep["quality"]
        assert rep["quality"]["quality:tqual_bad"]["quality"] is True
        assert rep["health"]["tqual_bad"]["status"] == health.UNHEALTHY
    finally:
        for c in (qt_bad, qt_ok, dm_bad, dm_ok):
            c.close()
        hm_bad.close()
        hm_ok.close()
        flight.uninstall()
        events.configure()
        srv.close()


# -- the trainers' quality_bins -------------------------------------------------


def _toy(cls, d=32, **kw):
    params = {"w": np.zeros((d,), np.float32)}
    if cls is CTRTrainer:
        return CTRTrainer(params, lambda p, b: b["x"] @ p["w"],
                          TrainConfig(learning_rate=0.1), device="cpu", **kw)
    return JCTRTrainer(params, lambda p, b: b["x"] @ p["w"],
                       JConfig(learning_rate=0.1), **kw)


def test_ctr_trainer_armed_sketch_feeds_tracker(rng):
    """``test_quality.py``'s toy trainer: every step's sketch drains into
    the tracker (windows rolled, full example accounting), and the
    tracker's totals are the JAX trainer's, its statistics within the
    stated tolerances."""
    d, n = 32, 128
    batch = {
        "x": rng.normal(size=(n, d)).astype(np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
    }
    trackers = []
    for cls in (CTRTrainer, JCTRTrainer):
        tr = _toy(cls, d, quality_bins=32)
        assert tr.quality is not None
        tr.quality.close()
        mod = quality if cls is CTRTrainer else jquality
        reg = mod.MetricsRegistry()
        tr.quality = mod.QualityTracker(
            component=f"trainer_it_{cls.__module__.split('.')[0]}",
            num_bins=32, registry=reg, window_updates=8,
            min_window_count=64)
        for _ in range(20):
            tr.train_step(batch)
        tr.flush_health()
        trackers.append((tr.quality, reg))
    (qt, reg), (jqt, jreg) = trackers
    try:
        assert qt.total.count == 20 * n
        assert qt.total.pos_hist.sum() == 20 * float(batch["labels"].sum())
        counters = reg.snapshot()["counters"]
        name = qt.component
        assert counters[obs.labeled("quality_windows_total",
                                    component=name)] == 2
        assert counters[obs.labeled("quality_examples_total",
                                    component=name)] == 16 * n
        assert qt.total.count == jqt.total.count
        assert qt.total.pos_hist.sum() == jqt.total.pos_hist.sum()
        assert qt.total.auc() == pytest.approx(jqt.total.auc(),
                                               abs=AUC_ATOL)
        for stat in ("logloss", "calibration_ratio"):
            assert getattr(qt.total, stat)() == pytest.approx(
                getattr(jqt.total, stat)(), rel=TRAINER_RTOL), stat
    finally:
        qt.close()
        jqt.close()
    tr2 = _toy(CTRTrainer, d, quality_bins=0)
    assert tr2.quality is None and tr2._quality_bins is None


def test_env_var_arms_the_trainer_sketch(monkeypatch):
    monkeypatch.setenv("LIGHTCTR_QUALITY", "16")
    tr = _toy(CTRTrainer)
    assert tr._quality_bins == 16 and tr.quality is not None
    tr.quality.close()
    tr = SparseTableCTRTrainer(
        tfm.params_from_numpy(fm_params(), "cpu"), tfm.logits,
        TrainConfig(), sparse_tables=TABLES, device="cpu")
    assert tr._quality_bins == 16 and tr.quality is not None
    tr.quality.close()


VOCAB, K, FIELDS, ROWS = 512, 8, 6, 128


def fm_params():
    return {k: np.asarray(v) for k, v in
            jfm.init(jax.random.PRNGKey(0), VOCAB, K).items()}


def fm_batches(steps=6, seed=5):
    rng = np.random.default_rng(seed)
    return [{"fids": rng.integers(0, VOCAB, (ROWS, FIELDS)).astype(np.int32),
             "vals": rng.uniform(0.5, 1.5, (ROWS, FIELDS)).astype(
                 np.float32),
             "mask": np.ones((ROWS, FIELDS), np.float32),
             "labels": (rng.random(ROWS) > 0.5).astype(np.float32)}
            for _ in range(steps)]


def port_trainer(kind, **kw):
    cfg = TrainConfig(learning_rate=0.05, lambda_l2=0.001)
    p = tfm.params_from_numpy(fm_params(), "cpu")
    extra = dict(fused_fn=tfm.logits_with_l2, device="cpu", **kw)
    if kind == "sparse":
        return SparseTableCTRTrainer(p, tfm.logits, cfg,
                                     sparse_tables=TABLES, **extra)
    return CTRTrainer(p, tfm.logits, cfg, **extra)


@pytest.mark.parametrize("kind", ["dense", "fused", "sparse"])
def test_armed_training_is_unarmed_training_bit_for_bit(kind, monkeypatch):
    """Arming changes nothing that is trained: losses, params and
    optimizer state bit for bit, and the unarmed health vector keeps its
    two slots.  With the health feed off an armed trainer still drains
    every sketch and runs no host count of the touched ids."""
    kw = {"fused_adagrad": True} if kind == "fused" else {}
    kind = "dense" if kind == "fused" else kind
    runs = []
    for qb in (None, 32):
        tr = port_trainer(kind, quality_bins=qb, **kw)
        tr.health = None
        monkeypatch.setattr(tr, "_health_signals", lambda b: pytest.fail(
            "the health feed's host pass ran with the feed off"))
        seen = []
        step = tr._step

        def spy(*a, _step=step, _seen=seen):
            out = _step(*a)
            _seen.append(out[3].shape[0])
            return out

        tr._step = spy
        losses = [float(tr.train_step(b)) for b in fm_batches()]
        tr.flush_health()
        runs.append((losses, tr.params, tr.opt_state, seen, tr.quality))
    (l0, p0, s0, seen0, q0), (l1, p1, s1, seen1, q1) = runs
    assert q0 is None and l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    from lightctr_tpu_torch.optim.updaters import tree_leaves

    for a, b in zip(tree_leaves(s0), tree_leaves(s1)):
        assert torch.equal(a, b)
    assert set(seen0) == {2} and set(seen1) == {2 + 4 * 32}
    assert q1.total.updates == len(l1)
    assert q1.total.count == len(l1) * ROWS
    q1.close()


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_armed_trainer_matches_the_jax_trackers(kind):
    """FM through each trainer armed with 64 bins over 6 steps against
    the JAX trainer armed alike: the example and positive totals exactly,
    AUC within 1e-3, logloss and calibration within rtol 1e-4; the
    losses at the FM trajectory bound (rtol 2e-5 / atol 2e-6)."""
    tr = port_trainer(kind, quality_bins=64)
    tr.health = None
    jcfg = JConfig(learning_rate=0.05, lambda_l2=0.001)
    if kind == "sparse":
        jt = JSparseTrainer(fm_params(), jfm.logits, jcfg,
                            sparse_tables=TABLES,
                            fused_fn=jfm.logits_with_l2, quality_bins=64)
    else:
        jt = JCTRTrainer(fm_params(), jfm.logits, jcfg,
                         fused_fn=jfm.logits_with_l2, quality_bins=64)
    jt.health = None
    try:
        tl = [float(tr.train_step(b)) for b in fm_batches()]
        jl = [float(jt.train_step(b)) for b in fm_batches()]
        tr.flush_health()
        jt.flush_health()
        np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-6)
        got, want = tr.quality.total, jt.quality.total
        assert got.updates == want.updates == len(tl)
        assert got.count == want.count == len(tl) * ROWS
        assert got.pos_hist.sum() == want.pos_hist.sum()
        assert got.auc() == pytest.approx(want.auc(), abs=AUC_ATOL)
        for stat in ("logloss", "calibration_ratio"):
            assert getattr(got, stat)() == pytest.approx(
                getattr(want, stat)(), rel=TRAINER_RTOL), stat
    finally:
        tr.quality.close()
        jt.quality.close()


def test_armed_trainer_feeds_a_health_monitor_too(rng):
    """With a monitor the drain feeds loss and grad norm to it and the
    sketch to the tracker from the same vector; a window rolls."""
    hm = _monitor(component="qtr_t")
    tr = port_trainer("sparse", quality_bins=16)
    try:
        tr.health = hm
        health.ensure_trainer_detectors(hm)
        tr.quality.close()
        tr.quality = quality.QualityTracker(
            component="qtr_t", num_bins=16, monitor=hm,
            registry=obs.MetricsRegistry(), window_updates=2,
            min_window_count=64)
        for b in fm_batches(4):
            tr.train_step(b)
        tr.flush_health()
        assert tr.quality.windows == 2
        assert tr.quality.total.count == 4 * ROWS
        assert {"nan_loss", "calibration"} <= set(hm.verdict()["detectors"])
    finally:
        tr.quality.close()
        hm.close()


# -- the server's drift= --------------------------------------------------------


def test_server_drift_hook_trips_on_a_shift(rng):
    """The FM server with ``drift=``: a monitor built without a health
    monitor binds the server's; the first requests freeze the reference,
    the same traffic scores below the drift detector's degraded band, and
    two windows of requests whose ids collapse onto a few (the monitor
    trips after two) trip it in the server's verdict."""
    from lightctr_tpu_torch.serve import PredictClient, PredictionServer
    from lightctr_tpu_torch.serve.model import ServingModel

    params = {k: np.asarray(v) for k, v in fm_params().items()}
    params["w"] = rng.normal(0, 0.5, VOCAB).astype(np.float32)
    model = ServingModel("fm", params, device="cpu")
    dm = quality.DriftMonitor(component="tsrv_drift", score_bins=16,
                              coverage_buckets=16, reference_examples=512,
                              window_examples=512,
                              registry=obs.MetricsRegistry(),
                              detector_overrides={"drift": {
                                  "min_count": 256}})
    srv = PredictionServer(model, port=0, max_batch=256, drift=dm,
                           device="cpu")
    cli = PredictClient(srv.address)

    def settled(windows):
        # the scorer thread feeds the monitor after it answers a batch
        deadline = time.monotonic() + 10.0
        while dm.snapshot()["windows"] != windows or \
                dm.snapshot()["live_examples"]:
            assert time.monotonic() < deadline, dm.snapshot()
            time.sleep(0.01)

    def req(fids):
        return {"fids": fids.astype(np.int32),
                "vals": np.ones(fids.shape, np.float32),
                "mask": np.ones(fids.shape, np.float32)}

    try:
        assert dm.monitor is srv.health
        traffic = [req(rng.integers(0, VOCAB, (256, FIELDS)))
                   for _ in range(4)]
        for r in traffic:
            cli.predict(r)
        settled(1)
        assert dm.snapshot()["reference_frozen"]
        for r in traffic:
            cli.predict(r)
        settled(3)
        assert max(dm.last_scores.values()) < quality.DriftDetector().degraded
        assert srv.health.verdict()["detectors"]["drift"]["status"] == \
            health.OK
        for _ in range(4):
            cli.predict(req(rng.integers(0, 4, (256, FIELDS))))
        settled(5)
        v = srv.health.verdict()["detectors"]["drift"]
        assert v["status"] != health.OK
        assert v["detail"]["worst_field"] in ("fids", "score")
        assert dm.last_scores["fids"] > quality.DriftDetector().unhealthy
    finally:
        cli.close()
        srv.close()
