"""The port's cluster observability against the JAX package's
(``tests/test_cluster_obs.py`` mirrored): the per-round arrival timelines
on the reduce rendezvous, the cluster telemetry rollup (member-labeled
/metrics, scrape-down marking), the straggler attributor behind
/stragglerz, the master's scrape loop, the exposition-format label
escaping; the rollup's exposition and the attributor's verdict equal to
the JAX package's on the same snapshots; and the straggler-naming half of
``tests/test_cluster_stall_acceptance.py`` in-process, two hosts on
threads (the JAX report tools' cases stay with the JAX tests)."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from lightctr_tpu.obs import cluster as jcluster
from lightctr_tpu.obs import registry as jregistry
from lightctr_tpu_torch.dist.hier import HierExchangeClient, SparseReduceShard
from lightctr_tpu_torch.dist.master import MasterService
from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.obs import exporter as exporter_mod
from lightctr_tpu_torch.obs import flight as flight_mod
from lightctr_tpu_torch.obs.cluster import ClusterRollup, attribute_stragglers
from lightctr_tpu_torch.obs.registry import (
    MetricsRegistry,
    escape_label_value,
    labeled,
    render_prometheus,
)


def _hist(sum_s: float, count: int, le=(0.1, 1.0)) -> dict:
    counts = [0] * (len(le) + 1)
    counts[-2] = count
    return {"le": list(le), "counts": counts, "sum": sum_s, "count": count}


# -- exposition-format label escaping ---------------------------------------


def test_label_values_escape_exposition_specials():
    r"""Member addresses and error strings flow into labels via the
    rollup: ``\``, ``"`` and newlines must escape per the Prometheus
    exposition format or one bad member corrupts the whole scrape."""
    assert escape_label_value('a"b') == 'a\\"b'
    assert escape_label_value("a\\b") == "a\\\\b"
    assert escape_label_value("a\nb") == "a\\nb"
    reg = MetricsRegistry()
    reg.inc(labeled("scrape_errors_total",
                    member="127.0.0.1:5555",
                    error='refused "conn"\nback\\slash'))
    text = render_prometheus(reg.snapshot(), prefix="lightctr_")
    line = [ln for ln in text.splitlines() if ln.startswith("lightctr_s")]
    assert line == [
        'lightctr_scrape_errors_total{error="refused \\"conn\\"\\nback'
        '\\\\slash",member="127.0.0.1:5555"} 1'
    ]
    # plain values are untouched (golden stability for every other test)
    assert labeled("x", op="pull") == 'x{op="pull"}'


# -- per-round arrival timelines on the rendezvous --------------------------


def test_shard_records_arrival_timeline_and_names_straggler():
    """Two hosts, one round: the late host's arrival offset lands in the
    per-round ring AND the host-labeled ``hier_round_wait_seconds``
    histogram — the straggler is named in one stats scrape."""
    reg = MetricsRegistry()
    shard = SparseReduceShard(n_hosts=2, registry=reg)
    c0 = HierExchangeClient([shard.address], 0, 2,
                            registry=MetricsRegistry())
    c1 = HierExchangeClient([shard.address], 1, 2,
                            registry=MetricsRegistry())
    try:
        u = np.array([1, 2], np.int64)
        r = np.ones((2, 2), np.float32)
        c0.push(0, u, r, epoch=0)
        time.sleep(0.15)
        c1.push(0, u, r, epoch=0)
        c0.pull(0, 0, 2)
        c1.pull(0, 0, 2)
        st = shard.stats()
        rounds = st["arrivals"]
        assert len(rounds) == 1
        rd = rounds[0]
        assert rd["epoch"] == 0 and rd["table"] == 0
        assert rd["arrivals"]["0"] == 0.0
        assert rd["arrivals"]["1"] >= 0.1
        assert rd["wait_s"] == rd["arrivals"]["1"]
        hists = st["telemetry"]["histograms"]
        h1 = hists[labeled("hier_round_wait_seconds", host="1")]
        assert h1["count"] == 1 and h1["sum"] >= 0.1
        h0 = hists[labeled("hier_round_wait_seconds", host="0")]
        assert h0["count"] == 1 and h0["sum"] < h1["sum"]
        # a RETRIED push must not double-count the arrival
        c0.push(0, u, r, epoch=0)
        assert shard.stats()["telemetry"]["histograms"][
            labeled("hier_round_wait_seconds", host="0")]["count"] == 1
    finally:
        c0.close()
        c1.close()
        shard.close()


def test_client_records_round_latency_and_withheld_retries():
    """The client side of the same question: push -> pull-satisfied per
    round (``hier_round_client_seconds``) plus the withheld-retry count —
    a slow ROUND shows up at every member, not just on the shard."""
    reg = MetricsRegistry()
    shard = SparseReduceShard(n_hosts=2)
    c0 = HierExchangeClient([shard.address], 0, 2, registry=reg)
    c1 = HierExchangeClient([shard.address], 1, 2,
                            registry=MetricsRegistry())
    try:
        u = np.array([3], np.int64)
        r = np.ones((1, 2), np.float32)

        def late_peer():
            time.sleep(0.12)
            c1.push(0, u, r, epoch=0)

        t = threading.Thread(target=late_peer)
        c0.push(0, u, r, epoch=0)
        t.start()
        c0.pull(0, 0, 2)  # blocks withheld until the peer arrives
        t.join()
        snap = reg.snapshot()
        h = snap["histograms"]["hier_round_client_seconds"]
        assert h["count"] == 1 and h["sum"] >= 0.1
        assert snap["counters"]["hier_round_withheld_retries_total"] >= 1
        assert not c0._round_t0  # satisfied rounds do not pin entries
    finally:
        c0.close()
        c1.close()
        shard.close()


# -- the rollup --------------------------------------------------------------


def test_rollup_member_labels_and_scrape_down_marking():
    """Live members' series gain ``member=...`` labels in the merged
    snapshot; a member whose scrape fails is MARKED (up gauge 0, error in
    the members view — the sharded client's down-shard shape), never dropped."""
    roll = ClusterRollup()
    roll.update("shard_0", {"telemetry": {
        "counters": {"ps_pushes_total": 7,
                     labeled("ps_op_seconds", op="pull"): 2},
        "gauges": {}, "histograms": {"x_seconds": _hist(0.5, 5)},
    }})
    roll.update("worker_1", {"counters": {"trainer_steps_total": 3},
                             "gauges": {}, "histograms": {}})
    roll.mark_down("shard_1", ConnectionError("connection refused"))
    snap = roll.snapshot()
    assert snap["counters"][
        labeled("ps_pushes_total", member="shard_0")] == 7
    # already-labeled series keep their labels beside the member label
    assert snap["counters"][
        'ps_op_seconds{member="shard_0",op="pull"}'] == 2
    assert snap["counters"][
        labeled("trainer_steps_total", member="worker_1")] == 3
    assert snap["histograms"][
        labeled("x_seconds", member="shard_0")]["count"] == 5
    assert snap["gauges"][labeled("cluster_member_up",
                                  member="shard_0")] == 1
    assert snap["gauges"][labeled("cluster_member_up",
                                  member="shard_1")] == 0
    assert snap["counters"][labeled("cluster_scrape_failures_total",
                                    member="shard_1")] == 1
    members = roll.members()
    assert members["shard_1"]["scrape_down"] is True
    assert "refused" in members["shard_1"]["error"]
    assert members["shard_0"]["scrape_down"] is False
    # the member label survives the Prometheus render
    text = render_prometheus(snap, prefix="lightctr_")
    assert 'lightctr_ps_pushes_total{member="shard_0"} 7' in text
    # a later successful scrape flips the member back up
    roll.update("shard_1", {"telemetry": {
        "counters": {}, "gauges": {}, "histograms": {}}})
    assert roll.snapshot()["gauges"][
        labeled("cluster_member_up", member="shard_1")] == 1
    assert roll.members()["shard_1"]["scrape_down"] is False


def _members_fixture():
    """Synthetic rollup view: a rendezvous shard whose round-wait
    histograms blame host 1, plus three workers where worker_2 is 3x the
    median step time, plus a scrape-down member."""
    return {
        "rendezvous_0": {"member": "rendezvous_0", "scrape_down": False,
                         "snapshot": {"histograms": {
                             labeled("hier_round_wait_seconds", host="0"):
                                 _hist(0.02, 10),
                             labeled("hier_round_wait_seconds", host="1"):
                                 _hist(3.0, 10),
                         }}},
        "worker_0": {"member": "worker_0", "scrape_down": False,
                     "snapshot": {"histograms": {
                         "trainer_step_seconds": _hist(1.0, 10)}}},
        "worker_1": {"member": "worker_1", "scrape_down": False,
                     "snapshot": {"histograms": {
                         "trainer_step_seconds": _hist(1.1, 10)}}},
        "worker_2": {"member": "worker_2", "scrape_down": False,
                     "snapshot": {"histograms": {
                         "trainer_step_seconds": _hist(3.3, 10)}}},
        "shard_9": {"member": "shard_9", "scrape_down": True,
                    "error": "unreachable"},
    }


def test_attribute_stragglers_ranks_hosts_and_members():
    report = attribute_stragglers(_members_fixture())
    assert report["verdict"]["slowest_host"] == "1"
    assert report["hosts"][0]["host"] == "1"
    assert report["hosts"][0]["wait_total_s"] == pytest.approx(3.0)
    assert report["hosts"][0]["wait_mean_s"] == pytest.approx(0.3)
    assert report["verdict"]["slowest_member"] == "worker_2"
    skew = {m["member"]: m.get("step_skew")
            for m in report["members"] if "step_skew" in m}
    assert skew["worker_2"] == pytest.approx(3.0, rel=0.01)
    assert skew["worker_0"] == pytest.approx(0.909, rel=0.01)
    assert report["scrape_down"] == ["shard_9"]


# -- master scrape loop + /stragglerz ---------------------------------------


def test_master_scrape_loop_rolls_up_members_and_marks_down():
    """The master polls every member's MSG_STATS into the rollup (stable
    ``shard_<i>`` names + extra targets like a rendezvous shard), the
    rollup registers for /metrics and /stragglerz, and a killed member is
    marked scrape_down instead of vanishing.  close() unhooks it all."""
    stores = [AsyncParamServer(dim=2, n_workers=1, seed=0)
              for _ in range(2)]
    svcs = [ParamServerService(s) for s in stores]
    rdv = SparseReduceShard(n_hosts=1)
    master = MasterService(
        [s.address for s in svcs], period_s=0.05,
        scrape_period_s=30.0,  # the loop idles; sweeps are driven below
        scrape_targets=[("rendezvous_0", rdv.address)],
    )
    try:
        # give the members something to report
        c = PSClient(svcs[0].address, dim=2)
        c.pull_arrays(np.array([1, 2], np.int64), worker_epoch=0,
                      worker_id=0)
        c.close()
        hc = HierExchangeClient([rdv.address], 0, 1,
                                registry=MetricsRegistry())
        hc.exchange(0, np.array([5], np.int64),
                    np.ones((1, 2), np.float32), epoch=0)
        hc.close()

        master.scrape_once()
        members = master.rollup.members()
        assert set(members) == {"shard_0", "shard_1", "rendezvous_0"}
        assert not any(e["scrape_down"] for e in members.values())
        snap = master.rollup.snapshot()
        assert labeled("hier_round_wait_seconds", host="0") in \
            members["rendezvous_0"]["snapshot"]["histograms"]
        assert any(k.startswith("ps_") and 'member="shard_0"' in k
                   for k in snap["counters"])
        # the rollup is flight-registered -> the master's ops exporter
        # merges it into /metrics; /stragglerz serves the verdict
        assert flight_mod.registered_registries()["cluster"] \
            is master.rollup
        routes = exporter_mod.json_routes()
        assert "/stragglerz" in routes
        verdict = routes["/stragglerz"]()
        assert verdict["verdict"]["slowest_host"] == "0"
        assert {m["member"] for m in verdict["members"]} == set(members)

        # a member dying mid-run: marked, never dropped
        svcs[1].close()
        master.scrape_once()
        members = master.rollup.members()
        assert members["shard_1"]["scrape_down"] is True
        assert members["shard_1"]["error"]
        assert master.rollup.snapshot()["gauges"][
            labeled("cluster_member_up", member="shard_1")] == 0
        assert "shard_1" in master.stragglerz()["scrape_down"]
    finally:
        master.close()
        rdv.close()
        for s in svcs:
            try:
                s.close()
            except OSError:
                pass
    assert "cluster" not in flight_mod.registered_registries()
    assert "/stragglerz" not in exporter_mod.json_routes()


def test_exporter_serves_registered_json_routes():
    srv = exporter_mod.OpsServer(port=0)
    exporter_mod.register_json_route("/pingz", lambda: {"pong": 1})
    try:
        url = f"http://{srv.address[0]}:{srv.address[1]}"
        with urllib.request.urlopen(url + "/pingz", timeout=5) as resp:
            assert resp.status == 200
            assert json.loads(resp.read()) == {"pong": 1}
        exporter_mod.unregister_json_route("/pingz")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/pingz", timeout=5)
        assert ei.value.code == 404
        with pytest.raises(ValueError):
            exporter_mod.register_json_route("/metrics", lambda: {})
    finally:
        exporter_mod.unregister_json_route("/pingz")
        srv.close()


# -- the same rollup in both packages ------------------------------------------


def _scrapes():
    """MSG_STATS-shaped member snapshots, one member down, label values
    that need escaping."""
    return [
        ("shard_0", {"telemetry": {
            "counters": {"ps_pushes_total": 7,
                         labeled("ps_op_seconds", op="pull"): 2},
            "gauges": {"ps_keys": 12.5},
            "histograms": {"x_seconds": _hist(0.5, 5),
                           "trainer_step_seconds": _hist(1.0, 10)}}}),
        ("rendezvous_0", {"telemetry": {
            "counters": {}, "gauges": {},
            "histograms": {
                labeled("hier_round_wait_seconds", host="0"):
                    _hist(0.02, 10),
                labeled("hier_round_wait_seconds", host="1"):
                    _hist(3.0, 10)}}}),
        ("worker_1", {"counters": {"trainer_steps_total": 3},
                      "gauges": {},
                      "histograms": {"trainer_step_seconds":
                                     _hist(3.3, 10)}}),
    ]


def test_rollup_exposition_and_verdict_equal_the_jax_package(monkeypatch):
    """The same scrapes through the port's rollup and the JAX package's
    (at one wall time): the merged snapshot, its ``/metrics`` exposition,
    the members view and the straggler verdict are equal."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    port, ref = ClusterRollup(), jcluster.ClusterRollup()
    for roll in (port, ref):
        for name, snap in _scrapes():
            roll.update(name, json.loads(json.dumps(snap)))
        roll.mark_down('shard_1 "x"\n', ConnectionError("refused\nhere"))
    ps, rs = port.snapshot(), ref.snapshot()
    assert ps == rs
    assert render_prometheus(ps, prefix="lightctr_") == \
        jregistry.render_prometheus(rs, prefix="lightctr_")
    assert port.members() == ref.members()
    assert attribute_stragglers(port.members()) == \
        jcluster.attribute_stragglers(ref.members())


# -- the straggler, named (the stall acceptance's first half) -------------------


def test_two_host_straggler_named_in_process():
    """Two hosts on threads exchange through one rendezvous shard for 12
    rounds; host 1 sleeps 0.4 s before its push in rounds 8 and 9.  The
    shard's arrival timeline and its host-labeled
    ``hier_round_wait_seconds`` name host 1, and ``/stragglerz`` (the
    rollup and the attributor over the scraped stats, on a real ops
    endpoint) ranks it first."""
    shard = SparseReduceShard(n_hosts=2)
    errors = []

    def host(hid):
        c = HierExchangeClient([shard.address], hid, 2,
                               registry=MetricsRegistry(),
                               pull_timeout_s=30.0)
        rng = np.random.default_rng(hid)
        try:
            for epoch in range(12):
                u = np.unique(rng.integers(1, 256, 40)).astype(np.int64)
                r = rng.normal(size=(len(u), 4)).astype(np.float32)
                if hid == 1 and epoch in (8, 9):
                    time.sleep(0.4)
                c.push(0, u, r, epoch)
                c.push(1 << 20, np.arange(3, dtype=np.int64),
                       np.ones((3, 1), np.float32), epoch, exact=True)
                c.pull(0, epoch, 4)
                c.pull(1 << 20, epoch, 1, exact=True)
        except Exception as e:  # surfaced below
            errors.append((hid, repr(e)))
        finally:
            c.close()

    threads = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
    srv = None
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        scraper = PSClient(tuple(shard.address), dim=1, timeout=10.0)
        st = scraper.stats()
        scraper.close()
        hists = st["telemetry"]["histograms"]
        h0 = hists[labeled("hier_round_wait_seconds", host="0")]
        h1 = hists[labeled("hier_round_wait_seconds", host="1")]
        assert h1["sum"] > h0["sum"] + 0.5, (h0["sum"], h1["sum"])
        slept = [r for r in st["arrivals"]
                 if r["arrivals"].get("1", 0.0) >= 0.25]
        assert slept and {r["epoch"] for r in slept} <= {8, 9}
        assert all(r["wait_s"] == r["arrivals"]["1"] for r in slept)
        rollup = ClusterRollup()
        rollup.update("rendezvous_0", st)
        exporter_mod.register_json_route(
            "/stragglerz", lambda: attribute_stragglers(rollup.members()))
        srv = exporter_mod.OpsServer(port=0)
        with urllib.request.urlopen(
                f"http://{srv.address[0]}:{srv.address[1]}/stragglerz",
                timeout=5) as resp:
            verdict = json.loads(resp.read())
        assert verdict["verdict"]["slowest_host"] == "1"
        assert verdict["hosts"][0]["host"] == "1"
    finally:
        if srv is not None:
            exporter_mod.unregister_json_route("/stragglerz")
            srv.close()
        shard.close()
