"""The port's cluster roles against the JAX package's
(``tests/test_cluster.py`` and ``tests/test_ps_shard_failover.py``
mirrored): heartbeats over the wire driving the monitor and routing, the
PS failover snapshot restore, the master broadcasting routing decisions
to every shard (the port's master over the port's shards and over the
JAX package's), shard death, restore and reconnect, the master's
liveness ledger and its dead-set resync of a fresh incarnation (with the
heartbeat race that made the JAX test flaky, held deterministically), the
down-shard stats; and ``initialize_multihost``: its no-ops, and a
2-process gloo world joined through it from the launcher's environment.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from lightctr_tpu.dist import ps_server as jps_server
from lightctr_tpu.embed import async_ps as jasync_ps
from lightctr_tpu_torch.dist import ps_server as tps_server
from lightctr_tpu_torch.dist.bootstrap import (
    LAUNCH_ENV,
    HeartbeatMonitor,
    initialize_multihost,
    wire_heartbeat,
)
from lightctr_tpu_torch.dist.master import SHARD_ID_BASE, MasterService
from lightctr_tpu_torch.dist.ps_server import (
    ParamServerService,
    PSClient,
    ShardedPSClient,
)
from lightctr_tpu_torch.embed import async_ps as tasync_ps
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 5
#: the shards' package: (the store module, the service module)
SHARD_PKGS = {"port": (tasync_ps, tps_server), "jax": (jasync_ps, jps_server)}


def test_beat_over_the_wire_drives_monitor_and_routing():
    """MSG_BEAT frames feed the heartbeat monitor: silence unroutes the
    worker, a returning beat readmits it (master.h:202-262 over sockets)."""
    ps = AsyncParamServer(dim=2, n_workers=2)
    clock = [0.0]
    monitor = HeartbeatMonitor(
        stale_after_s=1.0, dead_after_s=2.0, period_s=10.0,
        clock=lambda: clock[0],
    )
    wire_heartbeat(monitor, ps)
    svc = ParamServerService(ps, monitor=monitor)
    try:
        client = PSClient(svc.address, 2)
        client.beat(0)
        client.beat(1)
        assert monitor.check() == {"0": "alive", "1": "alive"}

        clock[0] = 3.0
        client.beat(0)  # worker 0 keeps beating; worker 1 goes silent
        monitor.check()
        time.sleep(0.05)  # server thread applies the beat before asserting
        assert client.stats()["unrouted"] == [1]
        assert client.pull([5], worker_epoch=0, worker_id=1) is None

        client.beat(1)  # returning node re-registers (master.h:80-82)
        time.sleep(0.05)
        assert client.stats()["unrouted"] == []
        assert client.pull([5], worker_epoch=0, worker_id=1) is not None

        # clean departure (FIN): worker 0 leaves deliberately; its silence
        # afterwards is NOT a death and it never lands in unrouted
        client.farewell(0)
        clock[0] = 10.0
        client.beat(1)
        assert monitor.check() == {"1": "alive"}
        time.sleep(0.05)
        assert client.stats()["unrouted"] == []
        client.close()
    finally:
        svc.close()


def test_stats_reports_server_side_counters():
    ps = AsyncParamServer(dim=2, n_workers=1, staleness_threshold=2)
    svc = ParamServerService(ps)
    try:
        client = PSClient(svc.address, 2)
        client.pull([1, 2, 3], worker_epoch=0, worker_id=0)
        s = client.stats()
        assert s["n_keys"] == 3
        assert s["withheld_pulls"] == 0
        assert "last_epoch_version" in s and "staleness" in s
        client.close()
    finally:
        svc.close()


def test_ps_failover_snapshot_restore(rng):
    """PS process failure recovery: coordinator snapshots the live store,
    the service dies, a FRESH service restores from the snapshot, and
    workers resume against identical parameters.  This is a WEIGHTS-only
    checkpoint (the snapshot admin op captures rows, not optimizer
    accumulators — those restart fresh, exactly what the reference's
    'persist to disk' PS TODO covered; full-state checkpointing lives in
    ckpt/)."""
    dim = 4
    ps1 = AsyncParamServer(dim=dim, updater="adagrad", learning_rate=0.1,
                           n_workers=1, seed=0)
    svc1 = ParamServerService(ps1)
    try:
        client = PSClient(svc1.address, dim)
        keys = np.unique(rng.integers(0, 1 << 16, size=200))
        rows = rng.normal(size=(len(keys), dim)).astype(np.float32)
        client.preload_arrays(keys, rows)
        g = rng.normal(size=(len(keys), dim)).astype(np.float32) * 0.1
        g16 = g.astype(np.float16).astype(np.float32)
        assert client.push_arrays(0, keys, g16, worker_epoch=0)

        # checkpoint (exact fp32 admin op), then the PS "crashes"
        ck, cr = client.snapshot_arrays()
        client.close()
    finally:
        svc1.close()

    # fresh PS process restores from the snapshot; workers reconnect
    ps2 = AsyncParamServer(dim=dim, updater="adagrad", learning_rate=0.1,
                           n_workers=1, seed=99)  # different seed: state
    svc2 = ParamServerService(ps2)                # comes from the ckpt
    # control: an in-process store restored from the SAME snapshot — the
    # resumed service must match it bit-for-bit, before and after the
    # next training push
    control = AsyncParamServer(dim=dim, updater="adagrad",
                               learning_rate=0.1, n_workers=1, seed=7)
    control.preload_batch(ck, cr)
    try:
        client2 = PSClient(svc2.address, dim)
        client2.preload_arrays(ck, cr)
        k2, r2 = client2.snapshot_arrays()
        np.testing.assert_array_equal(k2, ck)
        np.testing.assert_array_equal(r2, cr)
        # training continues: identical (fresh-accumulator) update math
        assert client2.push_arrays(0, keys, g16, worker_epoch=1)
        control.push_batch(0, keys, g16, worker_epoch=1)
        np.testing.assert_array_equal(
            client2.snapshot_arrays()[1], control.snapshot_arrays()[1]
        )
        client2.close()
    finally:
        svc2.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_master_broadcasts_routing_to_all_shards(pkg):
    """The three-role split (master.h decides, network.h the PS obeys):
    a worker that stops beating the MASTER is unrouted on EVERY shard via
    the control-plane ops; its returning beat readmits it everywhere —
    the port's master over either package's shards."""
    store, service = SHARD_PKGS[pkg]
    shards = [store.AsyncParamServer(dim=2, n_workers=2) for _ in range(2)]
    svcs = [service.ParamServerService(ps) for ps in shards]
    master = MasterService(
        [s.address for s in svcs],
        stale_after_s=0.2, dead_after_s=0.4, period_s=0.1,
    )
    try:
        beat = PSClient(master.address, 1)
        beat.beat(0)
        beat.beat(1)
        # worker 1 goes silent; worker 0 keeps beating
        deadline = time.time() + 10.0
        while time.time() < deadline:
            beat.beat(0)
            if all(1 in ps._unrouted for ps in shards):
                break
            time.sleep(0.05)
        assert all(1 in ps._unrouted for ps in shards)
        assert all(0 not in ps._unrouted for ps in shards)

        # returning beat -> readmitted on every shard
        deadline = time.time() + 10.0
        while time.time() < deadline:
            beat.beat(1)
            if all(1 not in ps._unrouted for ps in shards):
                break
            time.sleep(0.05)
        assert all(1 not in ps._unrouted for ps in shards)
        beat.close()
    finally:
        master.close()
        for s in svcs:
            s.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_master_farewell_clears_shard_routes(pkg):
    """A clean FIN to the master clears the departing worker's routes on
    the SHARDS (not just the master's dummy store)."""
    store, service = SHARD_PKGS[pkg]
    shards = [store.AsyncParamServer(dim=2, n_workers=2) for _ in range(2)]
    svcs = [service.ParamServerService(ps) for ps in shards]
    master = MasterService([s.address for s in svcs], period_s=10.0)
    try:
        for ps in shards:
            ps.unroute_worker(1)
        client = PSClient(master.address, 1)
        client.farewell(1)
        assert all(1 not in ps._unrouted for ps in shards)
        client.close()
    finally:
        master.close()
        for s in svcs:
            s.close()


def test_unroute_readmit_wire_ops():
    """MSG_UNROUTE / MSG_READMIT drive the store's routing directly."""
    ps = AsyncParamServer(dim=2, n_workers=2)
    svc = ParamServerService(ps)
    try:
        client = PSClient(svc.address, 2)
        client.preload({3: np.ones(2, np.float32)})
        client.unroute(1)
        assert client.pull([3], worker_epoch=0, worker_id=1) is None
        client.readmit(1)
        assert client.pull([3], worker_epoch=0, worker_id=1) is not None
        client.close()
    finally:
        svc.close()


def _mk_store(seed):
    return AsyncParamServer(dim=DIM, updater="adagrad", learning_rate=0.1,
                            n_workers=2, seed=seed)


def test_shard_death_restore_reconnect(rng):
    svcs = [ParamServerService(_mk_store(s)) for s in (0, 1)]
    client = ShardedPSClient([s.address for s in svcs], DIM,
                             partition="ring")
    try:
        keys = np.arange(200, dtype=np.int64)
        rows = rng.normal(size=(200, DIM)).astype(np.float32)
        client.preload_arrays(keys, rows)

        # ops-plane backup of shard 0 (the launcher's backup agent op)
        bkeys, brows = client.snapshot_shard(0)
        assert len(bkeys) > 0

        # train one step so post-restore state is distinguishable from init
        g = np.full((200, DIM), 0.25, np.float32)
        g16 = g.astype(np.float16).astype(np.float32)
        assert client.push_arrays(0, keys, g16, worker_epoch=0)
        bkeys, brows = client.snapshot_shard(0)  # newest backup
        s1_before = client.clients[1].snapshot_arrays()

        # SIGKILL equivalent: the service vanishes mid-run
        host, port = svcs[0].address
        svcs[0].close()

        # degraded mode: pulls say retry (None), pushes are lossy — the
        # reachable shard's slice still applies (partial application, the
        # reference's async-push semantics) while the call reports False
        assert client.pull_arrays(keys, worker_epoch=1, worker_id=0) is None
        assert client.push_arrays(0, keys, g16, worker_epoch=1) is False
        assert client.clients[0] is None  # marked down, not raised

        # relaunch on the SAME address, restore from the backup
        svcs[0] = ParamServerService(_mk_store(7), host=host, port=port)
        client.preload_arrays(bkeys, brows)  # routes only to shard 0
        assert client.reconnects >= 1

        # shard 0 == its backup exactly (fp32 preload); shard 1 advanced
        # one extra step during the outage (lossy-push partial application)
        k0, r0 = client.snapshot_shard(0)
        np.testing.assert_array_equal(k0, bkeys)
        np.testing.assert_array_equal(r0, brows)
        k1, r1 = client.clients[1].snapshot_arrays()
        np.testing.assert_array_equal(k1, s1_before[0])
        assert np.abs(r1 - s1_before[1]).max() > 1e-3

        # the healed cluster serves and trains end-to-end again
        out = client.pull_arrays(keys, worker_epoch=1, worker_id=0)
        assert out is not None and len(out[0]) == len(keys)
        assert client.push_arrays(0, keys, g16, worker_epoch=2)
        client.close()
    finally:
        for s in svcs:
            s.close()


def test_master_detects_shard_death_and_recovery():
    """Shards heartbeat to the master under SHARD_ID_BASE ids; silence
    flips the liveness ledger to dead (visible over the STATS wire), a
    returning beat flips it back and auto-replays missed decisions."""
    svc = ParamServerService(_mk_store(0))
    master = MasterService([svc.address], stale_after_s=0.2,
                           dead_after_s=0.4, period_s=0.05)
    admin = None
    try:
        admin = PSClient(tuple(master.address), 1)
        sid = SHARD_ID_BASE + 0
        admin.beat(sid)

        def liveness():
            return admin.stats().get("liveness", {}).get(str(sid))

        assert liveness() == "alive"
        deadline = time.time() + 5.0
        while liveness() != "dead":
            assert time.time() < deadline, "master never declared shard dead"
            time.sleep(0.05)

        # while the shard is "dead", a worker decision queues for replay
        master._broadcast("unroute", 1)

        admin.beat(sid)  # shard returns -> recover event -> flush_pending
        deadline = time.time() + 5.0
        while liveness() != "alive":
            assert time.time() < deadline, "master never saw the shard back"
            time.sleep(0.05)
        deadline = time.time() + 5.0
        while master.flush_pending() != 0:
            assert time.time() < deadline, "missed decisions never replayed"
            time.sleep(0.05)
        assert svc.ps._unrouted == {1}
    finally:
        if admin is not None:
            admin.close()
        master.close()
        svc.close()


def test_fresh_relaunched_shard_gets_dead_set_resync():
    """Routing decisions delivered to a shard's PREVIOUS incarnation die
    with that process; on the replacement's first beat the master must
    push its entire current dead-set, not just queued decisions —
    otherwise a fenced-out zombie worker's pushes land on the fresh shard
    only (silent per-shard routing divergence)."""
    svc = ParamServerService(_mk_store(0))
    host, port = svc.address
    master = MasterService([(host, port)], stale_after_s=0.2,
                           dead_after_s=0.4, period_s=0.05)
    admin = None
    try:
        admin = PSClient(tuple(master.address), 1)
        sid = SHARD_ID_BASE + 0
        admin.beat(sid)
        admin.beat(3)  # worker 3 exists...
        deadline = time.time() + 5.0
        while svc.ps._unrouted != {3}:  # ...then goes silent -> unrouted
            assert time.time() < deadline, "worker 3 never unrouted"
            time.sleep(0.05)
            admin.beat(sid)  # keep the shard alive meanwhile

        # shard dies (process gone: decisions delivered to it are lost)
        svc.close()
        deadline = time.time() + 5.0
        while admin.stats()["liveness"].get(str(sid)) != "dead":
            assert time.time() < deadline, "shard never declared dead"
            time.sleep(0.05)

        # FRESH incarnation on the same address: empty unrouted set
        svc2 = ParamServerService(_mk_store(9), host=host, port=port)
        try:
            assert svc2.ps._unrouted == set()
            admin.beat(sid)  # first beat -> recover -> dead-set resync
            deadline = time.time() + 5.0
            while svc2.ps._unrouted != {3}:
                assert time.time() < deadline, "dead-set never resynced"
                time.sleep(0.05)
                admin.beat(sid)
        finally:
            svc2.close()
    finally:
        if admin is not None:
            admin.close()
        master.close()
        svc.close()


def test_sharded_client_down_shard_stats_and_accounting(rng):
    """stats() marks a down shard with an explicit {"down": True, "addr",
    "error"} record (distinguishable from a healthy-but-empty shard)
    instead of raising; byte counters survive the client-slot teardown."""
    svcs = [ParamServerService(_mk_store(s)) for s in (0, 1)]
    client = ShardedPSClient([s.address for s in svcs], DIM)
    try:
        keys = np.arange(50, dtype=np.int64)
        client.preload_arrays(keys, np.ones((50, DIM), np.float32))
        sent_before = client.bytes_sent
        assert sent_before > 0
        svcs[1].close()
        st = client.stats()
        assert st[0]["down"] is False and "n_keys" in st[0]
        assert st[1]["down"] is True and st[1]["error"]
        assert st[1]["addr"] == list(svcs[1].address)
        assert "n_keys" not in st[1]  # down != empty
        assert client.bytes_sent >= sent_before  # accumulated, not lost
        client.close()
    finally:
        for s in svcs:
            s.close()


# -- the heartbeat race (ROADMAP §C) ------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_beat_past_the_dead_line_before_the_sweep_is_a_death_and_a_return(
        pkg):
    """``peek()`` (the STATS view) reads a peer dead from its beat age
    before the period sweep declares it.  A first beat of a fresh
    incarnation in that window refreshed the age silently in the JAX
    monitor: no death, no return, so no dead-set resync
    (``test_ps_shard_failover::test_fresh_relaunched_shard_gets_dead_set_resync``
    fails whenever its beat wins the race).  The port declares the death
    and the return, in order."""
    from lightctr_tpu.dist import bootstrap as jbootstrap

    mod = (jbootstrap.HeartbeatMonitor if pkg == "jax"
           else HeartbeatMonitor)
    clock = [0.0]
    events = []
    mon = mod(on_dead=lambda w: events.append(("dead", w)),
              on_recover=lambda w: events.append(("recover", w)),
              stale_after_s=1.0, dead_after_s=2.0, period_s=60.0,
              clock=lambda: clock[0])
    mon.beat("7")
    clock[0] = 2.5
    assert mon.peek() == {"7": "dead"} and mon.dead_workers() == set()
    mon.beat("7")
    if pkg == "jax":
        assert events == []  # the reference's race, left as it is
    else:
        assert events == [("dead", "7"), ("recover", "7")]
    assert mon.check() == {"7": "alive"} and mon.dead_workers() == set()
    # a beat inside the dead line is no death
    clock[0] = 4.0
    mon.beat("7")
    assert events[2:] == []


def test_fresh_shard_beating_before_the_sweep_gets_the_dead_set():
    """The master-level form of the race, made deterministic: no period
    sweep runs (``period_s`` 60 s), the shard is silent past the dead
    line and its fresh incarnation beats first — the master still
    resyncs the dead-set onto it."""
    svc = ParamServerService(_mk_store(0))
    host, port = svc.address
    master = MasterService([(host, port)], stale_after_s=0.2,
                           dead_after_s=0.4, period_s=60.0)
    admin = PSClient(tuple(master.address), 1)
    svc2 = None
    try:
        sid = SHARD_ID_BASE + 0
        admin.beat(sid)
        admin.beat(3)
        time.sleep(0.45)
        admin.beat(sid)
        master.monitor.check()  # worker 3 declared dead: unrouted
        assert svc.ps._unrouted == {3}
        svc.close()
        time.sleep(0.45)  # the shard past the dead line, never swept
        assert admin.stats()["liveness"][str(sid)] == "dead"
        svc2 = ParamServerService(_mk_store(9), host=host, port=port)
        assert svc2.ps._unrouted == set()
        admin.beat(sid)  # the first beat, before any sweep
        assert svc2.ps._unrouted == {3}
    finally:
        admin.close()
        master.close()
        svc.close()
        if svc2 is not None:
            svc2.close()


# -- initialize_multihost -------------------------------------------------------


def test_initialize_multihost_single_host_is_a_no_op(monkeypatch):
    """``num_processes <= 1`` and the bare call with no cluster in the
    environment join nothing (the JAX function's contract)."""
    import torch.distributed as dist

    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    initialize_multihost(num_processes=1)
    initialize_multihost()
    assert not dist.is_initialized()


def test_initialize_multihost_refuses_what_it_cannot_join(monkeypatch):
    """A world named without a rank, a rank outside it, and a coordinator
    that does not answer all raise: silent per-host forks would train
    divergent models."""
    import torch.distributed as dist

    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost(coordinator_address="127.0.0.1:1",
                             num_processes=2)
    with pytest.raises(ValueError, match="not a rank"):
        initialize_multihost(coordinator_address="127.0.0.1:1",
                             num_processes=2, process_id=2)
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))  # bound, never listening
    try:
        host, port = holder.getsockname()
        with pytest.raises(Exception):
            initialize_multihost(coordinator_address=f"{host}:{port}",
                                 num_processes=2, process_id=1,
                                 backend="gloo", timeout_s=2.0)
    finally:
        holder.close()
    assert not dist.is_initialized()


_RANK_SCRIPT = textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as dist
    from lightctr_tpu_torch.dist.bootstrap import initialize_multihost

    initialize_multihost(backend="gloo")
    initialize_multihost()  # joined already: the bare call is a no-op
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    with open(os.path.join(sys.argv[1], f"rank{dist.get_rank()}"), "w") as f:
        f.write(f"{dist.get_rank()} {dist.get_world_size()} {int(t.item())}")
    dist.destroy_process_group()
""")


def test_initialize_multihost_joins_a_launched_world(tmp_path):
    """Two processes under ``torch.distributed.run --standalone``: each
    joins through the launcher's environment and the world sums."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO_ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [(tmp_path / f"rank{r}").read_text() for r in (0, 1)]
    assert got == ["0 2 3", "1 2 3"]
