"""The port's elastic membership against the JAX package's
(``tests/test_elastic.py`` mirrored): routing tables, data-shard
assignment, the migration wire ops (MIGRATE/EVICT/GRACE/ROUTE), client
reconnect backoff, the master's delivery retries, and in-process drop and
join rebalances — the port's ``MasterService`` over the port's shards and
over the JAX package's (zero rows lost, every migration checksum
verified).  The elastic vocabulary is held equal across the packages.
"""

import os
import time

import numpy as np
import pytest

from lightctr_tpu.dist import elastic as jelastic
from lightctr_tpu.dist import ps_server as jps_server
from lightctr_tpu.embed import async_ps as jasync_ps
from lightctr_tpu_torch.ckpt import checkpoint as ckpt_mod
from lightctr_tpu_torch.dist import ps_server as tps_server
from lightctr_tpu_torch.dist.elastic import (
    RoutingTable,
    assign_data_shards,
    frame_checksum,
    plan_migration,
    shards_of_worker,
)
from lightctr_tpu_torch.dist.master import SHARD_ID_BASE, MasterService
from lightctr_tpu_torch.dist.ps_server import (
    ParamServerService,
    PSClient,
    ShardedPSClient,
)
from lightctr_tpu_torch.embed import async_ps as tasync_ps
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

#: the shards' package: (the store module, the service module)
SHARD_PKGS = {"port": (tasync_ps, tps_server), "jax": (jasync_ps, jps_server)}

DIM = 5


def _mk_svc(seed, shards="port", **kw):
    store, service = SHARD_PKGS[shards]
    return service.ParamServerService(store.AsyncParamServer(
        dim=DIM, updater="adagrad", learning_rate=0.1, n_workers=2,
        seed=seed, **kw,
    ))


def test_elastic_vocabulary_equals_the_jax_package():
    """Tables, assignments, checksums and migration plans are the JAX
    package's, value for value (the master and the shards of either
    package read each other's routing payloads)."""
    kw = dict(partition="ring", workers=[7, 3])
    addrs = {i: ("h", i) for i in range(4)}
    t = RoutingTable(1, [0, 2, 3], addrs, **kw)
    j = jelastic.RoutingTable(1, [0, 2, 3], addrs, **kw)
    assert t.to_json() == j.to_json()
    assert t.without_shard(2).to_json() == j.without_shard(2).to_json()
    assert RoutingTable.from_json(j.to_json()).to_json() == t.to_json()
    for epoch in (0, 4, 9):
        assert assign_data_shards([9, 2, 5], 7, epoch) == \
            jelastic.assign_data_shards([9, 2, 5], 7, epoch)
    for blob in (b"", b"abc", bytes(range(256)) * 3):
        assert frame_checksum(blob) == jelastic.frame_checksum(blob)
    keys = np.random.default_rng(0).integers(0, 1 << 40, 3000)
    got, want = plan_migration(keys, t), jelastic.plan_migration(keys, j)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# pure elastic vocabulary


def test_routing_table_round_trip_and_transitions():
    t = RoutingTable(0, [0, 1, 2], {i: ("h", i) for i in range(3)},
                     partition="ring", workers=[7, 3])
    back = RoutingTable.from_json(t.to_json())
    assert back.epoch == 0 and back.members == [0, 1, 2]
    assert back.workers == [3, 7]
    assert back.addresses[1] == ("h", 1)

    drop = t.without_shard(1)
    assert drop.epoch == 1 and drop.members == [0, 2] and drop.rebalancing
    # departed members keep their address slot: shard ids are stable
    assert 1 in drop.addresses

    join = drop.with_shard(3, ("h", 3))
    assert join.epoch == 2 and join.members == [0, 2, 3]

    settled = join.settled()
    assert settled.epoch == join.epoch and not settled.rebalancing

    with pytest.raises(ValueError):
        RoutingTable(0, [], {})
    with pytest.raises(ValueError):
        RoutingTable(0, [0, 5], {0: ("h", 0)})  # member without address


def test_assign_data_shards_is_deterministic_total_and_epoch_keyed():
    ws = [9, 2, 5]
    a = assign_data_shards(ws, 6, epoch=4)
    assert a == assign_data_shards([5, 9, 2], 6, epoch=4)  # order-free
    assert set(a) == set(range(6))                  # every shard assigned
    assert set(a.values()) <= set(ws)               # only live workers
    # epoch re-deals: a membership change is VISIBLE in the assignment
    assert a != assign_data_shards(ws, 6, epoch=5)
    # the per-worker view partitions the shard set exactly
    mine = [shards_of_worker(w, ws, 6, 4) for w in ws]
    assert sorted(s for m in mine for s in m) == list(range(6))
    with pytest.raises(ValueError):
        assign_data_shards([], 4, 0)


def test_frame_checksum_discriminates_and_is_stable():
    a = frame_checksum(b"hello world")
    assert a == frame_checksum(b"hello world")
    assert a != frame_checksum(b"hello worlc")
    assert frame_checksum(b"abc") != frame_checksum(b"abc\x00")  # length mix
    assert isinstance(frame_checksum(b""), int)


def test_plan_migration_partitions_exactly():
    t = RoutingTable(1, [0, 2, 3], {i: ("h", i) for i in range(4)},
                     partition="ring")
    keys = np.arange(5000, dtype=np.int64)
    plan = plan_migration(keys, t)
    got = np.sort(np.concatenate(list(plan.values())))
    np.testing.assert_array_equal(got, keys)  # every key exactly once
    assert set(plan) <= {0, 2, 3}
    assert plan_migration(np.zeros(0, np.int64), t) == {}


def test_client_refuses_partition_policy_swap(rng):
    """A routing table under a DIFFERENT partition policy is a deployment
    misconfiguration: adopting it would re-home ~the whole keyspace under
    rows placed by the old policy.  The client refuses and keeps its
    epoch."""
    svcs = [_mk_svc(s) for s in (0, 1)]
    client = ShardedPSClient([s.address for s in svcs], DIM,
                             partition="modulo")
    try:
        bad = RoutingTable(5, [0, 1], {i: svcs[i].address for i in (0, 1)},
                           partition="ring")
        assert client.apply_routing(bad) is False
        assert client.route_epoch == 0
        assert client.routing.partition_name == "modulo"
        client.close()
    finally:
        for s in svcs:
            s.close()


# ---------------------------------------------------------------------------
# wire ops against a real shard


def test_migrate_evict_grace_wire_ops(rng):
    svc = _mk_svc(0)
    c = PSClient(svc.address, DIM)
    try:
        keys = np.arange(100, dtype=np.int64)
        rows = rng.normal(size=(100, DIM)).astype(np.float32)
        rep = c.migrate_rows(keys, rows, epoch=3)
        assert rep["verified"] and rep["n"] == 100 and rep["epoch"] == 3
        assert rep["fnv"] == rep["src_fnv"]
        # rows landed (to fp16 wire precision)
        sk, sr = c.snapshot_arrays()
        np.testing.assert_array_equal(sk, keys)
        np.testing.assert_allclose(sr, rows, atol=2e-3)
        # evict removes exactly the present keys; stats reflect it
        assert c.evict(np.arange(50, 150, dtype=np.int64)) == 50
        assert c.stats()["n_keys"] == 50
        assert c.stats()["evicted_keys"] == 50
        # grace widens the SSP budget and the health detector's SLO, and
        # restores both
        base = svc.ps._base_staleness_threshold
        c.grace(3.0)
        assert svc.ps.staleness_threshold == 3 * base
        assert svc.health.detector("staleness").slo == 3 * base
        c.grace(1.0)
        assert svc.ps.staleness_threshold == base
        assert svc.health.detector("staleness").slo == base
        # migrate validates sorted-unique client-side
        with pytest.raises(ValueError, match="sorted"):
            c.migrate_rows(np.array([5, 3], np.int64),
                           np.ones((2, DIM), np.float32), epoch=0)
        # a shard with no route provider answers the sentinel
        assert c.route() == {"epoch": -1}
        c.close()
    finally:
        svc.close()


def test_psclient_rpc_survives_one_transient_connection_reset(rng):
    """Satellite contract: a single RST (service torn down and relaunched
    on the same port between two rpcs) costs one reconnect inside _rpc,
    not an error — and not a ShardedPSClient._mark_down."""
    svc = _mk_svc(0)
    host, port = svc.address
    c = PSClient((host, port), DIM, timeout=5.0)
    keys = np.arange(10, dtype=np.int64)
    c.preload_arrays(keys, np.ones((10, DIM), np.float32))
    svc.close()  # RST every established connection
    svc2 = ParamServerService(
        AsyncParamServer(dim=DIM, n_workers=2, seed=1), host=host, port=port,
    )
    try:
        out = c.pull_arrays(keys, worker_epoch=0)  # reconnects internally
        assert out is not None and len(out[0]) == 10
        assert c.reconnects == 1
        c.close()
    finally:
        svc2.close()


def test_sharded_client_retries_transient_rst_before_mark_down(rng):
    """Same contract through the fan-out path: the sharded client's send
    loop retries a failed shard once (reconnect + resend) before the
    shard is declared down, so a one-off RST never surfaces as a failed
    batch."""
    svcs = [_mk_svc(s) for s in (0, 1)]
    client = ShardedPSClient([s.address for s in svcs], DIM)
    keys = np.arange(40, dtype=np.int64)
    client.preload_arrays(keys, np.ones((40, DIM), np.float32))
    host, port = svcs[1].address
    svcs[1].close()
    svc_new = ParamServerService(
        AsyncParamServer(dim=DIM, n_workers=2, seed=9), host=host, port=port,
    )
    try:
        # re-seed the relaunched (empty) shard through FRESH connections,
        # so only the original client's stale transport sees the RST
        seeder = ShardedPSClient([svcs[0].address, svc_new.address], DIM)
        seeder.preload_arrays(keys, np.ones((40, DIM), np.float32))
        seeder.close()
        out = client.pull_arrays(keys, worker_epoch=0)
        assert out is not None, "transient RST surfaced as a failed batch"
        assert client.clients[1] is not None  # never left marked down
        np.testing.assert_allclose(out[1], np.ones((40, DIM)), atol=2e-3)
        client.close()
    finally:
        svcs[0].close()
        svc_new.close()


def test_master_delivery_backoff_counts_retries_and_exhaustion():
    """_deliver retries are paced (capped exponential backoff + jitter)
    and counted; exhausting them increments the exhaustion counter."""
    import socket

    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))  # bound, not listening: refuses instantly
    master = MasterService([holder.getsockname()], period_s=60.0,
                           shard_rpc_timeout_s=0.5)
    try:
        t0 = time.monotonic()
        ok = master._deliver(0, "unroute", 1)
        dt = time.monotonic() - t0
        assert not ok
        snap = master.registry.snapshot()["counters"]
        assert snap.get("master_delivery_retries_total", 0) == 2
        assert snap.get("master_delivery_exhausted_total", 0) == 1
        # the backoff actually paced the retries (2 sleeps >= ~25ms each)
        assert dt >= 0.04
    finally:
        master.close()
        holder.close()


# ---------------------------------------------------------------------------
# in-process rebalances (the fast form of the chaos drills)


@pytest.mark.parametrize("shards", ["port", "jax"])
def test_master_drop_rebalance_from_checkpoint(tmp_path, rng, shards):
    """Shard dies -> master migrates its checkpointed rows to the ring
    successors (verified), publishes the epoch, and a routed client
    resumes serving EVERY key; the port's master over either package's
    shards."""
    svcs = [_mk_svc(s, shards) for s in (0, 1, 2)]
    master = MasterService(
        [s.address for s in svcs], stale_after_s=0.3, dead_after_s=0.6,
        period_s=0.05, shard_rpc_timeout_s=2.0, elastic=True,
        partition="ring", dim=DIM, ckpt_dir=str(tmp_path),
    )
    admin = PSClient(tuple(master.address), DIM)
    client = ShardedPSClient([s.address for s in svcs], DIM,
                             partition="ring")
    client.attach_route_source(admin.route)
    try:
        keys = np.arange(300, dtype=np.int64)
        rows = rng.normal(size=(300, DIM)).astype(np.float32)
        client.preload_arrays(keys, rows)
        # register every shard with the liveness ledger: death detection
        # (and therefore the rebalance) only fires for peers it has SEEN
        for i in range(3):
            admin.beat(SHARD_ID_BASE + i)
        time.sleep(0.1)
        for i in range(3):
            k, r = PSClient(svcs[i].address, DIM).snapshot_arrays()
            ckpt_mod.save_arrays(os.path.join(str(tmp_path), f"shard_{i}"),
                                 1, k, r)
        victim_rows = ckpt_mod.load_latest_arrays(
            os.path.join(str(tmp_path), "shard_1"))[1]

        svcs[1].close()
        deadline = time.time() + 10
        while (1 in master.routing.members or master.routing.rebalancing):
            assert time.time() < deadline, "drop rebalance never completed"
            admin.beat(SHARD_ID_BASE + 0)
            admin.beat(SHARD_ID_BASE + 2)
            time.sleep(0.05)

        assert master.routing.members == [0, 2]
        recs = [m for m in master.migrations
                if m["reason"] == "shard_death"]
        assert recs and all(m["verified"] for m in recs)
        assert sum(m["n"] for m in recs) == len(victim_rows)  # zero loss

        out = client.pull_arrays(keys, worker_epoch=0, worker_id=0)
        if out is None:  # first call swaps the route, second serves
            out = client.pull_arrays(keys, worker_epoch=0, worker_id=0)
        assert out is not None
        np.testing.assert_allclose(out[1], rows, atol=2e-3)
        assert client.route_epoch == master.routing.epoch
    finally:
        client.close()
        admin.close()
        master.close()
        for i in (0, 2):
            svcs[i].close()


@pytest.mark.parametrize("shards", ["port", "jax"])
def test_master_admit_shard_join_migration(rng, shards):
    """admit_shard moves exactly the joiner's ring share over (donors
    evict it), publishes the epoch, and values survive to fp16; the
    port's master over either package's shards."""
    svcs = [_mk_svc(s, shards) for s in (0, 1)]
    master = MasterService([s.address for s in svcs], period_s=60.0,
                           elastic=True, partition="ring", dim=DIM,
                           shard_rpc_timeout_s=2.0)
    client = ShardedPSClient([s.address for s in svcs], DIM,
                             partition="ring")
    admin = PSClient(tuple(master.address), DIM)
    client.attach_route_source(admin.route)
    new_svc = _mk_svc(9, shards)
    try:
        keys = np.arange(600, dtype=np.int64)
        rows = rng.normal(size=(600, DIM)).astype(np.float32)
        client.preload_arrays(keys, rows)

        sid = master.admit_shard(new_svc.address)
        assert sid == 2 and master.routing.members == [0, 1, 2]
        assert all(m["verified"] for m in master.migrations)

        nk = PSClient(new_svc.address, DIM).snapshot_arrays()[0]
        k0 = PSClient(svcs[0].address, DIM).snapshot_arrays()[0]
        k1 = PSClient(svcs[1].address, DIM).snapshot_arrays()[0]
        assert len(nk) > 0
        # disjoint cover: donors evicted what they handed off
        assert len(nk) + len(k0) + len(k1) == len(keys)
        assert not (set(nk) & set(k0)) and not (set(nk) & set(k1))

        client.refresh_route()
        assert client.members == [0, 1, 2]
        out = client.pull_arrays(keys, worker_epoch=0)
        np.testing.assert_allclose(out[1], rows, atol=2e-3)
    finally:
        client.close()
        admin.close()
        master.close()
        for s in svcs:
            s.close()
        new_svc.close()


def test_worker_join_leave_bump_membership_epoch():
    """Elastic worker membership: first beat -> join (epoch bump, worker
    in the table), heartbeat death -> leave (epoch bump, worker out) —
    the data-shard map every worker derives follows the epoch."""
    svc = _mk_svc(0)
    master = MasterService([svc.address], stale_after_s=0.2,
                           dead_after_s=0.4, period_s=0.05, elastic=True,
                           partition="ring", dim=DIM,
                           shard_rpc_timeout_s=1.0)
    admin = PSClient(tuple(master.address), DIM)
    try:
        e0 = master.routing.epoch
        admin.beat(3)
        deadline = time.time() + 5
        while 3 not in master.routing.workers:
            assert time.time() < deadline, "worker join never published"
            time.sleep(0.02)
        e_join = master.routing.epoch
        assert e_join > e0

        # silence -> dead -> leave
        deadline = time.time() + 5
        while 3 in master.routing.workers:
            assert time.time() < deadline, "worker leave never published"
            admin.beat(SHARD_ID_BASE + 0)  # keep the shard alive
            time.sleep(0.05)
        assert master.routing.epoch > e_join
    finally:
        admin.close()
        master.close()
        svc.close()
