"""The port's hierarchical two-level exchange against the JAX package's
(``tests/test_hier_exchange.py`` mirrored):

  - the reduce rendezvous (``dist/hier.py``): every shard and client case,
    each run with the port's shard and client and across packages (a port
    client against a JAX shard, a JAX client against a port shard);
  - the frames: the same exchanges through a port client and shard and
    through a JAX client and shard send and answer the same bytes, every
    codec (f32, f16, q8_ef, q4_ef), grouped and chunked;
  - the trainer (``SparseTableCTRTrainer(hier_exchange=...)``): two hosts,
    each a spawned world of gloo ranks on the CPU
    (``tests/torch_hier_worlds.py``), against the JAX single-device trainer
    on the whole batch — losses within rtol 1e-4 / atol 1e-6, tables
    within rtol 1e-4 / atol 1e-5 (the JAX test's bounds), every rank of
    both hosts bit-identical; the q8_ef wire within atol 2e-3 of it; the
    local overflow fallback; the refused configurations; a pull withheld
    past its timeout failing every rank of the host; and the wire bytes
    flat within +-10 % from 2 to 4 local ranks.
"""

import ast
import datetime
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_hier_worlds as worlds
from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu import obs as jobs
from lightctr_tpu.dist import hier as jhier
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.mesh import Mesh, MeshSpec, make_mesh, spawn_world
from lightctr_tpu_torch.dist import hier as thier
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.obs import labeled

#: (shard module, client module) of the rendezvous cases: the port alone,
#: then the port's client against a JAX shard and a JAX client against
#: the port's shard
PAIRS = [(thier, thier), (jhier, thier), (thier, jhier)]
PAIR_IDS = ["port", "port_client_jax_shard", "jax_client_port_shard"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# -- the reduce rendezvous -------------------------------------------------


@pytest.mark.parametrize("S, C", PAIRS, ids=PAIR_IDS)
def test_reduce_shard_merges_rounds_and_withholds(S, C):
    """A pull before both pushes land is WITHHELD; once complete, every
    host pulls the identical merged union (duplicate ids summed in host
    order); a retried pull is served; the epoch-lag GC reaps the round."""
    shard = S.SparseReduceShard(n_hosts=2)
    c0 = C.HierExchangeClient([shard.address], host_id=0, n_hosts=2,
                              pull_timeout_s=5.0)
    c1 = C.HierExchangeClient([shard.address], host_id=1, n_hosts=2,
                              pull_timeout_s=5.0)
    try:
        u0 = np.array([1, 2, 5], np.int64)
        r0 = np.arange(6, dtype=np.float32).reshape(3, 2)
        u1 = np.array([2, 3], np.int64)
        r1 = np.ones((2, 2), np.float32)
        c0.push(0, u0, r0, epoch=0)
        lone = C.HierExchangeClient([shard.address], 0, 2,
                                    pull_timeout_s=0.05)
        with pytest.raises(TimeoutError):
            lone.pull(0, 0, 2)
        lone.close()
        assert shard.stats()["withheld"] >= 1
        c1.push(0, u1, r1, epoch=0)
        g0 = c0.pull(0, 0, 2)
        g1 = c1.pull(0, 0, 2)
        np.testing.assert_array_equal(g0[0], [1, 2, 3, 5])
        np.testing.assert_allclose(
            g0[1], [[0, 1], [3, 4], [1, 1], [4, 5]], rtol=0, atol=0)
        np.testing.assert_array_equal(g0[0], g1[0])
        np.testing.assert_allclose(g0[1], g1[1], rtol=0, atol=0)
        g0_again = c0.pull(0, 0, 2)
        np.testing.assert_array_equal(g0_again[0], g0[0])
        c0.push(1, u0[:1], r0[:1], epoch=shard.ROUND_GC_LAG + 1)
        assert (0, 0) not in shard._rounds
    finally:
        c0.close()
        c1.close()
        shard.close()


@pytest.mark.parametrize("S, C", PAIRS, ids=PAIR_IDS)
def test_reduce_client_owner_partitions_across_shards(S, C):
    """Two shards: uids split by ``uid % n_shards``, empty per-shard
    frames still check in, the spliced pull is globally sorted; f32 and
    f16 round-trip."""
    shards = [S.SparseReduceShard(n_hosts=1) for _ in range(2)]
    addrs = [s.address for s in shards]
    try:
        for codec, atol in (("f32", 0.0), ("f16", 1e-2)):
            c = C.HierExchangeClient(addrs, host_id=0, n_hosts=1,
                                     codec=codec)
            uids = np.array([3, 4, 7, 10, 21], np.int64)
            rows = np.linspace(-1, 1, 15).astype(np.float32).reshape(5, 3)
            gu, gr = c.exchange(5 if codec == "f16" else 4, uids, rows,
                                epoch=0)
            np.testing.assert_array_equal(gu, uids)
            np.testing.assert_allclose(gr, rows, rtol=0, atol=atol)
            c.close()
        c = C.HierExchangeClient(addrs, host_id=0, n_hosts=1)
        uids = np.array([2, 4], np.int64)
        gu, gr = c.exchange(6, uids, np.ones((2, 1), np.float32), epoch=1)
        np.testing.assert_array_equal(gu, uids)
        c.close()
    finally:
        for s in shards:
            s.close()


@pytest.mark.parametrize("S, C", PAIRS, ids=PAIR_IDS)
def test_reduce_shard_rejects_malformed_and_counts(S, C):
    """Unsorted push keys are refused; the bandwidth probe rides
    single-contributor negative-epoch rounds, exempt from the GC."""
    shard = S.SparseReduceShard(n_hosts=2)
    c = C.HierExchangeClient([shard.address], host_id=0, n_hosts=2)
    try:
        with pytest.raises(ValueError, match="sorted unique"):
            c.push(0, np.array([5, 3], np.int64),
                   np.ones((2, 2), np.float32), epoch=0)
        assert c.probe_bw(payload_bytes=1 << 14, reps=2) > 0
        assert shard.stats()["rounds_open"] == 0
        c.push(2, np.array([2], np.int64), np.ones((1, 2), np.float32),
               epoch=40)
        assert c.probe_bw(payload_bytes=1 << 12, reps=1) > 0
    finally:
        c.close()
        shard.close()


@pytest.mark.parametrize("S, C", PAIRS, ids=PAIR_IDS)
def test_chunked_striped_exchange_matches_single_shot_bit_identical(
        S, C, rng):
    """The same two-host contribution pushed single-shot to one shard and
    chunked into 3-row windows across two striped shards pulls back the
    bit-identical union; the chunk-fill and per-stripe counters land."""
    dim, n = 5, 23
    uids = [np.unique(rng.integers(1, 200, 40))[:n].astype(np.int64),
            np.unique(rng.integers(1, 200, 40))[:n].astype(np.int64)]
    rows = [rng.normal(size=(u.size, dim)).astype(np.float32)
            for u in uids]
    # the client's package owns the registry its counters land in
    gate = obs if C is thier else jobs

    def run(n_shards, chunk_rows):
        shards = [S.SparseReduceShard(n_hosts=2) for _ in range(n_shards)]
        regs = [gate.MetricsRegistry(), gate.MetricsRegistry()]
        cs = [C.HierExchangeClient([s.address for s in shards], host_id=h,
                                   n_hosts=2, chunk_rows=chunk_rows,
                                   registry=regs[h])
              for h in (0, 1)]
        try:
            for h in (0, 1):
                cs[h].push_async(0, uids[h], rows[h], epoch=0)
            got = [cs[h].pull(0, 0, dim) for h in (0, 1)]
            stats = [s.stats() for s in shards]
            counters = (cs[0].chunk_pushes_total, cs[0].chunk_rows_total,
                        cs[0].chunk_capacity_rows_total)
            snap = regs[0].snapshot()["counters"]
        finally:
            for c in cs:
                c.close()
            for s in shards:
                s.close()
        return got, stats, counters, snap

    with gate.override(True):
        base, _, base_counters, _ = run(n_shards=1, chunk_rows=None)
        got, stats, counters, snap = run(n_shards=2, chunk_rows=3)
    for g in (base[1], got[0], got[1]):
        np.testing.assert_array_equal(base[0][0], g[0])
        np.testing.assert_array_equal(base[0][1], g[1])
    assert all(s["streaming"] for s in stats)
    assert all(s["peak_round_bytes"] > 0 for s in stats)
    assert counters[0] > base_counters[0]
    assert counters[2] >= counters[1] == n
    assert base_counters[2] == base_counters[1] == n
    for s in ("0", "1"):
        assert snap[labeled("hier_stripe_push_bytes_total", stripe=s)] > 0
        assert snap[labeled("hier_stripe_pull_bytes_total", stripe=s)] > 0


def test_streaming_out_of_order_duplicate_and_skewed_chunks(rng):
    """Chunks in any order, a duplicate counted once, completion at every
    host's declared total, a chunk-count skew refused, the arrival ring's
    per-chunk timeline."""
    dim = 3
    shard = thier.SparseReduceShard(n_hosts=2)
    try:
        u = np.arange(1, 10, dtype=np.int64)
        r = rng.normal(size=(9, dim)).astype(np.float32)
        chunks = [(u[0:3], r[0:3]), (u[3:6], r[3:6]), (u[6:9], r[6:9])]
        shard._push(0, 0, 7, *chunks[2], dim, chunk=(2, 3))
        assert shard._pull(0, 0, 7) is None
        shard._push(0, 0, 7, *chunks[0], dim, chunk=(0, 3))
        shard._push(0, 0, 7, *chunks[0], dim, chunk=(0, 3))
        with pytest.raises(ValueError, match="chunk-count skew"):
            shard._push(0, 0, 7, *chunks[1], dim, chunk=(1, 4))
        shard._push(0, 0, 7, *chunks[1], dim, chunk=(1, 3))
        assert shard._pull(0, 0, 7) is None
        u1 = np.array([2, 5, 40], np.int64)
        r1 = rng.normal(size=(3, dim)).astype(np.float32)
        shard._push(1, 0, 7, u1, r1, dim, chunk=(0, 1))
        ku, kr = shard._pull(0, 0, 7)
        want_u = np.unique(np.concatenate([u, u1]))
        want = np.zeros((want_u.size, dim), np.float32)
        want[np.searchsorted(want_u, u)] += r
        want[np.searchsorted(want_u, u1)] += r1
        np.testing.assert_array_equal(ku, want_u)
        np.testing.assert_allclose(kr, want, rtol=0, atol=0)
        entry = shard.stats()["arrivals"][-1]
        assert entry["epoch"] == 0
        assert entry["chunks"] == {"0": 3, "1": 1}
        assert set(entry["arrivals"]) == {"0", "1"}
        for h in ("0", "1"):
            assert entry["last"][h] >= entry["arrivals"][h]
        assert entry["wait_s"] == max(entry["arrivals"].values())
    finally:
        shard.close()


def test_barrier_mode_chunk_merge_and_streaming_memory_flat(rng):
    """streaming=False buffers chunks and merges at the first pull; both
    modes agree on grid values; the streaming peak stays flat (+-10 %)
    from 2 to 4 hosts while the barrier buffer grows."""
    dim, n = 4, 30
    u = np.arange(1, n + 1, dtype=np.int64)

    def run(streaming, n_hosts):
        shard = thier.SparseReduceShard(n_hosts=n_hosts, streaming=streaming)
        try:
            for h in range(n_hosts):
                r = (rng.integers(-8, 9, size=(n, dim)) * 0.25
                     ).astype(np.float32)
                for ci in range(3):
                    lo, hi = ci * 10, (ci + 1) * 10
                    shard._push(h, 0, 0, u[lo:hi], r[lo:hi], dim,
                                chunk=(ci, 3))
            return shard._pull(0, 0, 0), shard.stats()
        finally:
            shard.close()

    state = rng.bit_generator.state
    (su, sr), s_stats = run(streaming=True, n_hosts=2)
    rng.bit_generator.state = state
    (bu, br), b_stats = run(streaming=False, n_hosts=2)
    assert s_stats["streaming"] and not b_stats["streaming"]
    np.testing.assert_array_equal(su, bu)
    np.testing.assert_array_equal(sr, br)
    _, s2 = run(streaming=True, n_hosts=2)
    _, s4 = run(streaming=True, n_hosts=4)
    p2, p4 = s2["peak_round_bytes"], s4["peak_round_bytes"]
    assert abs(p4 - p2) <= 0.1 * p2, (p2, p4)
    _, b4 = run(streaming=False, n_hosts=4)
    assert b4["peak_round_bytes"] > 1.5 * p4


@pytest.mark.parametrize("S, C", PAIRS, ids=PAIR_IDS)
def test_owner_coded_encode_once_under_chunked_pushes(S, C, rng):
    """q8_ef / q4_ef: one owner-side encode a round however many chunks
    fed it, byte-identical code sections for every host and retry, and
    the owner carry advancing once a round."""
    dim = 6
    for codec in ("q8_ef", "q4_ef"):
        shard = S.SparseReduceShard(n_hosts=2)
        cs = [C.HierExchangeClient([shard.address], host_id=h, n_hosts=2,
                                   codec=codec, chunk_rows=2)
              for h in (0, 1)]
        try:
            u = np.arange(1, 8, dtype=np.int64)
            r = (0.1 * rng.normal(size=(7, dim))).astype(np.float32)
            outs = []
            for epoch in (0, 1):
                for h in (0, 1):
                    cs[h].push(0, u, r, epoch=epoch)
                raw = [shard._pull(h, epoch, 0, coded=True,
                                   bits=cs[0]._coded_bits) for h in (0, 1)]
                assert raw[0] == raw[1]
                assert shard._pull(0, epoch, 0, coded=True,
                                   bits=cs[0]._coded_bits) == raw[0]
                outs.append(raw[0])
                got = [cs[h].pull(0, epoch, dim) for h in (0, 1)]
                np.testing.assert_array_equal(got[0][0], got[1][0])
                np.testing.assert_array_equal(got[0][1], got[1][1])
            stats = shard.stats()
            assert stats["coded_rounds"] == 2
            assert outs[0] != outs[1]
            assert 0.0 < stats["owner_ef_mass"]["0"] < 2.0
            assert cs[0].carry_mass() > 0.0
        finally:
            for c in cs:
                c.close()
            shard.close()


def test_client_opens_no_socket_until_it_talks():
    """Every rank of a host builds the same client; only the rank that
    runs the wire hop connects (the transports open at first use)."""
    shard = thier.SparseReduceShard(n_hosts=1)
    try:
        idle = thier.HierExchangeClient([shard.address], host_id=0,
                                        n_hosts=1)
        assert not idle.connected and idle.bytes_sent == 0
        idle.close()
        busy = thier.HierExchangeClient([shard.address], host_id=0,
                                        n_hosts=1)
        busy.exchange(0, np.array([1], np.int64),
                      np.ones((1, 2), np.float32), epoch=0)
        assert busy.connected and busy.bytes_sent > 0
        busy.close()
    finally:
        shard.close()


# -- the frames, byte for byte ---------------------------------------------


def _record(client, log):
    """Wrap every transport's ``_rpc`` to log (type, request, reply) in
    ``log[shard]``: a shard's frames go out in order (one FIFO stripe a
    shard), different shards' concurrently."""
    for s, c in enumerate(client.clients):
        rpc = c._rpc

        def rec(t, payload, _rpc=rpc, _s=s):
            reply = _rpc(t, payload)
            log.setdefault(_s, []).append((t, bytes(payload), bytes(reply)))
            return reply

        c._rpc = rec


def _frames(mod, codec, chunk_rows):
    """Two hosts' pushes (a table, a grouped pair, the exact dense stream)
    then every pull, through ``mod``'s client and shards -> each host's
    logged frames by shard."""
    rng = np.random.default_rng(3)
    shards = [mod.SparseReduceShard(n_hosts=2) for _ in range(2)]
    cs = [mod.HierExchangeClient([s.address for s in shards], host_id=h,
                                 n_hosts=2, codec=codec,
                                 chunk_rows=chunk_rows)
          for h in (0, 1)]
    log = ({}, {})
    try:
        for c, lg in zip(cs, log):
            _record(c, lg)
        for epoch in (0, 1):
            for h, c in enumerate(cs):
                u = np.unique(rng.integers(1, 300, 40)).astype(np.int64)
                r = rng.normal(size=(len(u), 4)).astype(np.float32)
                c.push(0, u, r, epoch)
                c.push_group([1, 2], u, [r, r[:, :3] * 2], epoch)
                c.push(7, np.arange(5, dtype=np.int64),
                       rng.normal(size=(5, 1)).astype(np.float32), epoch,
                       exact=True)
            for c in cs:
                c.pull(0, epoch, 4)
                c.pull_group([1, 2], epoch, [4, 3])
                c.pull(7, epoch, 1, exact=True)
    finally:
        for c in cs:
            c.close()
        for s in shards:
            s.close()
    return log


@pytest.mark.parametrize("codec, chunk_rows", [
    ("f32", None), ("f16", None), ("q8_ef", None), ("q4_ef", None),
    ("f32", 8), ("q8_ef", 8)])
def test_frames_are_byte_identical_across_packages(codec, chunk_rows):
    """Every request and every reply of the same exchanges, the port's
    client and shards against the JAX package's, byte for byte."""
    port = _frames(thier, codec, chunk_rows)
    ref = _frames(jhier, codec, chunk_rows)
    assert len(port[0]) == 2 and len(port[0][1]) > 0
    assert port == ref


# -- the trainer over two spawned hosts ---------------------------------------


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """{case: {host: [rank results]}} of the two host worlds, and the
    shards' stats read before they closed."""
    out = tmp_path_factory.mktemp("hier")
    shards, addrs, stats = {}, {}, {}
    for name, case in worlds.HIER_CASES.items():
        mod = jhier if case["shards"] == "jax" else thier
        shards[name] = [mod.SparseReduceShard(n_hosts=2)
                        for _ in range(case["n_shards"])]
    shards["lone"] = [thier.SparseReduceShard(n_hosts=2)]
    for name, ss in shards.items():
        addrs[name] = [tuple(s.address) for s in ss]
    errors = []

    def run(h):
        try:
            spawn_world(worlds.hier_rank, worlds.WORLD, "gloo",
                        args=(h, str(out), addrs),
                        deadline_s=worlds.DEADLINE_S)
        except BaseException as e:  # surfaced below
            errors.append((h, repr(e)))

    threads = [threading.Thread(target=run, args=(h,)) for h in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for name, ss in shards.items():
            stats[name] = [s.stats() for s in ss]
    finally:
        for ss in shards.values():
            for s in ss:
                s.close()
    assert not errors, errors
    res = {h: [torch.load(out / f"host{h}_rank{r}.pt", weights_only=False)
               for r in range(worlds.WORLD)] for h in (0, 1)}
    by_case = {name: {h: [res[h][r][name] for r in range(case["local_n"])]
                      for h in (0, 1)}
               for name, case in worlds.HIER_CASES.items()}
    by_case["lone"] = [res[0][r]["lone"] for r in range(2)]
    return by_case, stats


def _oracle(case):
    """The JAX single-device trainer on the whole batch."""
    params = {k: jnp.asarray(v) for k, v in
              worlds.fm_params(case["f"], case["dim"]).items()}
    tr = JSparseTrainer(params, jfm.logits,
                        JConfig(learning_rate=case["lr"]),
                        sparse_tables=worlds.TABLES,
                        fused_fn=jfm.logits_with_l2)
    tr.health = None
    full = worlds.case_batch(case)
    losses = [float(tr.train_step(full)) for _ in range(case["steps"])]
    return np.asarray(losses), {k: np.asarray(tr.params[k])
                                for k in ("w", "v")}


def _assert_all_ranks_identical(runs):
    want = runs[0][0]
    for h in (0, 1):
        for r, got in enumerate(runs[h]):
            np.testing.assert_array_equal(got["losses"], want["losses"])
            for k in ("w", "v"):
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"host {h} rank {r}")


@pytest.mark.parametrize("name", ["r2", "r4"])
def test_hier_trainer_matches_single_process_oracle(hosts, name):
    """2 hosts x {2, 4} local ranks: the trajectory equals the JAX
    single-device full-batch trainer's within the JAX test's bounds,
    every rank of both hosts ends bit-identical, the policy is ``hier``
    and the per-hop counters land (the r4 hosts against JAX shards)."""
    by_case, _ = hosts
    case = worlds.HIER_CASES[name]
    runs = by_case[name]
    o_losses, o_params = _oracle(case)
    _assert_all_ranks_identical(runs)
    r0 = runs[0][0]
    np.testing.assert_allclose(r0["losses"], o_losses, rtol=1e-4, atol=1e-6)
    for k in ("w", "v"):
        np.testing.assert_allclose(r0[k], o_params[k], rtol=1e-4, atol=1e-5)
    for h in (0, 1):
        for r, rec in enumerate(runs[h]):
            assert rec["policy"] == {"w": "hier", "v": "hier"}
            # only local rank 0 of a host opened the wire
            assert rec["connected"] == (r == 0)
    assert r0["local_policy"]["w"] in ("sparse", "sparse_rs")
    assert all(b > 0 for b in r0["bytes_per_step"].values())
    c = r0["snapshot"]["counters"]
    assert c["trainer_hier_wire_bytes_total"] > 0
    assert c["trainer_hier_local_bytes_total"] > 0
    assert c[labeled("trainer_exchange_algo_total", table="v",
                     algo="hier")] == case["steps"]
    # the other ranks count the host's wire numbers too (broadcast)
    assert runs[0][1]["snapshot"]["counters"][
        "trainer_hier_wire_packed_bytes_total"] == \
        c["trainer_hier_wire_packed_bytes_total"] > 0


def test_two_process_hier_wire_bytes_flat_in_local_ranks(hosts):
    """The acceptance: the per-host batch is fixed, so doubling the local
    ranks must not move the wire bytes beyond +-10 %, in the model and on
    the sockets."""
    by_case, _ = hosts
    h2, h4 = by_case["r2"][0][0], by_case["r4"][0][0]
    w2, w4 = float(h2["wire_model_bytes"]), float(h4["wire_model_bytes"])
    assert abs(w4 - w2) <= 0.1 * w2, (w2, w4)
    s2, s4 = float(h2["socket_bytes"]), float(h4["socket_bytes"])
    assert abs(s4 - s2) <= 0.1 * s2, (s2, s4)


@pytest.mark.parametrize("name", ["q8", "qs"])
def test_hier_coded_wire_tracks_oracle_and_carries_drain(hosts, name):
    """codec="q8_ef" (and its chunked, striped form): every rank of both
    hosts bit-identical, the losses within atol 2e-3 of the JAX oracle and
    of the fp32 wire, member carries sub-bucket, owner carries drained,
    the socket bytes under 0.4 (0.5 chunked) of the fp32 wire's, shared
    id bytes saved."""
    by_case, stats = hosts
    case = worlds.HIER_CASES[name]
    runs = by_case[name]
    _assert_all_ranks_identical(runs)
    r0 = runs[0][0]
    o_losses, _ = _oracle(case)
    np.testing.assert_allclose(r0["losses"], o_losses, rtol=0, atol=2e-3)
    np.testing.assert_allclose(r0["losses"], by_case["r2"][0][0]["losses"],
                               rtol=0, atol=2e-3)
    assert 0.0 < r0["carry_mass"] < 1.0
    for t, m in r0["carry_max"].items():
        assert m < 5e-3, (t, m)
    assert sum(s["coded_rounds"] for s in stats[name]) >= 2 * case["steps"]
    for s in stats[name]:
        assert s["owner_ef_mass"]
        for t, m in s["owner_ef_mass"].items():
            assert m < 2.0, (t, m)
    s2 = float(by_case["r2"][0][0]["socket_bytes"])
    bound = 0.4 if case["chunk_rows"] is None else 0.5
    assert r0["socket_bytes"] < bound * s2, (r0["socket_bytes"], s2)
    assert r0["id_saved"] > 0
    c = r0["snapshot"]["counters"]
    assert c["trainer_hier_wire_fp32_bytes_total"] > \
        3.0 * c["trainer_hier_wire_packed_bytes_total"] > 0
    if case["chunk_rows"] is not None:
        assert r0["chunk_pushes"] > by_case["q8"][0][0]["chunk_pushes"]
        assert 0 < r0["chunk_rows"] <= r0["chunk_capacity"]


def test_hier_trainer_local_overflow_falls_back_to_allgather(hosts):
    """Host 0's ids skewed onto local owner 0 overflow the local
    reduce-scatter: its local merge falls back to the allgather every
    step, host 1's never does, and the trajectory still matches the
    oracle."""
    by_case, _ = hosts
    case = worlds.HIER_CASES["fb"]
    runs = by_case["fb"]
    h0, h1 = runs[0][0], runs[1][0]
    assert h0["plan"]["v"][1] == "sparse_rs", h0["plan"]
    assert not h0["fits"] and h1["fits"]
    assert h0["snapshot"]["counters"]["trainer_rs_fallback_total"] == \
        case["steps"]
    assert "trainer_rs_fallback_total" not in h1["snapshot"]["counters"]
    assert h0["fb_local_policy"]["v"] == "sparse"
    assert h1["local_policy"]["v"] == "sparse_rs"
    _assert_all_ranks_identical(runs)
    o_losses, o_params = _oracle(case)
    np.testing.assert_allclose(h0["losses"], o_losses, rtol=1e-4, atol=1e-6)
    for k in ("w", "v"):
        np.testing.assert_allclose(h0[k], o_params[k], rtol=1e-4, atol=1e-5)


def test_a_withheld_pull_fails_every_rank_of_the_host(hosts):
    """Host 0 alone against shards that wait for two: rank 0's pull times
    out, the broadcast carries the failure, and no rank applies a stale
    union."""
    by_case, _ = hosts
    r0, r1 = by_case["lone"]
    assert r0["error"].startswith("TimeoutError"), r0["error"]
    assert r1["error"].startswith("RuntimeError"), r1["error"]
    assert "wire hop failed" in r1["error"]
    assert not r0["v_moved"] and not r1["v_moved"]
    assert r0["connected"] and not r1["connected"]


# -- refused configurations -----------------------------------------------------


@pytest.fixture
def one_rank_world(monkeypatch):
    """A gloo process group of one rank in this process (no port)."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.HashStore(), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_hier_trainer_rejects_unsupported_configs(one_rank_world):
    shard = thier.SparseReduceShard(n_hosts=1)
    client = thier.HierExchangeClient([shard.address], host_id=0, n_hosts=1)
    params = tfm.params_from_numpy(worlds.fm_params(64, 4), "cpu")
    mesh = make_mesh(MeshSpec(data=1), device="cpu")
    kw = dict(sparse_tables=worlds.TABLES, device="cpu")
    try:
        with pytest.raises(ValueError, match="mesh"):
            SparseTableCTRTrainer(params, tfm.logits, TrainConfig(),
                                  hier_exchange=client, **kw)
        with pytest.raises(ValueError, match="compress_bits"):
            SparseTableCTRTrainer(params, tfm.logits, TrainConfig(),
                                  mesh=mesh, compress_bits=8,
                                  hier_exchange=client, **kw)
        with pytest.raises(ValueError, match="mesh"):
            SparseTableCTRTrainer(params, tfm.logits, TrainConfig(),
                                  mesh=mesh, param_shardings={},
                                  hier_exchange=client, **kw)
        tr = SparseTableCTRTrainer(params, tfm.logits, TrainConfig(),
                                   mesh=mesh, hier_exchange=client, **kw)
        with pytest.raises(ValueError, match="scan"):
            tr.fit_fullbatch_scan(worlds.fm_batch(0, 16, 64, 4), 2)
        assert isinstance(tr.mesh, Mesh) and not client.connected
    finally:
        client.close()
        shard.close()


# -- series declarations ------------------------------------------------------


PORT_ROOT = Path(__file__).resolve().parent.parent / "lightctr_tpu_torch"


def _emitted(path: Path, prefixes) -> set:
    """Series names starting with one of ``prefixes`` that reach a
    registry ``inc``/``gauge_set``/``observe``: string constants in the
    first argument (through ``labeled(...)`` too), and the values of a
    module-level name table the argument reads (the trainer's byte
    counter by policy)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    tables = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(
                node.value, ast.Dict):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    tables[t.id] = node.value
    out = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("inc", "gauge_set", "observe")
                and node.args):
            continue
        for sub in ast.walk(node.args[0]):
            if isinstance(sub, ast.Name) and sub.id in tables:
                sub = tables[sub.id]
            for c in ast.walk(sub):
                if isinstance(c, ast.Constant) and isinstance(c.value, str) \
                        and c.value.startswith(prefixes):
                    out.add(c.value)
    return out


def test_every_exchange_round_and_cluster_series_is_declared_and_emitted():
    """No dark series: the trainer's ``trainer_*`` names, the rendezvous'
    ``hier_round_*`` / ``hier_stripe_*`` and the rollup's ``cluster_*``
    are each used exactly as declared, and declared as the JAX package
    declares them."""
    from lightctr_tpu.models import sparse_trainer as jst
    from lightctr_tpu.obs import cluster as jcl
    from lightctr_tpu_torch.models import sparse_trainer as tst
    from lightctr_tpu_torch.obs import cluster as tcl

    cases = [
        (PORT_ROOT / "models" / "sparse_trainer.py", ("trainer_",),
         tst.EXCHANGE_SERIES, jst.EXCHANGE_SERIES, "EXCHANGE_SERIES"),
        (PORT_ROOT / "dist" / "hier.py", ("hier_round_", "hier_stripe_"),
         thier.HIER_ROUND_SERIES, jhier.HIER_ROUND_SERIES,
         "HIER_ROUND_SERIES"),
        (PORT_ROOT / "obs" / "cluster.py", ("cluster_",),
         tcl.CLUSTER_SERIES, jcl.CLUSTER_SERIES, "CLUSTER_SERIES"),
    ]
    for path, prefixes, series, jax_series, decl in cases:
        used = _emitted(path, prefixes)
        assert used == set(series), (decl, sorted(used ^ set(series)))
        assert len(series) == len(set(series)), decl
        assert set(series) == set(jax_series), decl
