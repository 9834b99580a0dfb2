"""The port's tiered embedding store on the CPU (``tests/test_tiered.py``'s
cases on ``lightctr_tpu_torch.embed``), then the store held to the JAX
package's.

The mirrored contracts: flat parity (the same seeded lazy init and
updater math whatever tier a row lives in), deterministic promotion and
demotion, no lost push on demotion, the mmap cold tier's crash recovery,
snapshot/restore across store kinds, a vocabulary 64x the hot budget,
write_version and read-only pulls, eviction from every tier, the hosted
store's thrash detector, the ledger (and a serving cache warmed from a
store's ledger), the fault prefetch pipeline, device
mode (``device_hot=True, device="cpu"``: the hot pair as CPU tensors and
the kernels' plain versions) bit for bit numpy mode, and the trainer's
fast path bit for bit ``merge_apply`` on a dense table.

Across packages: the same stream through the JAX store (numpy mode) and
the port's store in both modes, below the native Adagrad kernel's 4,096
slots, equal bit for bit (rows, state snapshots, ``tiered_*``
counters); mmap logs written by either package opened by the other, and
equal appends byte-equal; the ledgers equal; the port's fast path against
the JAX one within ``merge_apply``'s bounds; the device-mode square root
against ``np.sqrt`` where ``torch.sqrt`` parts from it; and the series
lints (every ``tiered_*`` and ``trainer_tiered_*`` series declared and
emitted)."""

import ast
import os
import signal
import time
from pathlib import Path

import multiprocessing as mp

import numpy as np
import pytest
import torch

from lightctr_tpu_torch.ckpt import checkpoint as ckpt_mod
from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.embed.ledger import FrequencyLedger
from lightctr_tpu_torch.embed.mmap_store import MmapRowStore, _rec_layout
from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore, sqrt_rn

PORT_ROOT = Path(__file__).resolve().parent.parent / "lightctr_tpu_torch"


def make_stream(vocab, batch, steps, skew=1.1, seed=0):
    """Bounded-zipf id batches over a seeded rank permutation (the bench's
    stream shape: hot ids scattered through the keyspace)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab).astype(np.int64)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** skew
    p /= p.sum()
    return [perm[rng.choice(vocab, size=batch, p=p)] for _ in range(steps)]


def train_step(store, ids, step, target=None):
    """One teaching-task pull/push cycle; returns the pulled rows.
    Gradient = 0.1 * (row - target_row) per unique id — computed FROM the
    pulled rows, so two stores serving identical rows stay identical."""
    rows = store.pull_batch(ids, worker_epoch=step, worker_id=0)
    uniq, first = np.unique(ids, return_index=True)
    urows = rows[first]
    t = 0.0 if target is None else target[uniq]
    store.push_batch(0, uniq, (0.1 * (urows - t)).astype(np.float32),
                     worker_epoch=step)
    return rows


def tiered(tmp_path, dim, hot_rows, name="s", cls=TieredEmbeddingStore,
           **kw):
    """A store of the port (numpy mode unless ``device_hot`` is given; the
    device mode runs on the CPU) or, with ``cls``, of the JAX package."""
    if cls is TieredEmbeddingStore:
        kw.setdefault("device_hot", False)
        kw.setdefault("device", "cpu")
    return cls(
        dim=dim, hot_rows=hot_rows,
        path=str(tmp_path / name / "store"), updater="adagrad",
        n_workers=1, seed=0, **kw,
    )


def _emitted(path: Path, prefix: str) -> set:
    """Literal first arguments of registry ``inc``/``gauge_set``/
    ``observe`` calls (through ``labeled(...)`` too) that start with
    ``prefix``."""
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


# ---------------------------------------------------------------------------
# flat parity: identical trajectory whatever tier a row lives in


def test_flat_tiered_trajectory_parity(tmp_path):
    """Same stream, same seed: every pulled row block and the final
    snapshot (rows AND accumulators) match the flat store exactly."""
    dim, vocab = 8, 512
    flat = AsyncParamServer(dim=dim, updater="adagrad", n_workers=1, seed=0)
    t = tiered(tmp_path, dim, hot_rows=32)  # 1/16 residency
    stream = make_stream(vocab, batch=96, steps=40)
    for i, ids in enumerate(stream):
        rf = train_step(flat, ids, i)
        rt = train_step(t, ids, i)
        np.testing.assert_array_equal(rf, rt)
    fk, fr, fa = flat.snapshot_state_arrays()
    tk, tr, ta = t.snapshot_state_arrays()
    np.testing.assert_array_equal(fk, tk)
    np.testing.assert_array_equal(fr, tr)
    np.testing.assert_array_equal(fa, ta)
    snap = t.registry.snapshot()["counters"]
    touched = len(np.unique(np.concatenate(stream)))
    assert snap.get("tiered_creates_total", 0) == touched
    assert (snap.get("tiered_warm_faults_total", 0)
            + snap.get("tiered_cold_faults_total", 0)) > 0
    assert t.peak_hot_rows <= 32
    t.close()


def test_duplicate_ids_and_dedup_pull_cover(tmp_path):
    """Duplicate ids in a pull gather the same row; a push with
    duplicate keys fails loud BEFORE mutating state."""
    t = tiered(tmp_path, dim=4, hot_rows=8)
    ids = np.array([7, 3, 7, 7, 3], np.int64)
    rows = t.pull_batch(ids, worker_epoch=0, worker_id=0)
    np.testing.assert_array_equal(rows[0], rows[2])
    np.testing.assert_array_equal(rows[1], rows[4])
    before = t.pull_batch(np.array([3, 7], np.int64), 0, 0).copy()
    with pytest.raises(ValueError, match="duplicate"):
        t.push_batch(0, np.array([3, 3], np.int64),
                     np.ones((2, 4), np.float32), worker_epoch=0)
    np.testing.assert_array_equal(
        t.pull_batch(np.array([3, 7], np.int64), 0, 0), before)
    t.close()


# ---------------------------------------------------------------------------
# determinism: identical runs make identical tier decisions


def test_promote_demote_determinism_fixed_seed(tmp_path):
    dim, vocab = 4, 256
    stream = make_stream(vocab, batch=64, steps=30, seed=3)
    stores = [tiered(tmp_path, dim, hot_rows=16, name=f"d{i}",
                     ledger=FrequencyLedger(decay_every=10, top_cap=0))
              for i in range(2)]
    for i, ids in enumerate(stream):
        a = train_step(stores[0], ids, i)
        b = train_step(stores[1], ids, i)
        np.testing.assert_array_equal(a, b)
        hot_a = np.sort(stores[0]._slot_keys[stores[0]._slot_keys >= 0])
        hot_b = np.sort(stores[1]._slot_keys[stores[1]._slot_keys >= 0])
        np.testing.assert_array_equal(hot_a, hot_b)
    ca = stores[0].registry.snapshot()["counters"]
    cb = stores[1].registry.snapshot()["counters"]
    tiered_counters = {k: v for k, v in ca.items() if k.startswith("tiered_")}
    assert tiered_counters == {
        k: v for k, v in cb.items() if k.startswith("tiered_")}
    assert tiered_counters.get("tiered_demotions_total{to=\"warm\"}", 0) + \
        tiered_counters.get("tiered_demotions_total{to=\"cold\"}", 0) + \
        tiered_counters.get("tiered_demotions_total{to=\"none\"}", 0) > 0
    for s in stores:
        s.close()


# ---------------------------------------------------------------------------
# write-back ordering: no lost push on demotion


def test_no_lost_push_on_demotion(tmp_path):
    dim = 4
    t = tiered(tmp_path, dim, hot_rows=4)
    flat = AsyncParamServer(dim=dim, updater="adagrad", n_workers=1, seed=0)
    first = np.arange(4, dtype=np.int64)  # fills the hot tier
    for s in (t, flat):
        s.pull_batch(first, worker_epoch=0, worker_id=0)
        s.push_batch(0, first, np.full((4, dim), 0.5, np.float32),
                     worker_epoch=0)
    others = np.arange(100, 104, dtype=np.int64)
    for i in range(1, 12):
        for s in (t, flat):
            s.pull_batch(others, worker_epoch=i, worker_id=0)
            s.push_batch(0, others, np.full((4, dim), 0.1, np.float32),
                         worker_epoch=i)
    c = t.registry.snapshot()["counters"]
    demoted = sum(v for k, v in c.items()
                  if k.startswith("tiered_demotions_total"))
    assert demoted >= 4, c
    assert c.get("tiered_writeback_rows_total", 0) >= 4
    tk, tr, ta = t.snapshot_state_arrays()
    fk, fr, fa = flat.snapshot_state_arrays()
    np.testing.assert_array_equal(tk, fk)
    np.testing.assert_array_equal(tr, fr)
    np.testing.assert_array_equal(ta, fa)
    t.close()


# ---------------------------------------------------------------------------
# cold tier crash safety: kill mid-append, reopen, index rebuilds


def test_mmap_torn_tail_recovery(tmp_path):
    path = str(tmp_path / "cold.log")
    st = MmapRowStore.create(path, width=4)
    keys = np.arange(10, dtype=np.int64)
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    st.set_batch(keys, rows)
    rec_bytes, _ = _rec_layout(4)
    st.close()
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        f.write(b"\x5a" * (rec_bytes + rec_bytes // 2))
    st = MmapRowStore.open(path)
    assert st.recovered_records == 10
    assert st.dropped_records >= 1
    assert (os.path.getsize(path) - 16) % rec_bytes == 0
    got, found = st.get_batch(keys)
    assert found.all()
    np.testing.assert_array_equal(got, rows)
    st.set_batch(np.array([99], np.int64), np.ones((1, 4), np.float32))
    st.close()
    st = MmapRowStore.open(path)
    assert st.n_rows == 11
    st.close()


def test_mmap_torn_interior_record_recovery(tmp_path):
    path = str(tmp_path / "cold.log")
    st = MmapRowStore.create(path, width=4)
    keys = np.arange(8, dtype=np.int64)
    rows = np.arange(32, dtype=np.float32).reshape(8, 4)
    st.set_batch(keys, rows)
    rec_bytes, _ = _rec_layout(4)
    st.close()
    with open(path, "r+b") as f:  # tear record 3's row bytes
        f.seek(16 + 3 * rec_bytes + 20)
        f.write(b"\xff" * 8)
    st = MmapRowStore.open(path)
    assert st.dropped_records == 1
    got, found = st.get_batch(keys)
    intact = np.ones(8, bool)
    intact[3] = False
    np.testing.assert_array_equal(found, intact)
    np.testing.assert_array_equal(got[intact], rows[intact])
    st.close()


def _append_forever(path, width, ready):
    st = MmapRowStore.open_or_create(path, width)
    k = 100
    while True:
        ks = np.arange(k, k + 64, dtype=np.int64)
        st.set_batch(ks, np.full((64, width), float(k), np.float32))
        k += 64
        ready.value = k


def test_mmap_kill9_mid_append_recovers(tmp_path):
    path = str(tmp_path / "cold.log")
    st = MmapRowStore.create(path, width=4)
    base_keys = np.arange(16, dtype=np.int64)
    st.set_batch(base_keys, np.ones((16, 4), np.float32))
    st.sync()
    st.close()
    ctx = mp.get_context("spawn")
    ready = ctx.Value("l", 0)
    p = ctx.Process(target=_append_forever, args=(path, 4, ready),
                    daemon=True)
    p.start()
    deadline = time.monotonic() + 30
    while ready.value < 1000 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ready.value >= 1000, "writer never got going"
    os.kill(p.pid, signal.SIGKILL)
    p.join(10)
    st = MmapRowStore.open(path)
    got, found = st.get_batch(base_keys)
    assert found.all()
    np.testing.assert_array_equal(got, np.ones((16, 4), np.float32))
    assert st.n_rows >= 16
    ks = st.keys()
    appended = ks[ks >= 100]
    if len(appended):
        rows, found = st.get_batch(appended.astype(np.int64))
        assert found.all()
        a = appended.astype(np.int64)
        expect = 100 + ((a - 100) // 64) * 64
        np.testing.assert_array_equal(rows[:, 0].astype(np.int64), expect)
    st.close()


# ---------------------------------------------------------------------------
# snapshot / restore equivalence across store kinds


def test_snapshot_restore_equivalence_flat_vs_tiered(tmp_path):
    dim, vocab = 8, 256
    t = tiered(tmp_path, dim, hot_rows=16, name="src")
    stream = make_stream(vocab, batch=64, steps=25, seed=1)
    for i, ids in enumerate(stream):
        train_step(t, ids, i)
    keys, rows, accs = t.snapshot_state_arrays()
    assert len(keys) > vocab // 2
    assert float(np.abs(accs).sum()) > 0
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt_mod.save_arrays(ckpt_dir, 1, keys, rows, accums=accs)
    t.close()
    step, k2, r2, a2 = ckpt_mod.load_latest_state(ckpt_dir)
    assert step == 1 and a2 is not None
    flat = AsyncParamServer(dim=dim, updater="adagrad", n_workers=1, seed=9)
    t2 = tiered(tmp_path, dim, hot_rows=16, name="dst")
    flat.preload_batch(k2, r2, accums=a2)
    t2.preload_batch(k2, r2, accums=a2)
    np.testing.assert_array_equal(t2.snapshot_arrays()[1], rows)
    cont = [keys[ids % len(keys)]
            for ids in make_stream(vocab, batch=64, steps=10, seed=2)]
    for i, ids in enumerate(cont):
        rf = train_step(flat, ids, 100 + i)
        rt = train_step(t2, ids, 100 + i)
        np.testing.assert_array_equal(rf, rt)
    fk, fr, fa = flat.snapshot_state_arrays()
    tk, tr, ta = t2.snapshot_state_arrays()
    np.testing.assert_array_equal(fr, tr)
    np.testing.assert_array_equal(fa, ta)
    t2.close()


# ---------------------------------------------------------------------------
# the scale unlock: vocab >= 64x the hot budget, budget never exceeded


def _train_64x(tmp_path, vocab, hot_rows, batch, steps):
    dim = 8
    rng = np.random.default_rng(11)
    target = rng.normal(size=(vocab, dim)).astype(np.float32)
    flat = AsyncParamServer(dim=dim, updater="adagrad", n_workers=1, seed=0)
    t = tiered(tmp_path, dim, hot_rows=hot_rows)
    stream = make_stream(vocab, batch, steps, seed=5)

    def mse(store):
        uniq = np.unique(np.concatenate(stream))
        rows = store.pull_batch(uniq, worker_epoch=steps, worker_id=0)
        return float(np.mean((rows - target[uniq]) ** 2))

    for i, ids in enumerate(stream):
        rf = train_step(flat, ids, i, target=target)
        rt = train_step(t, ids, i, target=target)
        np.testing.assert_array_equal(rf, rt)
    return flat, t, mse


def test_vocab_64x_budget_trains_with_parity(tmp_path):
    hot_rows, vocab = 32, 2048  # 64x
    flat, t, mse = _train_64x(tmp_path, vocab, hot_rows, batch=128,
                              steps=60)
    m_flat, m_tiered = mse(flat), mse(t)
    assert m_tiered == pytest.approx(m_flat, rel=1e-5)
    st = t.stats()
    tiers = st["store"]["tiers"]
    n_rows = st["store"]["rows"]
    assert n_rows == t.n_keys()
    assert n_rows > 16 * hot_rows
    assert tiers["hot"]["peak_rows"] <= hot_rows
    assert tiers["hot"]["rows"] <= hot_rows
    assert tiers["warm"]["rows"] + tiers["cold"]["rows"] >= n_rows - hot_rows
    g = t.registry.snapshot()["gauges"]
    assert g["tiered_hot_row_budget"] == hot_rows
    assert g["tiered_peak_hot_rows"] <= hot_rows
    t.close()


@pytest.mark.slow
def test_criteo_scale_tiered_convergence(tmp_path):
    hot_rows, vocab = 512, 1 << 15
    flat, t, mse = _train_64x(tmp_path, vocab, hot_rows, batch=1024,
                              steps=200)
    m_flat, m_tiered = mse(flat), mse(t)
    assert m_tiered == pytest.approx(m_flat, rel=1e-5)
    assert t.peak_hot_rows <= hot_rows
    assert t.stats()["store"]["rows"] > 16 * hot_rows
    t.close()


# ---------------------------------------------------------------------------
# serving-plane contracts: write_version, read-only pulls, eviction


def test_write_version_bumps_on_tier_crossing_writes(tmp_path):
    t = tiered(tmp_path, dim=4, hot_rows=2)
    ids = np.arange(8, dtype=np.int64)
    t.pull_batch(ids, worker_epoch=0, worker_id=0)
    v0 = t.write_version
    t.push_batch(0, ids, np.ones((8, 4), np.float32), worker_epoch=0)
    assert t.write_version > v0
    v1 = t.write_version
    t.preload_batch(np.array([3], np.int64), np.zeros((1, 4), np.float32))
    assert t.write_version > v1
    v2 = t.write_version
    assert t.evict_batch(np.array([3], np.int64)) == 1
    assert t.write_version > v2
    t.close()


def test_read_only_pull_never_creates_or_promotes(tmp_path):
    t = tiered(tmp_path, dim=4, hot_rows=2)
    known = np.arange(4, dtype=np.int64)
    t.pull_batch(known, worker_epoch=0, worker_id=0)
    n0 = t.n_keys()
    hot0 = np.sort(t._slot_keys[t._slot_keys >= 0]).copy()
    mixed = np.array([0, 900, 2, 901], np.int64)
    rows = t.pull_batch(mixed, worker_epoch=0, worker_id=0, create=False)
    assert np.all(rows[[1, 3]] == 0.0)
    assert np.any(rows[[0, 2]] != 0.0)
    assert t.n_keys() == n0
    np.testing.assert_array_equal(
        np.sort(t._slot_keys[t._slot_keys >= 0]), hot0)
    t.close()


def test_evict_removes_from_every_tier(tmp_path):
    t = tiered(tmp_path, dim=4, hot_rows=2)
    ids = np.arange(6, dtype=np.int64)
    t.pull_batch(ids, worker_epoch=0, worker_id=0)
    t.push_batch(0, ids, np.full((6, 4), 2.0, np.float32), worker_epoch=0)
    assert t.n_keys() == 6
    got = t.evict_batch(ids)
    assert got == 6
    assert t.n_keys() == 0
    assert t.evicted_keys == 6
    rows = t.pull_batch(ids, worker_epoch=1, worker_id=0, create=False)
    assert np.all(rows == 0.0)
    assert t.stats()["store"]["rows"] == t.n_keys() == 0
    t.preload_batch(np.array([1000, 1001], np.int64),
                    np.ones((2, 4), np.float32))
    t.preload_batch(np.array([1000], np.int64),
                    np.zeros((1, 4), np.float32))  # known: no recount
    t.pull_batch(np.array([7, 8], np.int64), worker_epoch=2, worker_id=0)
    assert t.stats()["store"]["rows"] == t.n_keys() == 4
    t.close()


def test_service_installs_and_feeds_tier_thrash_detector(tmp_path):
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient

    t = tiered(tmp_path, dim=4, hot_rows=2, health_feed_every=4)
    svc = ParamServerService(t, port=0)
    cli = PSClient(svc.address, 4)
    try:
        assert svc.health.detector("tier_thrash") is not None
        for i in range(12):
            ids = np.arange(8, dtype=np.int64)
            cli.pull_arrays(ids, worker_epoch=i, worker_id=0)
            cli.push_arrays(0, ids, np.ones((8, 4), np.float32),
                            worker_epoch=i)
        det = svc.health.verdict()["detectors"]["tier_thrash"]
        assert det["checks"] > 0, "tier_flow feed never reached the detector"
    finally:
        cli.close()
        svc.close()
        t.close()


# ---------------------------------------------------------------------------
# ledger determinism + the shared-admission contract


def test_ledger_counts_and_decay():
    led = FrequencyLedger(decay_every=0, top_cap=64)
    ids = np.array([5, 9, 5], np.int64)
    led.touch(np.unique(ids))
    led.touch(np.array([5], np.int64))
    assert led.freq(5) >= 2.0
    assert led.freq(9) >= 1.0
    assert led.freq(1234567) == 0.0
    top = led.top_k(2)
    assert top[0] == 5
    led.decay_now()
    assert led.freq(5) == pytest.approx(1.0, abs=0.5)


def test_shared_ledger_feeds_admission(tmp_path):
    led = FrequencyLedger(decay_every=0, top_cap=0)
    hot_keys = np.arange(4, dtype=np.int64)
    for _ in range(50):
        led.touch(hot_keys)
    t = tiered(tmp_path, dim=4, hot_rows=4, ledger=led)
    ids = np.arange(16, dtype=np.int64)
    t.pull_batch(ids, worker_epoch=0, worker_id=0)
    resident = set(t._slot_keys[t._slot_keys >= 0].tolist())
    assert resident == set(hot_keys.tolist())
    t.close()


# ---------------------------------------------------------------------------
# fault prefetch pipeline: overlap changes WHEN, never WHAT


def test_fault_prefetch_overlap_vs_sync_equivalence(tmp_path):
    dim, vocab = 8, 512
    a = tiered(tmp_path, dim, hot_rows=32, name="sync", prefetch=False)
    b = tiered(tmp_path, dim, hot_rows=32, name="pipe", prefetch=True)
    stream = make_stream(vocab, batch=64, steps=40, seed=7)
    for step, ids in enumerate(stream):
        ra = a.pull_batch(ids, worker_epoch=step, worker_id=0)
        rb = b.pull_batch(ids, worker_epoch=step, worker_id=0)
        np.testing.assert_array_equal(ra, rb)
        t = b.dispatch_prefetch(stream[step + 1]) \
            if step + 1 < len(stream) else 0
        uniq, first = np.unique(ids, return_index=True)
        g = (0.1 * ra[first]).astype(np.float32)
        a.push_batch(0, uniq, g, worker_epoch=step)
        b.push_batch(0, uniq, g, worker_epoch=step)
        if t:
            b.prefetch_wait(t)
    ka, rowsa, acca = a.snapshot_state_arrays()
    kb, rowsb, accb = b.snapshot_state_arrays()
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(rowsa, rowsb)
    np.testing.assert_array_equal(acca, accb)
    st = b.stats()["store"]["fault_pipeline"]
    assert st["enabled"] and st["overlap_rows"] > 0
    assert b.stats()["store"]["fault_pipeline"]["overlap_ratio"] > 0.3
    sa = a.stats()["store"]["fault_pipeline"]
    assert not sa["enabled"] and sa["overlap_rows"] == 0
    a.close()
    b.close()


def test_fault_prefetch_stale_and_demotion_ticket_reuse(tmp_path):
    dim = 8
    s = tiered(tmp_path, dim, hot_rows=8, name="churn", prefetch=True)
    o = tiered(tmp_path, dim, hot_rows=8, name="oracle", prefetch=False)
    band1 = np.arange(1, 17, dtype=np.int64)
    band2 = np.arange(100, 116, dtype=np.int64)
    for step, ids in enumerate((band1, band2, band1)):
        train_step(s, ids, step)
        train_step(o, ids, step)
    t = s.dispatch_prefetch(band2)
    assert t and s.prefetch_wait(t)
    train_step(s, band1, 3)
    train_step(o, band1, 3)
    band3 = np.arange(300, 308, dtype=np.int64)
    cover = np.concatenate([band2[:8], band3])
    t = s.dispatch_prefetch(cover)
    assert t and s.prefetch_wait(t)
    g = np.full((8, dim), 0.05, np.float32)
    s.push_batch(0, band2[:8], g, worker_epoch=4)
    o.push_batch(0, band2[:8], g, worker_epoch=4)
    r_s = s.pull_batch(cover, worker_epoch=5, worker_id=0)
    r_o = o.pull_batch(cover, worker_epoch=5, worker_id=0)
    np.testing.assert_array_equal(r_s, r_o)
    snap = s.registry.snapshot()["counters"]
    assert snap.get("tiered_pull_plan_fallbacks_total", 0) > 0, \
        "the mismatched pull never recorded a plan fallback"
    assert snap.get("tiered_fault_prefetch_stale_total", 0) > 0, \
        "the interleaved push never staled the staged rows"
    assert s.peak_hot_rows <= 8
    s.close()
    o.close()


def test_device_mode_trajectory_matches_numpy_mode(tmp_path):
    """The device-resident hot tier (``device_hot=True``, its pair as CPU
    tensors here) follows the numpy-mode store bit-for-bit through
    training, demotion write-back, and the state-carrying snapshot, with
    the prefetch pipeline live on both.  The stream trains toward a
    NONZERO target, as the JAX test does (no row goes subnormal)."""
    dim, vocab = 8, 256
    rng = np.random.default_rng(5)
    target = (0.5 * rng.normal(size=(vocab + 1, dim))).astype(np.float32)
    a = tiered(tmp_path, dim, hot_rows=16, name="np_m", device_hot=False)
    b = tiered(tmp_path, dim, hot_rows=16, name="dev_m", device_hot=True)
    assert b.device_tables()[0].device.type == "cpu"
    for step, ids in enumerate(make_stream(vocab, 48, 30, seed=11)):
        ra = train_step(a, ids, step, target=target)
        rb = train_step(b, ids, step, target=target)
        np.testing.assert_array_equal(ra, rb)
    ka, rowsa, acca = a.snapshot_state_arrays()
    kb, rowsb, accb = b.snapshot_state_arrays()
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(rowsa, rowsb)
    np.testing.assert_array_equal(acca, accb)
    c = tiered(tmp_path, dim, hot_rows=16, name="dst_m", device_hot=True)
    mr, ma = c.migrate_in_state(kb, rowsb, accb)
    np.testing.assert_array_equal(mr, rowsb)
    np.testing.assert_array_equal(ma, accb)
    a.close()
    b.close()
    c.close()


def test_trainer_device_fast_path_parity_and_stale_tickets(tmp_path):
    """``TieredDeviceEmbedding``: the all-hot chain (slot tickets ->
    gather_rows -> merge_apply in place on the pair -> adopt) is
    bit-identical to the same merge_apply over a dense oracle table;
    mixed batches land their miss rows through push_batch; stale tickets
    (residency moved after the gather) refuse the adopt loudly."""
    from lightctr_tpu_torch.models.sparse_trainer import TieredDeviceEmbedding
    from lightctr_tpu_torch.ops import sparse_kernels as sk

    dim = 8
    store = tiered(tmp_path, dim, hot_rows=64, name="fastpath",
                   device_hot=True, prefetch=False)
    emb = TieredDeviceEmbedding(store, denom=2.0)
    rng = np.random.default_rng(0)
    keys = np.arange(1, 33, dtype=np.int64)
    emb.gather(keys)  # create + promote everything: all-hot regime
    rows0, _, known = store.pull_state_batch(keys)
    assert known.all()
    # the batch touches hot slot 0, a live row (the pad uid's value)
    assert (store.hot_slots(keys) == 0).any()
    vocab = 1 << 10
    W = torch.zeros((vocab, dim), dtype=torch.float32)
    A = torch.zeros((vocab, dim), dtype=torch.float32)
    W[torch.from_numpy(keys)] = torch.from_numpy(rows0)
    for step in range(15):
        ids = rng.choice(keys, size=64)
        rows_u, inv, tk = emb.gather(ids)
        uq = np.unique(ids)
        np.testing.assert_array_equal(rows_u.numpy(),
                                      W[torch.from_numpy(uq)].numpy())
        g = rng.normal(size=(64, dim)).astype(np.float32)
        emb.apply(tk, g)
        up = sk.next_pow2(len(uq))
        uids_p = np.zeros(up, np.int32)
        uids_p[: len(uq)] = uq
        inv_p = np.unique(ids, return_inverse=True)[1].astype(np.int32)
        sk.merge_apply(W, A, torch.from_numpy(uids_p), torch.from_numpy(g),
                       torch.from_numpy(inv_p), lr=store.lr, eps=store.eps,
                       denom=2.0)
        got, accs, _ = store.pull_state_batch(keys)
        np.testing.assert_array_equal(got, W[torch.from_numpy(keys)].numpy())
        np.testing.assert_array_equal(accs,
                                      A[torch.from_numpy(keys)].numpy())
    assert emb.fast_steps == 15
    store.close()

    s2 = tiered(tmp_path, dim, hot_rows=8, name="fastmixed",
                device_hot=True, prefetch=True)
    e2 = TieredDeviceEmbedding(s2)
    touched = set()
    for step in range(20):
        ids = rng.integers(1, 100, size=32)
        touched.update(np.unique(ids).tolist())
        rows_u, inv, tk = e2.gather(ids)
        if step + 1 < 20:
            e2.prefetch_next(rng.integers(1, 100, size=32))
        e2.apply(tk, rng.normal(size=(32, dim)).astype(np.float32))
    assert e2.mixed_steps > 0
    tk_all = np.sort(np.fromiter(touched, np.int64))
    rows, _, known = s2.pull_state_batch(tk_all)
    assert known.all() and np.isfinite(rows).all()

    ids = rng.integers(1, 100, size=16)
    rows_u, inv, tk = e2.gather(ids)
    hot_now = tk["uniq"][tk["hot"]]
    assert len(hot_now), "regime never promoted anything"
    s2.evict_batch(hot_now[:1])
    before = e2.stale_tickets
    e2.apply(tk, np.zeros((16, dim), np.float32))
    assert e2.stale_tickets == before + 1
    w, a = s2.device_tables()
    with pytest.raises(ValueError, match="stale slot tickets"):
        s2.adopt_device_tables(w, a, expect_res_epoch=-1)
    s2.close()


def test_hosted_push_echo_prefetch_overlaps(tmp_path):
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient

    dim = 4
    hosted = tiered(tmp_path, dim, hot_rows=8, name="hosted",
                    prefetch=True)
    oracle = tiered(tmp_path, dim, hot_rows=8, name="wire_oracle",
                    prefetch=False)
    svc = ParamServerService(hosted)
    c = PSClient(svc.address, dim=dim)
    rng = np.random.default_rng(3)
    keys = np.arange(1, 40, dtype=np.int64)
    for ep in range(25):
        ks = np.unique(rng.choice(keys, 16))
        rows = c.pull_arrays(ks, worker_epoch=ep, worker_id=0)[1]
        want = oracle.pull_batch(ks, worker_epoch=ep, worker_id=0)
        np.testing.assert_allclose(rows, want, rtol=0, atol=1e-3)
        g = np.ones((len(ks), dim), np.float32)
        c.push_arrays(0, ks, g, worker_epoch=ep)
        oracle.push_batch(0, ks, g, worker_epoch=ep)
        time.sleep(0.005)  # the echo stages behind the reply
    st = hosted.stats()["store"]["fault_pipeline"]
    assert st["enabled"] and st["overlap_rows"] > 0
    c.close()
    svc.close()
    hosted.close()
    oracle.close()


def test_serving_cache_warms_from_the_store_ledger(tmp_path):
    """``HotEmbeddingCache.warm_from_ledger`` fed by a store's shared
    ledger: the store's hottest keys land in the cache with the rows a
    read-only pull returns."""
    from lightctr_tpu_torch.serve.cache import HotEmbeddingCache

    led = FrequencyLedger(decay_every=0, top_cap=64)
    t = tiered(tmp_path, dim=4, hot_rows=8, ledger=led)
    for i, ids in enumerate(make_stream(256, batch=64, steps=10, seed=4)):
        train_step(t, ids, i)
    cache = HotEmbeddingCache(4, capacity=16, device="cpu")
    warmed = cache.warm_from_ledger(
        led, lambda u: t.pull_batch(u, 0, 0, create=False))
    assert warmed == 16
    top = np.sort(led.top_k(16))
    rows, found = cache.lookup(top)
    assert found.all()
    np.testing.assert_array_equal(rows, t.pull_batch(top, 0, 0,
                                                     create=False))
    t.close()


# ---------------------------------------------------------------------------
# the port's own contracts: the device default, the series lints


def test_store_and_fast_path_default_to_cuda():
    """Device mode is the default and its device is CUDA: without a card
    the store raises (no CPU pair in its place); numpy mode needs no
    device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredEmbeddingStore(dim=4, hot_rows=4)
    s = TieredEmbeddingStore(dim=4, hot_rows=4, device_hot=False)
    assert s.device is None and s.stats()["store"]["device_hot"] is False
    s.close()


def test_every_tier_series_is_declared_and_emitted():
    from lightctr_tpu_torch.embed import tiered as tmod

    emitted = _emitted(PORT_ROOT / "embed" / "tiered.py", "tiered_")
    assert emitted == set(tmod.TIER_SERIES)
    assert len(tmod.TIER_SERIES) == len(emitted)


def test_fast_path_series_are_declared_and_emitted():
    from lightctr_tpu.models import sparse_trainer as jst
    from lightctr_tpu_torch.models import sparse_trainer as tst

    emitted = _emitted(PORT_ROOT / "models" / "sparse_trainer.py",
                       "trainer_tiered_")
    declared = {s for s in tst.EXCHANGE_SERIES
                if s.startswith("trainer_tiered_")}
    assert emitted == declared
    assert declared == {s for s in jst.EXCHANGE_SERIES
                        if s.startswith("trainer_tiered_")}


# ---------------------------------------------------------------------------
# across packages


@pytest.mark.parametrize("mode", ["numpy", "device"])
def test_same_stream_both_packages_bit_for_bit(tmp_path, mode):
    """The JAX store (numpy mode) and the port's store in either mode on
    one stream, below 4,096 slots a push (both stores' updater then takes
    numpy's expression): pulled rows, the state snapshot and every
    ``tiered_*`` counter equal bit for bit."""
    from lightctr_tpu.embed.tiered import TieredEmbeddingStore as JStore

    dim, vocab = 8, 2048
    rng = np.random.default_rng(13)
    target = (0.5 * rng.normal(size=(vocab, dim))).astype(np.float32)
    j = tiered(tmp_path, dim, hot_rows=64, name="jax", cls=JStore,
               device_hot=False)
    t = tiered(tmp_path, dim, hot_rows=64, name="port",
               device_hot=mode == "device")
    stream = make_stream(vocab, batch=512, steps=30, seed=17)
    for i, ids in enumerate(stream):
        assert len(np.unique(ids)) < 4096
        rj = train_step(j, ids, i, target=target)
        rt = train_step(t, ids, i, target=target)
        np.testing.assert_array_equal(rj, rt)
    for a, b in zip(j.snapshot_state_arrays(), t.snapshot_state_arrays()):
        np.testing.assert_array_equal(a, b)
    cj = {k: v for k, v in j.registry.snapshot()["counters"].items()
          if k.startswith("tiered_")}
    ct = {k: v for k, v in t.registry.snapshot()["counters"].items()
          if k.startswith("tiered_")}
    assert cj == ct
    assert cj.get("tiered_creates_total", 0) > 0
    assert cj.get("tiered_warm_faults_total", 0) > 0
    assert sum(v for k, v in cj.items()
               if k.startswith("tiered_demotions_total")) > 0
    j.close()
    t.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mmap_log_opens_in_the_other_package(tmp_path, writer):
    """A cold log written by either package opens in the other with equal
    rows (updates and deletes replayed), and the same appends give
    byte-equal files."""
    from lightctr_tpu.embed.mmap_store import MmapRowStore as JLog

    rng = np.random.default_rng(4)
    classes = {"jax": JLog, "port": MmapRowStore}
    paths = {}
    for name, cls in classes.items():
        p = str(tmp_path / f"{name}.log")
        st = cls.create(p, width=6)
        r = np.random.default_rng(4)
        st.set_batch(np.arange(50, dtype=np.int64),
                     r.normal(size=(50, 6)).astype(np.float32))
        st.set_batch(np.arange(10, 30, dtype=np.int64),
                     r.normal(size=(20, 6)).astype(np.float32))
        st.delete_batch(np.array([3, 4], np.int64))
        st.close()
        paths[name] = p
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = classes["port" if writer == "jax" else "jax"]
    keys = np.arange(60, dtype=np.int64)
    # one handle on the log at a time (a log has one writer)
    want = classes[writer].open(paths[writer])
    rw, fw = want.get_batch(keys)
    n_want = want.n_rows
    want.close()
    got = reader.open(paths[writer])
    rg, fg = got.get_batch(keys)
    np.testing.assert_array_equal(fw, fg)
    np.testing.assert_array_equal(rw, rg)
    assert fg.sum() == 48 and got.n_rows == n_want
    # the reader appends and the writer's package reads that back too
    row = rng.normal(size=(1, 6)).astype(np.float32)
    got.set_batch(np.array([77], np.int64), row)
    got.close()
    again = classes[writer].open(paths[writer])
    np.testing.assert_array_equal(
        again.get_batch(np.array([77], np.int64))[0], row)
    again.close()


def test_ledger_equal_across_packages():
    from lightctr_tpu.embed.ledger import FrequencyLedger as JLedger

    rng = np.random.default_rng(8)
    kw = dict(decay_every=5, top_cap=32)
    a, b = JLedger(**kw), FrequencyLedger(**kw)
    for _ in range(23):
        ids = np.unique(rng.integers(0, 5000, size=300)).astype(np.int64)
        np.testing.assert_array_equal(a.touch_and_get(ids),
                                      b.touch_and_get(ids))
    probe = np.arange(5000, dtype=np.int64)
    np.testing.assert_array_equal(a.get(probe), b.get(probe))
    np.testing.assert_array_equal(a.top_k(16), b.top_k(16))
    assert a.decays == b.decays > 0
    a.decay_now()
    b.decay_now()
    np.testing.assert_array_equal(a.get(probe), b.get(probe))
    assert a.stats() == b.stats()


def test_fast_path_within_merge_apply_bounds_of_the_jax_one(tmp_path):
    """The port's ``TieredDeviceEmbedding`` (plain gather_rows and
    merge_apply on CPU tensors) against the JAX one, 15 all-hot steps
    chained from equal stores: rows within atol 2e-7, accumulators within
    rtol 2e-6, the step's sum of squares within rtol 1e-5
    (``test_merge_apply_plain_matches_jax``'s bounds)."""
    from lightctr_tpu.embed.tiered import TieredEmbeddingStore as JStore
    from lightctr_tpu.models.sparse_trainer import (
        TieredDeviceEmbedding as JEmb)
    from lightctr_tpu_torch.models.sparse_trainer import TieredDeviceEmbedding

    dim = 8
    js = tiered(tmp_path, dim, hot_rows=64, name="jfast", cls=JStore,
                device_hot=True, prefetch=False)
    ts = tiered(tmp_path, dim, hot_rows=64, name="tfast", device_hot=True,
                prefetch=False)
    je, te = JEmb(js, denom=2.0), TieredDeviceEmbedding(ts, denom=2.0)
    keys = np.arange(1, 33, dtype=np.int64)
    je.gather(keys)
    te.gather(keys)
    for a, b in zip(js.pull_state_batch(keys), ts.pull_state_batch(keys)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(21)
    for step in range(15):
        ids = rng.choice(keys, size=64)
        g = rng.normal(size=(64, dim)).astype(np.float32)
        rj, invj, tkj = je.gather(ids)
        rt, invt, tkt = te.gather(ids)
        np.testing.assert_array_equal(np.asarray(invj), invt.numpy())
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                                   atol=2e-7)
        sj = float(je.apply(tkj, g))
        st = float(te.apply(tkt, g))
        assert st == pytest.approx(sj, rel=1e-5)
        wj, aj, _ = js.pull_state_batch(keys)
        wt, at, _ = ts.pull_state_batch(keys)
        np.testing.assert_allclose(wt, wj, rtol=0, atol=2e-7)
        np.testing.assert_allclose(at, aj, rtol=2e-6, atol=0)
    assert je.fast_steps == te.fast_steps == 15
    js.close()
    ts.close()


def test_device_mode_sqrt_is_numpys_where_torch_sqrt_is_not():
    """``torch.sqrt`` of a CPU float32 tensor is not correctly rounded
    (nor is its float64 square root); the updater's ``sqrt_rn`` equals
    ``np.sqrt`` on the values where it parts from it, across exponents,
    subnormals and the edges."""
    rng = np.random.default_rng(0)
    x = (rng.random(1 << 18) * np.float32(2.0) ** rng.integers(
        -149, 127, 1 << 18)).astype(np.float32)
    edges = np.array([0.0, -0.0, np.inf, 1.0, 4.0, 1e-45, 3.4e38,
                      np.finfo(np.float32).tiny], np.float32)
    x = np.concatenate([x, edges])
    want = np.sqrt(x)
    plain = torch.sqrt(torch.from_numpy(x)).numpy()
    parts = plain != want
    assert parts.sum() > 0, "torch.sqrt is correctly rounded here"
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the updater's own inputs: acc + eps over Adagrad-sized values
    acc = (rng.random(1 << 16) * 4).astype(np.float32) + np.float32(1e-7)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(acc)).numpy(),
                                  np.sqrt(acc))
