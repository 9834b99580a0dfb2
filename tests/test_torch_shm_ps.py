"""The port's ShmAsyncParamServer (``tests/test_shm_ps.py``'s cases on
``lightctr_tpu_torch.embed.shm_ps`` over the port's native ``ShmKV``):
forked workers against the same file-backed stores, (a) no lost updates
under concurrent float-CAS pushes, (b) SSP gating, (c) routing flags, (d)
single-writer parity with the in-process AsyncParamServer oracle, the
two-limb epochs, the ledger format stamp and the heartbeat's shared
routing.  Then a segment created and pushed by the JAX package's server
read back through the port's ``open()``."""

import os

import numpy as np
import pytest

from lightctr_tpu_torch.native.bindings import available


@pytest.fixture(autouse=True)
def _native_library():
    """Every case needs the native ``ShmKV`` (decided when a test runs,
    not when the module is imported)."""
    if not available():
        pytest.skip("native shm_kv library unavailable")


DIM = 4
LR = 0.1


def _make(tmp_path, updater="sgd", n_workers=2, **kw):
    from lightctr_tpu_torch.embed.shm_ps import ShmAsyncParamServer

    return ShmAsyncParamServer.create(
        str(tmp_path / "ps"), capacity=1024, dim=DIM, n_workers=n_workers,
        updater=updater, learning_rate=LR, **kw,
    )


def _worker_push_loop(base, worker_id, n_pushes, keys):
    """Runs in a forked child: open the store and hammer pushes."""
    from lightctr_tpu_torch.embed.shm_ps import ShmAsyncParamServer

    ps = ShmAsyncParamServer.open(
        base, n_workers=2, updater="sgd", learning_rate=LR,
        staleness_threshold=1 << 20,  # this test measures atomicity, not SSP
    )
    g = {k: np.ones(DIM, np.float32) for k in keys}
    for i in range(n_pushes):
        assert ps.push(worker_id, g, worker_epoch=i)
    ps.close()


def test_concurrent_pushes_lose_nothing(tmp_path):
    ps = _make(tmp_path, updater="sgd", staleness_threshold=1 << 20)
    keys = [3, 7, 11]
    for k in keys:  # pre-seed zeros: no lazy-init randomness in the ledger
        ps._data.set(k, np.zeros(DIM, np.float32))
    n_pushes = 200
    pids = []
    for wid in range(2):
        pid = os.fork()
        if pid == 0:
            try:
                _worker_push_loop(str(tmp_path / "ps"), wid, n_pushes, keys)
                os._exit(0)
            except BaseException:
                os._exit(1)
        pids.append(pid)
    for pid in pids:
        _, status = os.waitpid(pid, 0)
        assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0
    want = -LR * 2 * n_pushes
    for k in keys:
        np.testing.assert_allclose(
            ps._data.get(k), np.full(DIM, want, np.float32), rtol=1e-5
        )
    ps.close()


def test_ssp_pull_gate_and_push_drop(tmp_path):
    ps = _make(tmp_path, updater="sgd", staleness_threshold=3)
    # worker 1 sprints to epoch 10; worker 0 stays at 0
    ps.advance_epoch(1, 10)
    # a pull from epoch 10 while the slowest is 0 is withheld
    assert ps.pull([1], worker_epoch=10) is None
    assert ps.withheld_pulls == 1
    # within the staleness bound it succeeds
    got = ps.pull([1], worker_epoch=2)
    assert got is not None and set(got) == {1}
    # a push 10 behind the fastest is dropped
    assert not ps.push(0, {1: np.ones(DIM, np.float32)}, worker_epoch=0)
    assert ps.dropped_pushes == 1
    # catch worker 0 up; its push lands
    ps.advance_epoch(0, 9)
    assert ps.push(0, {1: np.ones(DIM, np.float32)}, worker_epoch=9)
    ps.close()


def test_routing_flags(tmp_path):
    ps = _make(tmp_path, updater="sgd")
    ps.unroute_worker(0)
    assert not ps.push(0, {5: np.ones(DIM, np.float32)}, worker_epoch=0)
    assert ps.pull([5], worker_epoch=0, worker_id=0) is None
    ps.readmit_worker(0)
    assert ps.push(0, {5: np.ones(DIM, np.float32)}, worker_epoch=0)
    assert ps.pull([5], worker_epoch=0, worker_id=0) is not None
    ps.close()


@pytest.mark.parametrize("updater", ["adagrad", "dcasgd", "dcasgda"])
def test_single_writer_matches_async_ps_oracle(tmp_path, updater):
    """With one worker and a fixed push sequence the shm PS must reproduce
    the in-process AsyncParamServer numerics exactly."""
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

    shm = _make(tmp_path, updater=updater, n_workers=1)
    ref = AsyncParamServer(
        dim=DIM, updater=updater, learning_rate=LR, n_workers=1
    )
    rng = np.random.default_rng(0)
    key = 42
    # identical lazy init on both sides
    init = (rng.standard_normal(DIM) * np.sqrt(1.0 / DIM)).astype(np.float32)
    shm._data.set(key, init)
    shm._accum.set(key, np.zeros(DIM, np.float32))
    ref._data[key] = init.copy()
    ref._accum[key] = np.zeros(DIM, np.float32)
    ref._shadow[key] = np.tile(init, (1, 1))
    shm._shadow.set(key, init)  # worker 0 << 48 | key == key for worker 0
    for step in range(20):
        g = rng.standard_normal(DIM).astype(np.float32)
        assert shm.push(0, {key: g}, worker_epoch=step)
        assert ref.push(0, {key: g}, worker_epoch=step)
    np.testing.assert_allclose(
        shm._data.get(key), ref._data[key], rtol=2e-5, atol=2e-6
    )
    shm.close()


def test_epochs_exact_beyond_float32_range(tmp_path):
    """Epochs are stored as two fp32 limbs: values past 2^24 stay exact
    (a raw fp32 ledger would saturate and wedge the SSP gate)."""
    ps = _make(tmp_path, updater="sgd")
    big = (1 << 24) + 12345
    ps.advance_epoch(0, big)
    ps.advance_epoch(1, big + 3)
    epochs, _ = ps._ledger()
    assert int(epochs[0]) == big
    assert int(epochs[1]) == big + 3
    # pull within the bound succeeds; ahead of it is withheld
    assert ps.pull([1], worker_epoch=big + 3) is not None
    assert ps.pull([1], worker_epoch=big + 100) is None
    ps.close()


def test_advance_epoch_cannot_resurrect_unrouted_worker(tmp_path):
    """Routing flags live in coordinator-owned rows: a worker's epoch write
    concurrent with unroute_worker can no longer flip the flag back."""
    ps = _make(tmp_path, updater="sgd")
    ps.unroute_worker(0)
    ps.advance_epoch(0, 5)  # the race: epoch write after the unroute
    assert not ps._routed(0)
    assert not ps.push(0, {5: np.ones(DIM, np.float32)}, worker_epoch=5)
    ps.readmit_worker(0)
    assert ps.push(0, {5: np.ones(DIM, np.float32)}, worker_epoch=5)
    ps.close()


def test_open_rejects_stale_ledger_format(tmp_path):
    """open() refuses a meta store without the current format stamp instead
    of silently decoding garbage epochs."""
    from lightctr_tpu_torch.embed import shm_ps
    from lightctr_tpu_torch.embed.shm_ps import ShmAsyncParamServer

    ps = _make(tmp_path)
    # simulate a pre-v2 ledger: clobber the format row
    ps._meta.set(shm_ps._FORMAT_KEY, np.array([1.0, 0.0], np.float32))
    ps.close()
    with pytest.raises(RuntimeError, match="ledger format"):
        ShmAsyncParamServer.open(str(tmp_path / "ps"), n_workers=2)


def test_heartbeat_drives_shared_routing(tmp_path):
    """Coordinator-side HeartbeatMonitor unroutes/readmits through the
    SHARED meta store: a second process handle observes the flag flips."""
    import time

    from lightctr_tpu_torch.dist.bootstrap import HeartbeatMonitor
    from lightctr_tpu_torch.embed.shm_ps import ShmAsyncParamServer

    ps = _make(tmp_path, updater="sgd")
    other = ShmAsyncParamServer.open(str(tmp_path / "ps"), n_workers=2)
    mon = HeartbeatMonitor(stale_after_s=0.05, dead_after_s=0.1, period_s=0.02)
    ps.attach_heartbeat(mon)
    mon.beat("0")
    mon.start()
    try:
        g = {1: np.ones(DIM, np.float32)}
        assert other.push(0, g, worker_epoch=0)
        time.sleep(0.3)  # monitor thread declares worker 0 dead
        assert not other.push(0, g, worker_epoch=0)  # other PROCESS handle
        mon.beat("0")  # re-registration readmits
        assert other.push(0, g, worker_epoch=0)
    finally:
        mon.stop()
        other.close()
        ps.close()


def test_jax_segment_reads_back_through_the_port(tmp_path):
    """One file format: a segment the JAX package's server created and
    pushed into opens in the port with the same rows, accumulators and
    epoch ledger, and the port's pushes land where the JAX side reads
    them."""
    from lightctr_tpu.embed.shm_ps import ShmAsyncParamServer as JShm
    from lightctr_tpu_torch.embed.shm_ps import ShmAsyncParamServer

    base = str(tmp_path / "ps")
    j = JShm.create(base, capacity=1024, dim=DIM, n_workers=2,
                    updater="adagrad", learning_rate=LR,
                    staleness_threshold=1 << 20)
    rng = np.random.default_rng(2)
    keys = [1, 5, 9, 400]
    for step in range(6):
        g = {k: rng.standard_normal(DIM).astype(np.float32) for k in keys}
        assert j.push(step % 2, g, worker_epoch=step)
    j.advance_epoch(1, 7)
    want = j.pull(keys, worker_epoch=5)
    t = ShmAsyncParamServer.open(base, n_workers=2, updater="adagrad",
                                 learning_rate=LR,
                                 staleness_threshold=1 << 20)
    got = t.pull(keys, worker_epoch=5)
    assert set(got) == set(want)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(t._accum.get(k), j._accum.get(k))
    np.testing.assert_array_equal(t._ledger()[0], j._ledger()[0])
    g = {5: np.full(DIM, 0.5, np.float32)}
    assert t.push(0, g, worker_epoch=6)
    np.testing.assert_array_equal(j.pull([5], worker_epoch=6)[5],
                                  t.pull([5], worker_epoch=6)[5])
    t.close()
    j.close()
