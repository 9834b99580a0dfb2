"""The port's prefetch stage and the trainers' ``fit(prefetch=)`` and
``fit_stream`` on the CPU, against the JAX package.

The four prefetch cases of ``tests/test_ingest.py`` (a stream read from a
libFFM file where the JAX test replays a shard cache, which is not
ported); both trainers' ``fit(prefetch=2)`` and ``fit_stream(prefetch=2)``
bit-identical to the same fit without prefetch; and FM trained from a
``data.synth.write_criteo_proxy`` file through ``iter_libffm_batches``
against the JAX trainers on the same file, at the trajectory tolerances of
``tests/test_torch_trainer.py`` (rtol 2e-5 / atol 2e-6)."""

import threading

import jax
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu.data import streaming as jstreaming
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu.ops import sparse_kernels as jsk
from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.data import ingest, synth
from lightctr_tpu_torch.data.streaming import iter_libffm_batches
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer, StagedBatch
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer

TABLES = {"w": ["fids"], "v": ["fids"]}
RTOL, ATOL = 2e-5, 2e-6   # tests/test_torch_trainer.py's trajectory bound
VOCAB, K = 4096, 8


def _write_ffm(path, n, seed=0, max_tok=9, vocab=997, fields=7):
    """tests/test_ingest.py's synthetic libFFM: varying nnz, blank lines
    and over-long rows."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            toks = [f"{int(rng.integers(0, fields))}:"
                    f"{int(rng.integers(0, vocab))}:"
                    f"{float(rng.integers(1, 5)) / 2}"
                    for _ in range(int(rng.integers(1, max_tok)))]
            f.write(f"{i % 2} {' '.join(toks)}\n")
            if i % 13 == 0:
                f.write("\n")
    return str(path)


def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert set(x) == set(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# -- tests/test_ingest.py's prefetch cases --------------------------------


def test_prefetch_matches_sync_and_reports_honestly(tmp_path):
    """The prefetch stage changes WHEN batches are produced, never what
    arrives: the prefetched stream is bit-identical to the synchronous
    one, and the stage reports delivered/ready counters, the
    ``ingest_overlap_ratio`` gauge, queue-wait observations, and an
    InstrumentedQueue face."""
    reg = obs.MetricsRegistry()
    p = _write_ffm(tmp_path / "t.ffm", 120)
    sync = list(iter_libffm_batches(p, 16, 6, drop_remainder=False))
    pre = list(ingest.prefetch_batches(
        iter_libffm_batches(p, 16, 6, drop_remainder=False), depth=3,
        registry=reg))
    _assert_streams_equal(pre, sync)
    snap = reg.snapshot()
    assert snap["counters"]["ingest_prefetch_batches_total"] == len(sync)
    assert 0 <= snap["counters"].get("ingest_prefetch_ready_total", 0) \
        <= len(sync)
    assert 0.0 <= snap["gauges"]["ingest_overlap_ratio"] <= 1.0
    assert snap["histograms"]["ingest_wait_seconds"]["count"] == len(sync)
    assert snap["gauges"][
        'resource_queue_capacity{queue="ingest_prefetch"}'] == 3
    with pytest.raises(ValueError, match="depth"):
        next(ingest.prefetch_batches(iter(sync), depth=0))


def test_prefetch_runs_prepare_off_the_consumer_thread():
    """``prepare`` (the trainer's staging) executes on the WORKER; the
    consumer only ever sees prepared items."""
    main = threading.get_ident()
    seen = []

    def prepare(x):
        seen.append(threading.get_ident())
        return x * 10

    out = list(ingest.prefetch_batches(iter(range(5)), depth=2,
                                       prepare=prepare,
                                       registry=obs.MetricsRegistry()))
    assert out == [0, 10, 20, 30, 40]
    assert all(t != main for t in seen)


def test_prefetch_propagates_worker_exceptions_and_closes():
    """A worker exception surfaces in the consumer (after in-flight items
    drain), and closing the generator mid-stream stops the worker without
    hanging."""
    def boom():
        yield 1
        yield 2
        raise RuntimeError("parser died")

    it = ingest.prefetch_batches(boom(), depth=2,
                                 registry=obs.MetricsRegistry())
    got = []
    with pytest.raises(RuntimeError, match="parser died"):
        for x in it:
            got.append(x)
    assert got == [1, 2]

    before = threading.active_count()
    it = ingest.prefetch_batches(iter(range(1000)), depth=2,
                                 registry=obs.MetricsRegistry())
    assert next(it) == 0
    it.close()
    deadline = 50
    while threading.active_count() > before and deadline:
        threading.Event().wait(0.02)
        deadline -= 1
    assert threading.active_count() <= before


def test_trainer_fit_with_prefetch_is_bit_identical(tmp_path):
    """``CTRTrainer.fit(prefetch=K)`` trains EXACTLY as the synchronous
    path (the same loss trajectory bit for bit), the overlap gauge and
    prefetch counters land in the trainer's telemetry, and the trajectory
    is the JAX trainer's on the same arrays."""
    from lightctr_tpu_torch.data.sparse import load_libffm

    p = _write_ffm(tmp_path / "t.ffm", 128, vocab=500)
    arrays = load_libffm(p, max_nnz=6).batch_dict()
    params = {k: np.asarray(v) for k, v in
              jfm.init(jax.random.PRNGKey(0), 500, 4).items()}
    cfg = dict(learning_rate=0.1, lambda_l2=0.001)

    def train(prefetch):
        tr = CTRTrainer(tfm.params_from_numpy(params, "cpu"), tfm.logits,
                        TrainConfig(**cfg), l2_fn=tfm.l2_penalty,
                        device="cpu")
        tr.telemetry = obs.MetricsRegistry()
        tr.health = None
        hist = tr.fit(arrays, epochs=2, batch_size=32, prefetch=prefetch)
        return hist, tr.telemetry.snapshot()

    base, _ = train(None)
    pre, snap = train(3)
    np.testing.assert_array_equal(np.asarray(base["loss"]),
                                  np.asarray(pre["loss"]))
    assert snap["counters"]["ingest_prefetch_batches_total"] == 8
    assert "ingest_overlap_ratio" in snap["gauges"]
    jt = JCTRTrainer(params, jfm.logits, JConfig(**cfg),
                     l2_fn=jfm.l2_penalty)
    jt.health = None
    jl = jt.fit(arrays, epochs=2, batch_size=32, prefetch=3)["loss"]
    np.testing.assert_allclose(pre["loss"], jl, rtol=RTOL, atol=ATOL)


# -- both trainers, prefetch against none, and against JAX on a file ------


def criteo_file(tmp_path, rows=2048, seed=1):
    return synth.write_criteo_proxy(str(tmp_path / "c.ffm"), rows,
                                    seed=seed, vocab=VOCAB)


def init_params():
    return {k: np.asarray(v) for k, v in
            jfm.init(jax.random.PRNGKey(0), VOCAB, K).items()}


def make_trainer(kind, params):
    cfg = TrainConfig(learning_rate=0.05, lambda_l2=0.001)
    kw = dict(fused_fn=tfm.logits_with_l2, device="cpu")
    if kind == "sparse":
        tr = SparseTableCTRTrainer(tfm.params_from_numpy(params, "cpu"),
                                   tfm.logits, cfg, sparse_tables=TABLES,
                                   **kw)
    else:
        tr = CTRTrainer(tfm.params_from_numpy(params, "cpu"), tfm.logits,
                        cfg, **kw)
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    return tr


def stream(path, native=True):
    return iter_libffm_batches(path, 256, 39, feature_cnt=VOCAB,
                               native=native)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fit_stream_with_prefetch_is_bit_identical(tmp_path, kind):
    """``fit_stream(prefetch=2)`` against ``fit_stream()`` on the same
    file: the losses and the trained tables bit for bit; prefetch
    delivered every batch.  The dense trainer's batches arrive staged
    (:class:`StagedBatch`), the sparse trainer's as host batches (its
    planner reads host ids)."""
    p = criteo_file(tmp_path)
    params = init_params()
    a, b = make_trainer(kind, params), make_trainer(kind, params)
    la = a.fit_stream(stream(p))
    lb = b.fit_stream(stream(p), prefetch=2)
    assert len(la) == 8 and la == lb
    for k in ("w", "v"):
        assert torch.equal(a.params[k], b.params[k])
    snap = b.telemetry.snapshot()
    assert snap["counters"]["ingest_prefetch_batches_total"] == 8
    assert (b._prefetch_prepare() is None) == (kind == "sparse")
    assert b.fit_stream(stream(p), max_steps=3, prefetch=2) == \
        a.fit_stream(stream(p), max_steps=3)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fit_with_prefetch_is_bit_identical(tmp_path, kind):
    """``fit(batch_size=, prefetch=2)`` over the file's arrays against the
    same fit without prefetch, losses and tables bit for bit."""
    from lightctr_tpu_torch.data.sparse import load_libffm

    arrays = load_libffm(criteo_file(tmp_path), max_nnz=39,
                         feature_cnt=VOCAB).batch_dict()
    params = init_params()
    a, b = make_trainer(kind, params), make_trainer(kind, params)
    ha = a.fit(arrays, epochs=2, batch_size=256)
    hb = b.fit(arrays, epochs=2, batch_size=256, prefetch=2)
    assert ha["loss"] == hb["loss"]
    for k in ("w", "v"):
        assert torch.equal(a.params[k], b.params[k])


def test_staged_batch_is_claimed_as_it_is_on_the_cpu():
    """On the CPU the staging is the plain ``_put`` and carries no event;
    a step given ``device_ready=True`` takes its tensors as they are."""
    tr = make_trainer("dense", init_params())
    batch = {"fids": np.ones((4, 39), np.int32),
             "vals": np.ones((4, 39), np.float32),
             "mask": np.ones((4, 39), np.float32),
             "labels": np.zeros(4, np.float32)}
    staged = tr._stage(batch)
    assert isinstance(staged, StagedBatch) and staged.ready is None
    assert staged.batch["fids"].dtype == torch.int32
    assert tr._claim(staged) is staged.batch
    assert tr._claim(staged.batch) is staged.batch
    loss = tr.train_step(staged, device_ready=True)
    ref = make_trainer("dense", init_params())
    assert float(loss) == float(ref.train_step(batch))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fm_from_a_criteo_proxy_file_matches_jax(tmp_path, monkeypatch,
                                                 kind):
    """FM trained from a ``write_criteo_proxy`` file (39 fields, vocab
    4096, k 8, batch 256, 8 steps) through each package's
    ``iter_libffm_batches`` and ``fit_stream(prefetch=2)``: losses and
    tables within rtol 2e-5 / atol 2e-6 of the JAX trainer's (its sparse
    kernels through their XLA twins)."""
    monkeypatch.setenv(jsk.ENV_FLAG, "xla")
    p = criteo_file(tmp_path)
    params = init_params()
    jcfg = JConfig(learning_rate=0.05, lambda_l2=0.001)
    if kind == "sparse":
        jt = JSparseTrainer(params, jfm.logits, jcfg, sparse_tables=TABLES,
                            fused_fn=jfm.logits_with_l2)
    else:
        jt = JCTRTrainer(params, jfm.logits, jcfg,
                         fused_fn=jfm.logits_with_l2)
    jt.health = None
    jl = jt.fit_stream(jstreaming.iter_libffm_batches(
        p, 256, 39, feature_cnt=VOCAB, native=True), prefetch=2)
    tt = make_trainer(kind, params)
    tl = tt.fit_stream(stream(p), prefetch=2)
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tl[-1] < tl[0]
    for k in ("w", "v"):
        np.testing.assert_allclose(tt.params[k].numpy(),
                                   np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
