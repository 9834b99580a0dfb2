"""The port's compiled shard cache on the CPU, against the JAX package.

The shard cases of ``tests/test_ingest.py`` run on the port's
``data/ingest.py``, each also against the JAX module on the same file: a
cache either package compiles is the same bytes, shard files and manifest
alike, and each package replays the other's bit for bit.  Replay equals
the live parse (stride, loop reshuffle and shard shuffle included); the
fp32 escape, the ``FeatureSpec`` fold, remap, cross and digest; the torn
tail, killed compile and in-place corruption recoveries; ``as_arrays``'
three entry points; the replay under the prefetch stage; the compile tool.
Then both trainers' ``fit`` and ``fit_fullbatch_scan`` from a cache: bit
for bit the same as from the arrays it holds, and within the FM trajectory
tolerance of ``tests/test_torch_trainer.py`` (rtol 2e-5 / atol 2e-6) of
the JAX trainers fed the same cache."""

import ast
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightctr_tpu import TrainConfig as JConfig
from lightctr_tpu.data import ingest as jingest
from lightctr_tpu.models import fm as jfm
from lightctr_tpu.models.ctr_trainer import CTRTrainer as JCTRTrainer
from lightctr_tpu.models.sparse_trainer import \
    SparseTableCTRTrainer as JSparseTrainer
from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.data import ingest, synth
from lightctr_tpu_torch.data.streaming import iter_libffm_batches
from lightctr_tpu_torch.models import fm as tfm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer

REPO_ROOT = Path(__file__).resolve().parent.parent
TABLES = {"w": ["fids"], "v": ["fids"]}
RTOL, ATOL = 2e-5, 2e-6   # tests/test_torch_trainer.py's trajectory bound
VOCAB, K = 4096, 8


def _write_ffm(path, n, seed=0, max_tok=9, vocab=997, fields=7,
               val_fn=None):
    """tests/test_ingest.py's synthetic libFFM: varying nnz, blank lines
    and over-long rows that exercise truncation."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            nnz = int(rng.integers(1, max_tok))
            toks = []
            for _ in range(nnz):
                v = val_fn(rng) if val_fn else float(rng.integers(1, 5)) / 2
                toks.append(f"{int(rng.integers(0, fields))}:"
                            f"{int(rng.integers(0, vocab))}:{v}")
            f.write(f"{i % 2} {' '.join(toks)}\n")
            if i % 13 == 0:
                f.write("\n")  # blank lines are skipped by both paths
    return str(path)


def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert set(x) == set(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _dir_bytes(cache_dir):
    """{file name: bytes} of a cache directory."""
    return {n: (Path(cache_dir) / n).read_bytes()
            for n in sorted(os.listdir(cache_dir))}


# -- the format: one definition, two packages ---------------------------------


@pytest.mark.parametrize("spec", [False, True])
def test_both_packages_write_identical_caches_and_cross_load(tmp_path, spec):
    """The JAX package and the port compile the same file (with and
    without a FeatureSpec, several shards) into byte-identical
    directories; each package replays the other's cache bit for bit."""
    fs = dict(fold_features=128, field_remap={5: 1, 6: 2},
              crosses=((0, 1),), cross_feature_cnt=64,
              cross_field_base=10) if spec else None
    p = _write_ffm(tmp_path / "t.ffm", 300)
    kw = dict(max_nnz=6, block_rows=32, shard_rows=64)
    tc = ingest.compile_shards(
        p, cache_dir=str(tmp_path / "port"),
        spec=ingest.FeatureSpec(**fs) if spec else None, **kw)
    jc = jingest.compile_shards(
        p, cache_dir=str(tmp_path / "jax"),
        spec=jingest.FeatureSpec(**fs) if spec else None, **kw)
    assert tc.n_shards >= 3
    assert _dir_bytes(tc.dir) == _dir_bytes(jc.dir)
    assert tc.manifest == jc.manifest
    for batch in (32, 50):
        want = list(jingest.iter_shard_batches(jc, batch,
                                               drop_remainder=False))
        _assert_streams_equal(ingest.iter_shard_batches(
            ingest.load_cache(jc.dir), batch, drop_remainder=False), want)
        _assert_streams_equal(jingest.iter_shard_batches(
            jingest.load_cache(tc.dir), batch, drop_remainder=False), want)


def test_shard_replay_is_bit_identical_to_live_parse(tmp_path):
    """Every replay batch (full batches and the padded tail) is
    bit-identical to the live Python parser's stream."""
    p = _write_ffm(tmp_path / "t.ffm", 300)
    cache = ingest.compile_shards(p, max_nnz=6,
                                  cache_dir=str(tmp_path / "c"))
    for drop in (True, False):
        _assert_streams_equal(
            ingest.iter_shard_batches(cache, 32, drop_remainder=drop),
            iter_libffm_batches(p, 32, 6, drop_remainder=drop,
                                native=False))


def test_python_compile_path_writes_identical_shards(tmp_path,
                                                     monkeypatch):
    """The pure-Python encoder writes the same shard bytes as the native
    chunk-parser path, and the numpy decode reads them back
    bit-identically."""
    from lightctr_tpu_torch.native import bindings

    if not bindings.available():
        pytest.skip("native library unavailable")
    p = _write_ffm(tmp_path / "t.ffm", 150)
    nat = ingest.compile_shards(p, max_nnz=6,
                                cache_dir=str(tmp_path / "nat"))
    nat_batches = list(ingest.iter_shard_batches(nat, 32))
    monkeypatch.setattr(ingest.bindings, "available", lambda: False)
    py = ingest.compile_shards(p, max_nnz=6,
                               cache_dir=str(tmp_path / "py"))
    assert py.n_shards == nat.n_shards
    for i in range(py.n_shards):
        assert Path(nat.shard_path(i)).read_bytes() == \
            Path(py.shard_path(i)).read_bytes(), f"shard {i} bytes differ"
    _assert_streams_equal(ingest.iter_shard_batches(py, 32), nat_batches)


def test_varint_and_checksum_match_the_jax_codecs():
    """The codecs and the frame checksum are the JAX module's, on the
    same inputs (both with the native library and the Python oracle)."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.integers(-2**40, 2**40, 200),
                           [0, -1, 1, 2**62, -2**62]]).astype(np.int64)
    packed = ingest._pack_varint(vals)
    assert packed == jingest._pack_varint(vals)
    got, used = ingest._unpack_varint(packed, vals.size)
    np.testing.assert_array_equal(got, vals)
    assert used == len(packed)
    for n in (0, 1, 7, 8, 9, 4099):
        blob = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert ingest._checksum_bytes(blob) == jingest._checksum_bytes(blob)


def test_fp32_escape_keeps_nonhalf_values_exact(tmp_path):
    """Values that do not round-trip through fp16 (0.1, ...) flip the
    block to the fp32 escape: replay stays bit-exact."""
    p = _write_ffm(tmp_path / "t.ffm", 60,
                   val_fn=lambda r: float(r.integers(1, 100)) / 10)
    cache = ingest.compile_shards(p, max_nnz=6,
                                  cache_dir=str(tmp_path / "c"))
    blob = Path(cache.shard_path(0)).read_bytes()
    flags = ingest._BLOCK_HEADER.unpack_from(blob, len(ingest._MAGIC))[2]
    assert not flags & ingest._FLAG_VALS_F16
    _assert_streams_equal(
        ingest.iter_shard_batches(cache, 16, drop_remainder=False),
        iter_libffm_batches(p, 16, 6, drop_remainder=False, native=False))


def test_feature_spec_fold_remap_cross_parity(tmp_path):
    """A FeatureSpec (hash fold, field remap, one cross) applied at
    compile time replays bit-identically to the live path applying the
    same spec, and to the JAX package's live path; the cross lands."""
    kw = dict(fold_features=128, field_remap={5: 1, 6: 2},
              crosses=((0, 1),), cross_feature_cnt=64, cross_field_base=10)
    spec = ingest.FeatureSpec(**kw)
    p = _write_ffm(tmp_path / "t.ffm", 200)
    cache = ingest.compile_shards(p, max_nnz=6, spec=spec,
                                  cache_dir=str(tmp_path / "c"))
    assert cache.width == 6 + spec.extra_nnz
    replay = list(ingest.iter_shard_batches(cache, 32,
                                            drop_remainder=False))
    live = list(ingest.iter_ingest_batches(
        p, 32, 6, spec=spec, compile=False, drop_remainder=False))
    _assert_streams_equal(replay, live)
    _assert_streams_equal(replay, jingest.iter_ingest_batches(
        p, 32, 6, spec=jingest.FeatureSpec(**kw), compile=False,
        drop_remainder=False))
    fields = np.concatenate([b["fields"] for b in replay])
    fids = np.concatenate([b["fids"] for b in replay])
    assert (fields == 10).any(), "cross tokens never materialized"
    assert fids.max() < 128, "fold did not apply"
    assert not np.isin(fields, [5, 6]).any(), "remap left raw fields"


def test_feature_spec_validation_digest_and_fold_conflict(tmp_path):
    with pytest.raises(ValueError, match="cross"):
        ingest.FeatureSpec(crosses=((0, 1),))
    kw = dict(fold_features=100, crosses=((0, 1),), cross_feature_cnt=16,
              cross_field_base=9)
    spec = ingest.FeatureSpec(**kw)
    again = ingest.FeatureSpec.from_dict(
        json.loads(json.dumps(spec.to_dict())))
    assert again.digest() == spec.digest()
    assert again == spec
    # the digest keys the manifest: both packages must agree on it
    assert spec.digest() == jingest.FeatureSpec(**kw).digest()
    p = _write_ffm(tmp_path / "t.ffm", 10)
    with pytest.raises(ValueError, match="conflict"):
        ingest.compile_shards(p, max_nnz=4, feature_cnt=50, spec=spec,
                              cache_dir=str(tmp_path / "c"))


# -- crash safety -------------------------------------------------------------


def test_cache_hit_recompile_and_torn_tail_recovery(tmp_path):
    """A matching manifest is a cache hit (also one the JAX package
    wrote); a truncated shard is a miss that recompiles, counted as a
    recovery, and verifies clean."""
    reg = obs.MetricsRegistry()
    p = _write_ffm(tmp_path / "t.ffm", 120)
    cdir = str(tmp_path / "c")
    jingest.compile_shards(p, max_nnz=6, cache_dir=cdir)
    cache = ingest.compile_shards(p, max_nnz=6, cache_dir=cdir,
                                  registry=reg)
    rows = cache.rows
    snap = reg.snapshot()["counters"]
    assert snap["ingest_shard_cache_hits_total"] == 1
    assert "ingest_shard_compiles_total" not in snap
    ingest.compile_shards(p, max_nnz=6, cache_dir=cdir, registry=reg)
    snap = reg.snapshot()["counters"]
    assert snap["ingest_shard_cache_hits_total"] == 2

    sp = cache.shard_path(cache.n_shards - 1)
    with open(sp, "r+b") as f:
        f.truncate(os.path.getsize(sp) - 3)
    assert ingest.load_cache(cdir) is None  # size mismatch = miss
    cache = ingest.compile_shards(p, max_nnz=6, cache_dir=cdir,
                                  registry=reg)
    snap = reg.snapshot()["counters"]
    assert snap["ingest_shard_recoveries_total"] == 1
    assert snap["ingest_shard_compiles_total"] == 1
    assert cache.verify() == rows


def test_kill_mid_compile_debris_recompiles_clean(tmp_path):
    """A compile killed before the manifest lands leaves tmp files and
    partial shards but no manifest: the next compile sweeps the debris,
    counts a recovery, and writes a cache that verifies."""
    reg = obs.MetricsRegistry()
    p = _write_ffm(tmp_path / "t.ffm", 80)
    cdir = tmp_path / "c"
    cdir.mkdir()
    (cdir / ".shard-00000.lcs.tmp-999").write_bytes(b"partial")
    (cdir / "shard-00000.lcs").write_bytes(ingest._MAGIC + b"torn")
    cache = ingest.compile_shards(p, max_nnz=6, cache_dir=str(cdir),
                                  registry=reg)
    snap = reg.snapshot()["counters"]
    assert snap["ingest_shard_recoveries_total"] == 1
    assert not [n for n in os.listdir(cdir) if n.startswith(".")]
    assert cache.verify() == cache.rows > 0


def test_inplace_corruption_fails_the_frame_checksum(tmp_path):
    """Same-size corruption slips past the manifest's size check; the
    block checksum catches it at replay, and force=True rebuilds."""
    p = _write_ffm(tmp_path / "t.ffm", 90)
    cdir = str(tmp_path / "c")
    cache = ingest.compile_shards(p, max_nnz=6, cache_dir=cdir)
    with open(cache.shard_path(0), "r+b") as f:
        f.seek(len(ingest._MAGIC) + ingest._BLOCK_HEADER.size + 5)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    assert ingest.load_cache(cdir) is not None  # size still matches
    with pytest.raises(ingest.ShardCorruption):
        list(ingest.iter_shard_batches(ingest.load_cache(cdir), 16))
    cache = ingest.compile_shards(p, max_nnz=6, cache_dir=cdir,
                                  force=True)
    assert cache.verify() == cache.rows
    _assert_streams_equal(
        ingest.iter_shard_batches(cache, 16, drop_remainder=False),
        iter_libffm_batches(p, 16, 6, drop_remainder=False, native=False))


# -- deterministic replay -----------------------------------------------------


def test_stride_sharding_parity_with_live(tmp_path):
    """Replay under ``process_index % process_count`` striding yields the
    live reader's per-worker batches, and the JAX replay's."""
    p = _write_ffm(tmp_path / "t.ffm", 260)
    cache = ingest.compile_shards(p, max_nnz=6,
                                  cache_dir=str(tmp_path / "c"))
    for w in range(2):
        got = list(ingest.iter_shard_batches(cache, 32, process_index=w,
                                             process_count=2))
        _assert_streams_equal(
            got, iter_libffm_batches(p, 32, 6, native=False,
                                     process_index=w, process_count=2))
        _assert_streams_equal(got, jingest.iter_shard_batches(
            jingest.load_cache(cache.dir), 32, process_index=w,
            process_count=2))
    with pytest.raises(ValueError):
        next(ingest.iter_shard_batches(cache, 32, process_index=1))
    with pytest.raises(ValueError):
        next(ingest.iter_shard_batches(cache, 32, process_index=2,
                                       process_count=2))


def test_loop_reshuffle_matches_live_per_epoch(tmp_path):
    """The looped and shuffled shard stream is the live looped and
    shuffled stream, bit for bit, for two full epochs."""
    p = _write_ffm(tmp_path / "t.ffm", 96)
    cache = ingest.compile_shards(p, max_nnz=6,
                                  cache_dir=str(tmp_path / "c"))
    n_finite = len(list(ingest.iter_shard_batches(cache, 8)))
    kw = dict(loop=True, shuffle_batches=4, seed=3)
    a = ingest.iter_shard_batches(cache, 8, **kw)
    b = iter_libffm_batches(p, 8, 6, native=False, **kw)
    for _ in range(2 * n_finite):
        x, y = next(a), next(b)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_shard_shuffle_is_seeded_and_lossless(tmp_path):
    """``shard_shuffle`` permutes shard order per epoch from the ``(seed,
    epoch, salt)`` stream: deterministic, different across epochs, the
    JAX replay's order, and every epoch delivers every row."""
    p = _write_ffm(tmp_path / "t.ffm", 200)
    cache = ingest.compile_shards(p, max_nnz=6, block_rows=32,
                                  shard_rows=64,
                                  cache_dir=str(tmp_path / "c"))
    jcache = jingest.load_cache(cache.dir)
    assert cache.n_shards >= 3
    per_epoch = len(list(ingest.iter_shard_batches(cache, 8)))

    def epochs(mod, c, seed, n_epochs):
        it = mod.iter_shard_batches(c, 8, loop=True, shard_shuffle=True,
                                    seed=seed)
        return [[next(it) for _ in range(per_epoch)]
                for _ in range(n_epochs)]

    a, b = epochs(ingest, cache, 5, 2), epochs(ingest, cache, 5, 2)
    j = epochs(jingest, jcache, 5, 2)
    for ea, eb, ej in zip(a, b, j):
        _assert_streams_equal(ea, eb)
        _assert_streams_equal(ea, ej)
    key = [int(x["fids"][0, 0]) for x in a[0]]
    assert key != [int(x["fids"][0, 0]) for x in a[1]], \
        "epochs must re-permute shards"
    base = sorted(int(x["labels"].sum()) for x in
                  ingest.iter_shard_batches(cache, 8))
    for e in a:
        assert sorted(int(x["labels"].sum()) for x in e) == base


def test_as_arrays_all_entry_points(tmp_path):
    """``as_arrays`` gives the same padded arrays from a ShardCache, its
    directory and the raw file (compiled on first touch), and the JAX
    module's arrays from the same cache."""
    p = _write_ffm(tmp_path / "t.ffm", 70)
    cdir = str(tmp_path / "c")
    cache = ingest.compile_shards(p, max_nnz=6, cache_dir=cdir)
    a = ingest.as_arrays(cache)
    b = ingest.as_arrays(cdir)
    c = ingest.as_arrays(p, max_nnz=6, cache_dir=cdir)
    j = jingest.as_arrays(cdir)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    assert len(a["labels"]) == cache.rows
    with pytest.raises(ValueError, match="max_nnz"):
        ingest.as_arrays(str(tmp_path / "t.ffm") + ".nope")
    with pytest.raises(TypeError):
        ingest.as_arrays(42)


def test_replay_under_prefetch_is_bit_identical(tmp_path):
    """The aligned fast path yields slices of a decoded block: behind the
    prefetch stage, and through a dense trainer's staging (which copies
    each batch), the replay is the replay without prefetch, bit for
    bit."""
    p = _write_ffm(tmp_path / "t.ffm", 300)
    cache = ingest.compile_shards(p, max_nnz=6, block_rows=64,
                                  cache_dir=str(tmp_path / "c"))
    sync = list(ingest.iter_shard_batches(cache, 32))
    _assert_streams_equal(ingest.prefetch_batches(
        ingest.iter_shard_batches(cache, 32), depth=2), sync)
    params = {k: np.asarray(v) for k, v in
              jfm.init(jax.random.PRNGKey(0), 997, 4).items()}
    losses = []
    for prefetch in (None, 2):
        tr = CTRTrainer(tfm.params_from_numpy(params, "cpu"), tfm.logits,
                        TrainConfig(learning_rate=0.1), device="cpu")
        tr.health = None
        losses.append(tr.fit_stream(ingest.iter_shard_batches(cache, 32),
                                    prefetch=prefetch))
    assert losses[0] == losses[1] and len(losses[0]) == len(sync)


def test_every_ingest_series_is_declared_and_emitted():
    """No dark ingest counters: every ``ingest_*`` series the port's data
    plane emits (a literal first argument of a registry ``inc`` /
    ``gauge_set`` / ``observe``) is declared in ``INGEST_SERIES``, every
    declared one is emitted, and the set is the JAX module's."""
    emitted = set()
    for path in sorted((REPO_ROOT / "lightctr_tpu_torch" / "data")
                       .glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("inc", "gauge_set", "observe")
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and str(node.args[0].value).startswith("ingest_")):
                emitted.add(node.args[0].value)
    declared = set(ingest.INGEST_SERIES)
    assert len(declared) == len(ingest.INGEST_SERIES)
    assert emitted == declared
    assert ingest.INGEST_SERIES == jingest.INGEST_SERIES


def test_compile_tool_matches_the_jax_tool(tmp_path, capsys):
    """``python -m lightctr_tpu_torch.tools.ingest_compile`` writes the
    cache the JAX package's tool writes, reports the same JSON, verifies,
    and a second run is a cache hit."""
    import tools.ingest_compile as jtool
    from lightctr_tpu_torch.tools import ingest_compile as ttool

    p = _write_ffm(tmp_path / "t.ffm", 200)

    def run(tool, name):
        argv = [p, "--max-nnz", "6", "--cache-dir", str(tmp_path / name),
                "--block-rows", "32", "--shard-rows", "64", "--verify"]
        assert tool.main(argv) == 0
        out = json.loads(capsys.readouterr().out)
        for k in ("compile_seconds", "verify_seconds", "cache_dir"):
            out.pop(k)
        return out

    t = run(ttool, "port")
    assert t == run(jtool, "jax")
    assert t["verified_rows"] == t["rows"] == 200
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "jax")
    mtime = os.path.getmtime(tmp_path / "port" / "manifest.json")
    assert run(ttool, "port") == t
    assert os.path.getmtime(tmp_path / "port" / "manifest.json") == mtime


# -- the trainers take a cache ------------------------------------------------


def criteo_cache(tmp_path, module=ingest, name="cache"):
    """A 2,048-row Criteo-proxy file compiled (by ``module``) at the
    trainers' width."""
    p = str(tmp_path / "c.ffm")
    if not os.path.exists(p):
        synth.write_criteo_proxy(p, 2048, seed=1, vocab=VOCAB)
    return module.compile_shards(p, 39, cache_dir=str(tmp_path / name),
                                 feature_cnt=VOCAB)


def init_params():
    return {k: np.asarray(v) for k, v in
            jfm.init(jax.random.PRNGKey(0), VOCAB, K).items()}


CFG = dict(learning_rate=0.05, lambda_l2=0.001)


def make_trainer(kind, params):
    kw = dict(fused_fn=tfm.logits_with_l2, device="cpu")
    if kind == "sparse":
        tr = SparseTableCTRTrainer(tfm.params_from_numpy(params, "cpu"),
                                   tfm.logits, TrainConfig(**CFG),
                                   sparse_tables=TABLES, **kw)
    else:
        tr = CTRTrainer(tfm.params_from_numpy(params, "cpu"), tfm.logits,
                        TrainConfig(**CFG), **kw)
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    return tr


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fit_from_a_cache_is_fit_from_its_arrays(tmp_path, kind):
    """``fit(<cache dir>)``, ``fit(ShardCache)`` and ``fit(as_arrays(...))``
    train bit-identically (minibatches and full batch), and so do
    ``fit_fullbatch_scan`` from the directory and from the arrays."""
    cache = criteo_cache(tmp_path)
    arrays = ingest.as_arrays(cache)
    params = init_params()
    runs = []
    for src in (cache.dir, cache, arrays):
        tr = make_trainer(kind, params)
        hist = tr.fit(src, epochs=2, batch_size=256)
        full = tr.fit(src, epochs=1)
        scan = tr.fit_fullbatch_scan(src, 2)
        runs.append((hist["loss"], full["loss"], scan.tolist(),
                     {k: tr.params[k].clone() for k in ("w", "v")}))
    for other in runs[1:]:
        assert other[:3] == runs[0][:3]
        for k in ("w", "v"):
            assert torch.equal(other[3][k], runs[0][3][k])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fit_from_a_cache_matches_the_jax_trainer(tmp_path, monkeypatch,
                                                  kind):
    """The port's trainer fed the port's cache and the JAX trainer (its
    sparse kernels through their XLA twins) fed the JAX package's cache of
    the same file (the same bytes): the replayed stream (8 batches of 256
    through ``fit_stream``, as ``tests/test_torch_ingest.py``'s file test
    feeds the live parse) and then 3 full-batch ``fit`` epochs from the
    cache directories; losses and tables within the FM trajectory
    tolerance (rtol 2e-5 / atol 2e-6)."""
    from lightctr_tpu.ops import sparse_kernels as jsk

    monkeypatch.setenv(jsk.ENV_FLAG, "xla")
    tc = criteo_cache(tmp_path)
    jc = criteo_cache(tmp_path, jingest, "jax_cache")
    params = init_params()
    tr = make_trainer(kind, params)
    if kind == "sparse":
        jt = JSparseTrainer(params, jfm.logits, JConfig(**CFG),
                            sparse_tables=TABLES,
                            fused_fn=jfm.logits_with_l2)
    else:
        jt = JCTRTrainer(params, jfm.logits, JConfig(**CFG),
                         fused_fn=jfm.logits_with_l2)
    jt.health = None
    tl = tr.fit_stream(ingest.iter_shard_batches(tc, 256))
    jl = jt.fit_stream(jingest.iter_shard_batches(jc, 256))
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    tl = tr.fit(tc.dir, epochs=3)["loss"]
    jl = jt.fit(jc.dir, epochs=3)["loss"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jt.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
