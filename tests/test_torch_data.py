"""The port's host data plane against ``lightctr_tpu/data`` on the CPU.

The streaming reader's cases of ``tests/test_streaming.py`` that need no
reference dataset, run on the port's ``data.streaming`` (native and Python
parsers, strided shards, loop, shuffle and follow modes); then the port's
streams, loader, writers and ``shard_for_hosts`` against the JAX
package's on the same files, array for array (every comparison exact: the
two packages parse with copies of one parser)."""

import os

import numpy as np
import pytest

from lightctr_tpu.data import batching as jbatching
from lightctr_tpu.data import dense as jdense
from lightctr_tpu.data import sparse as jsparse
from lightctr_tpu.data import streaming as jstreaming
from lightctr_tpu.data import synth as jsynth
from lightctr_tpu.data import text as jtext
from lightctr_tpu_torch.data import batching as tbatching
from lightctr_tpu_torch.data import dense as tdense
from lightctr_tpu_torch.data import sparse as tsparse
from lightctr_tpu_torch.data import synth as tsynth
from lightctr_tpu_torch.data import text as ttext
from lightctr_tpu_torch.data.streaming import iter_libffm_batches


def test_native_stream_matches_python(tmp_path):
    """The C chunk parser and the Python generator yield identical batch
    streams (incl. truncation of over-long rows, id folding, tail padding)."""
    rng = np.random.default_rng(0)
    from lightctr_tpu_torch.native.bindings import available

    if not available():
        pytest.skip("native library unavailable")
    path = tmp_path / "s.ffm"
    with open(path, "w") as f:
        for i in range(37):
            nnz = rng.integers(1, 9)  # some rows exceed max_nnz=5 -> truncate
            toks = " ".join(
                f"{rng.integers(0, 7)}:{rng.integers(0, 999)}:{rng.random():.3f}"
                for _ in range(nnz)
            )
            f.write(f"{i % 2} {toks}\n")
            if i % 11 == 0:
                f.write("\n")  # blank lines are skipped
    kw = dict(batch_size=8, max_nnz=5, feature_cnt=100, field_cnt=4)
    for drop in (True, False):
        a = list(iter_libffm_batches(str(path), drop_remainder=drop, native=True, **kw))
        b = list(iter_libffm_batches(str(path), drop_remainder=drop, native=False, **kw))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for k in y:
                np.testing.assert_array_equal(x[k], y[k])


def test_native_large_ids_fold_and_error(tmp_path):
    """Ids beyond int32: with a fold both paths agree (exact long fold,
    libffm_parser.cpp ffm_parse_chunk); without one the native path raises
    instead of silently ending the stream (rc=-3)."""
    from lightctr_tpu_torch.native.bindings import available

    if not available():
        pytest.skip("native library unavailable")
    path = tmp_path / "big.ffm"
    with open(path, "w") as f:
        f.write("1 3:5000000000:1.0 1:2:0.5\n")
        f.write("0 2:7:1.0 0:4999999999:2.0\n")
        f.write("1 2:-5:1.0 1:3:0.5\n")  # negative id: Python-% fold parity
    kw = dict(batch_size=3, max_nnz=4, feature_cnt=1000, field_cnt=4)
    a = list(iter_libffm_batches(str(path), native=True, **kw))
    b = list(iter_libffm_batches(str(path), native=False, **kw))
    assert len(a) == len(b) == 1
    for k in b[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k])
    assert a[0]["fids"].max() < 1000
    with pytest.raises(ValueError, match="int32"):
        list(iter_libffm_batches(str(path), native=True, batch_size=3, max_nnz=4))


def _real_rows(batches):
    """Stack the real rows of a batch stream into flat arrays."""
    out = {}
    for b in batches:
        n = int(b["row_mask"].sum())
        for k, v in b.items():
            if k == "row_mask":
                continue
            out.setdefault(k, []).append(v[:n])
    return {k: np.concatenate(v) for k, v in out.items()}


def test_strided_workers_yield_equal_batch_counts(tmp_path):
    """SPMD lockstep: every worker must yield the SAME number of full
    batches regardless of the file's tail (255 rows, B=128, 2 workers:
    worker 0 owns 128 rows but must NOT yield a batch worker 1 can't
    match)."""
    p = tmp_path / "uneven.ffm"
    with open(p, "w") as f:
        for i in range(255):
            f.write(f"{i % 2} 0:{i % 50}:1.0 1:{(i * 7) % 50}:1.0\n")
    for native in (False, True):
        counts = [
            len(list(iter_libffm_batches(
                str(p), batch_size=128, max_nnz=4, native=native,
                process_index=w, process_count=2,
            )))
            for w in range(2)
        ]
        assert counts[0] == counts[1] == 0, (native, counts)
    # 256 rows -> both workers own exactly 128 -> both yield 1
    with open(p, "a") as f:
        f.write("1 0:3:1.0\n")
    counts = [
        len(list(iter_libffm_batches(
            str(p), batch_size=128, max_nnz=4,
            process_index=w, process_count=2,
        )))
        for w in range(2)
    ]
    assert counts == [1, 1], counts


def _write_rows(path, n, start=0):
    with open(path, "w" if start == 0 else "a") as f:
        for i in range(start, start + n):
            f.write(f"{i % 2} 0:{i % 97}:1.0 1:{(i * 7) % 97}:2.0\n")


def test_loop_mode_wraps_exactly_at_the_epoch_boundary(tmp_path):
    """``loop=True`` re-streams the file forever —
    2 epochs of the loop equal 2 back-to-back finite streams, including
    across the wrap boundary (no dropped/duplicated batch where epoch N
    ends and N+1 begins), and ``drop_remainder`` applies per epoch."""
    p = tmp_path / "loop.ffm"
    _write_rows(p, 21)  # B=4 -> 5 full batches + dropped tail, per epoch
    finite = list(iter_libffm_batches(str(p), 4, 4))
    assert len(finite) == 5
    it = iter_libffm_batches(str(p), 4, 4, loop=True)
    looped = [next(it) for _ in range(2 * len(finite))]
    for got, want in zip(looped, finite + finite):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_loop_mode_reshuffles_deterministically_per_epoch(tmp_path):
    """The per-epoch shuffle is seeded ``(seed, epoch)``: the sequence is
    reproducible run-to-run, epochs 0 and 1 order their batches
    differently, and each epoch is a permutation of the finite stream
    (no batch lost or duplicated by the shuffle buffer)."""
    p = tmp_path / "shuf.ffm"
    _write_rows(p, 24)  # 6 batches of 4
    n = 6

    def epoch_keys(count):
        it = iter_libffm_batches(str(p), 4, 4, loop=True,
                                 shuffle_batches=4, seed=3)
        return [int(next(it)["fids"][0, 0]) for _ in range(count)]

    a, b = epoch_keys(2 * n), epoch_keys(2 * n)
    assert a == b, "shuffled loop must be deterministic for one seed"
    base = [int(x["fids"][0, 0]) for x in iter_libffm_batches(str(p), 4, 4)]
    assert sorted(a[:n]) == sorted(base) == sorted(a[n:])
    assert a[:n] != a[n:], "epochs must reshuffle, not repeat"
    c = iter_libffm_batches(str(p), 4, 4, loop=True, shuffle_batches=4,
                            seed=4)
    assert [int(next(c)["fids"][0, 0]) for _ in range(n)] != a[:n]


def test_loop_mode_stop_predicate_ends_the_stream(tmp_path):
    p = tmp_path / "stop.ffm"
    _write_rows(p, 8)
    seen = []
    stream = iter_libffm_batches(str(p), 2, 4, loop=True,
                                 stop=lambda: len(seen) >= 7)
    for b in stream:
        seen.append(b)
    assert len(seen) == 7  # mid-second-epoch: the predicate ended it


def test_follow_mode_tails_and_withholds_partial_lines(tmp_path):
    """``follow=True`` tails a growing file.  A
    trailing PARTIAL line (writer mid-append, no newline yet) is never
    parsed — it would misread half a row or raise on a torn token — and
    is stitched whole once its newline lands."""
    import threading

    p = tmp_path / "tail.ffm"
    with open(p, "w") as f:
        f.write("0 0:1:1.0 1:2:1.0\n1 0:3:1.0\n")
        f.write("1 0:")  # torn mid-token: parsing it would raise
    ev = threading.Event()
    it = iter_libffm_batches(str(p), 2, 4, follow=True, stop=ev,
                             poll_s=0.01)
    b1 = next(it)  # the two COMPLETE lines; the torn tail waits
    assert int(b1["fids"][0, 0]) == 1 and int(b1["fids"][1, 0]) == 3
    assert b1["row_mask"].sum() == 2
    with open(p, "a") as f:
        f.write("5:2.5\n0 0:7:1.0\n")  # completes the torn line + one row
    b2 = next(it)
    assert int(b2["fids"][0, 0]) == 5  # the stitched line parsed as ONE row
    np.testing.assert_allclose(b2["vals"][0, 0], 2.5)
    assert int(b2["fids"][1, 0]) == 7
    ev.set()
    with pytest.raises(StopIteration):
        next(it)


def test_follow_and_loop_validate_args(tmp_path):
    p = tmp_path / "v.ffm"
    _write_rows(p, 4)
    with pytest.raises(ValueError, match="exclusive"):
        next(iter_libffm_batches(str(p), 2, 4, follow=True, loop=True))
    with pytest.raises(ValueError, match="shard"):
        next(iter_libffm_batches(str(p), 2, 4, follow=True,
                                 process_index=0, process_count=2))


def test_scan_level_shard_validates_rows_at_their_owner(tmp_path):
    """The native strided scan line-skips other workers' rows WITHOUT
    tokenizing them (the whole point: the fleet parses each row once).
    Contract: a malformed row raises in its OWNING worker's stream — so
    across a full fleet every row is still validated by exactly one
    worker — while non-owners stream past it."""
    p = tmp_path / "bad_row.ffm"
    with open(p, "w") as f:
        for i in range(64):
            if i == 33:  # worker 1's row (33 % 2 == 1)
                f.write("1 0:borked\n")
            else:
                f.write(f"{i % 2} 0:{i % 50}:1 1:{(i * 7) % 50}:2.5\n")
    # worker 1 owns the malformed row: must fail loud
    with pytest.raises(ValueError, match="bad libFFM token"):
        list(iter_libffm_batches(str(p), batch_size=16, max_nnz=4,
                                 native=True, drop_remainder=False,
                                 process_index=1, process_count=2))
    # worker 0 never tokenizes it: full shard, correct rows
    rows = _real_rows(iter_libffm_batches(
        str(p), batch_size=16, max_nnz=4, native=True,
        drop_remainder=False, process_index=0, process_count=2))
    assert len(rows["labels"]) == 32
    np.testing.assert_array_equal(rows["fids"][:, 0],
                                  np.arange(0, 64, 2) % 50)


def test_native_follow_preserves_the_partial_line_contract(tmp_path):
    """``follow=True`` through the NATIVE chunk
    parser honors the same partial-trailing-line contract as the Python
    tailer — the parse bound stops at the last newline
    (``_newline_bound``), so a writer caught mid-append is never
    misread, and the torn line parses as ONE row once its newline
    lands."""
    import threading

    from lightctr_tpu_torch.native.bindings import available

    if not available():
        pytest.skip("native library unavailable")
    p = tmp_path / "tail.ffm"
    with open(p, "w") as f:
        f.write("0 0:1:1.0 1:2:1.0\n1 0:3:1.0\n")
        f.write("1 0:")  # torn mid-token: parsing it would raise
    ev = threading.Event()
    it = iter_libffm_batches(str(p), 2, 4, follow=True, native=True,
                             stop=ev, poll_s=0.01)
    b1 = next(it)  # the two COMPLETE lines; the torn tail waits
    assert int(b1["fids"][0, 0]) == 1 and int(b1["fids"][1, 0]) == 3
    assert b1["row_mask"].sum() == 2
    with open(p, "a") as f:
        f.write("5:2.5\n0 0:7:1.0\n")  # completes the torn line + one row
    b2 = next(it)
    assert int(b2["fids"][0, 0]) == 5  # the stitched line parsed as ONE row
    np.testing.assert_allclose(b2["vals"][0, 0], 2.5)
    assert int(b2["fids"][1, 0]) == 7
    ev.set()
    with pytest.raises(StopIteration):
        next(it)


def test_native_follow_matches_python_follow(tmp_path):
    """Both tailers, fed the same growth increments, yield identical
    batches — the native path is a faster implementation of the same
    stream, not a different one."""
    import threading

    from lightctr_tpu_torch.native.bindings import available

    if not available():
        pytest.skip("native library unavailable")
    p = tmp_path / "grow.ffm"
    _write_rows(p, 5)
    ev = threading.Event()
    its = [iter_libffm_batches(str(p), 4, 4, follow=True, native=nat,
                               stop=ev, poll_s=0.01)
           for nat in (True, False)]
    batches = [[next(it)] for it in its]
    _write_rows(p, 7, start=5)  # tail past another batch boundary
    for i, it in enumerate(its):
        batches[i].append(next(it))
    ev.set()
    for a, b in zip(*batches):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_newline_bound_scans_back_to_the_last_newline(tmp_path):
    from lightctr_tpu_torch.data.streaming import _newline_bound

    p = tmp_path / "b.txt"
    p.write_bytes(b"aaa\nbb\nccc")  # 10 bytes, last newline at 6
    assert _newline_bound(str(p), 0) == 7
    assert _newline_bound(str(p), 7) == 7  # only the torn tail remains
    p.write_bytes(b"no newline at all")
    assert _newline_bound(str(p), 0) == 0



# -- against the JAX package -------------------------------------------------


def ragged_file(path, n=203, seed=1):
    """libFFM rows of 1-9 tokens (some past max_nnz), blank lines, ids up to
    5,000 and fields up to 9."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            toks = " ".join(
                f"{rng.integers(0, 9)}:{rng.integers(0, 5000)}:"
                f"{rng.random():.4f}" for _ in range(rng.integers(1, 10)))
            f.write(f"{i % 2} {toks}\n")
            if i % 29 == 0:
                f.write("\n")
    return str(path)


def assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("shard", [None, (0, 3), (2, 3)])
def test_stream_matches_jax(tmp_path, native, drop, shard):
    """Batch for batch the JAX reader's stream: truncation, folding, the
    padded tail, and a worker's strided shard."""
    p = ragged_file(tmp_path / "r.ffm")
    kw = dict(batch_size=16, max_nnz=6, feature_cnt=1000, field_cnt=4,
              drop_remainder=drop, native=native)
    if shard is not None:
        kw.update(process_index=shard[0], process_count=shard[1])
    assert_streams_equal(iter_libffm_batches(p, **kw),
                         jstreaming.iter_libffm_batches(p, **kw))


def test_loop_shuffle_matches_jax(tmp_path):
    """Two epochs of the looped, batch-shuffled stream: the JAX reader's
    order (both seed numpy's generator with (seed, epoch))."""
    p = ragged_file(tmp_path / "r.ffm", n=120)
    kw = dict(batch_size=8, max_nnz=6, loop=True, shuffle_batches=4, seed=7)
    a = iter_libffm_batches(p, **kw)
    b = jstreaming.iter_libffm_batches(p, **kw)
    assert_streams_equal([next(a) for _ in range(30)],
                         [next(b) for _ in range(30)])


@pytest.mark.parametrize("counts", [None, (1000, 4)])
def test_load_libffm_matches_jax(tmp_path, counts):
    """The eager loader's arrays and counts, discovered or folded; then
    ``take``, ``compact`` and ``pad_rows`` on both datasets."""
    p = ragged_file(tmp_path / "r.ffm")
    kw = {} if counts is None else dict(feature_cnt=counts[0],
                                        field_cnt=counts[1])
    t = tsparse.load_libffm(p, max_nnz=7, **kw)
    j = jsparse.load_libffm(p, max_nnz=7, **kw)
    assert (t.feature_cnt, t.field_cnt, t.n_rows, t.max_nnz) == (
        j.feature_cnt, j.field_cnt, j.n_rows, j.max_nnz)
    for a, b in ((t, j), (t.take(np.arange(0, 50, 3)),
                          j.take(np.arange(0, 50, 3))),
                 (t.compact()[0], j.compact()[0]),
                 (t.pad_rows(64), j.pad_rows(64))):
        for k, v in b.batch_dict().items():
            np.testing.assert_array_equal(a.batch_dict()[k], v, err_msg=k)
    np.testing.assert_array_equal(t.compact()[1], j.compact()[1])
    assert tsparse.parse_libffm_line("1 2:3:0.5") == \
        jsparse.parse_libffm_line("1 2:3:0.5")
    assert tsparse.parse_libffm_line("   ") is None
    with pytest.raises(ValueError, match="bad libFFM token"):
        tsparse.parse_libffm_line("1 2:3", "f", 4)


@pytest.mark.parametrize("writer", ["criteo", "libffm", "dense"])
def test_synthetic_writers_match_jax_byte_for_byte(tmp_path, writer):
    """The writers draw from numpy with the same seeds: the same bytes."""
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    if writer == "criteo":
        tsynth.write_criteo_proxy(t, 500, seed=3, vocab=1 << 12)
        jsynth.write_criteo_proxy(j, 500, seed=3, vocab=1 << 12)
    elif writer == "libffm":
        tsynth.write_synthetic_libffm(t, n_rows=300, seed=4)
        jsynth.write_synthetic_libffm(j, n_rows=300, seed=4)
    else:
        tsynth.write_synthetic_dense_csv(t, n_rows=40, n_features=20, seed=5)
        jsynth.write_synthetic_dense_csv(j, n_rows=40, n_features=20, seed=5)
    with open(t, "rb") as a, open(j, "rb") as b:
        assert a.read() == b.read()


def test_criteo_proxy_has_the_criteo_layout(tmp_path):
    """39 one-token fields, 26 categorical ids below the vocabulary and 13
    numeric fields on their fixed ids, through the port's reader."""
    p = tsynth.write_criteo_proxy(str(tmp_path / "c.ffm"), 256, seed=0,
                                  vocab=1 << 20)
    b = next(iter_libffm_batches(p, 256, 39, native=True))
    assert b["mask"].sum() == 256 * 39
    np.testing.assert_array_equal(b["fields"][0], np.arange(39))
    assert b["fids"][:, :26].max() < 1 << 20
    np.testing.assert_array_equal(b["fids"][:, 26:],
                                  np.broadcast_to(np.arange(26, 39),
                                                  (256, 13)))
    assert 0.2 < b["labels"].mean() < 0.8


def test_resolvers_prefer_the_path_then_the_environment(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("LIGHTCTR_DATA", raising=False)
    monkeypatch.delenv("LIGHTCTR_DENSE_DATA", raising=False)
    assert tsynth.resolve_libffm("x.ffm") == "x.ffm"
    p = tsynth.resolve_libffm(workdir=str(tmp_path))
    assert os.path.dirname(p) == str(tmp_path) and os.path.getsize(p) > 0
    d = tsynth.resolve_dense_csv(workdir=str(tmp_path))
    assert tdense.load_dense_csv(d).n_rows == 500
    monkeypatch.setenv("LIGHTCTR_DATA", "/data/train.ffm")
    monkeypatch.setenv("LIGHTCTR_DENSE_DATA", "/data/train.csv")
    assert tsynth.resolve_libffm() == "/data/train.ffm"
    assert tsynth.resolve_dense_csv() == "/data/train.csv"


def test_dense_loader_matches_jax(tmp_path):
    p = str(tmp_path / "d.csv")
    jsynth.write_synthetic_dense_csv(p, n_rows=30, n_features=12, seed=2)
    t, j = tdense.load_dense_csv(p), jdense.load_dense_csv(p)
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.take([1, 3]).features,
                                  j.take([1, 3]).features)
    raw = str(tmp_path / "raw.csv")
    with open(raw, "w") as f:
        f.write("3," + ",".join(["255"] * 4) + "\n")
    np.testing.assert_array_equal(tdense.load_dense_csv(raw).features,
                                  jdense.load_dense_csv(raw).features)


def test_text_tools_match_jax(tmp_path):
    docs = ["The cat sat on the mat.", "A dog's bone; the cat's toy!",
            "mat mat cat"]
    toks = [ttext.tokenize(d) for d in docs]
    assert toks == [jtext.tokenize(d) for d in docs]
    t, j = ttext.build_vocab(toks, 4), jtext.build_vocab(toks, 4)
    assert t[0] == j[0] and t[2] == j[2]
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(ttext.doc_term_matrix(toks, t[2]),
                                  jtext.doc_term_matrix(toks, j[2]))
    for a, b in zip(ttext.docs_to_ids(toks, t[2]),
                    jtext.docs_to_ids(toks, j[2])):
        np.testing.assert_array_equal(a, b)
    ttext.save_vocab(str(tmp_path / "t.txt"), t[0], t[1])
    jtext.save_vocab(str(tmp_path / "j.txt"), j[0], j[1])
    assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()


@pytest.mark.parametrize("count", [1, 3, 4])
def test_shard_for_hosts_matches_jax(count):
    """Each host's rows, the uneven tail trimmed, for explicit host ids;
    without them the port takes host 0 of 1 outside a process group."""
    arrays = {"x": np.arange(22 * 2).reshape(22, 2), "y": np.arange(22)}
    for host in range(count):
        t = tbatching.shard_for_hosts(arrays, host, count)
        j = jbatching.shard_for_hosts(arrays, host, count)
        for k in arrays:
            np.testing.assert_array_equal(t[k], j[k])
    whole = tbatching.shard_for_hosts(arrays)
    np.testing.assert_array_equal(whole["x"], arrays["x"])
