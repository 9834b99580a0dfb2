"""The training slice's kernels in the port (``dedup_ids``, ``merge_apply``,
``fused_adagrad_update``): each plain version against the JAX package's
function on the same numpy inputs — the JAX side run through its Pallas
kernel under the interpreter and through its XLA reference — at the JAX
tests' own tolerances, plus dispatch, launch counts, the CUDA wrappers'
refusals and the registry's pointers to the TPU kernels they replace.  The
kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.ops import sparse_kernels as jsk
from lightctr_tpu.optim.fused_adagrad import fused_adagrad_update as j_adagrad
from lightctr_tpu_torch.ops import sparse_kernels as tsk
from lightctr_tpu_torch.optim import adagrad as t_adagrad_tx
from lightctr_tpu_torch.optim import apply_updates as t_apply
from lightctr_tpu_torch.optim.fused_adagrad import (
    fused_adagrad_plain,
    fused_adagrad_update,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["interpret", "xla"]
I32 = np.iinfo(np.int32)


# -- dedup_ids ---------------------------------------------------------------


def _dedup_streams():
    """The id streams of tests/test_sparse_kernels.py's dedup tests, plus
    negative ids and int32's limits."""
    rng = np.random.default_rng(0)
    out = {
        "random": rng.integers(0, 500, size=777),
        "heavy_with_zero": rng.choice([0, 1, 7], size=300),
        "heavy_no_zero": rng.choice([3, 9], size=256),
        "all_identical": np.full(64, 5),
        "all_zero": np.zeros(32),
        "single": np.array([42]),
        "all_distinct": np.arange(1, 97)[::-1].copy(),
        "negative_and_limits": np.concatenate([
            rng.integers(-1000, 1000, size=200),
            [I32.min, I32.max, I32.min, 0, -1, I32.max]]),
        "criteo_u4": (rng.random(2000) ** 4 * (1 << 20)),
    }
    for seed in range(4):
        r = np.random.default_rng(seed)
        out[f"few_distinct_{seed}"] = r.integers(0, 8,
                                                 size=int(r.integers(9, 200)))
    return {k: v.astype(np.int32) for k, v in out.items()}


DEDUP_STREAMS = _dedup_streams()


def _assert_dedup_equal(want, got):
    for a, b, what in zip(want, got, ("uids", "inv", "count")):
        b = b.numpy()
        assert b.dtype == np.asarray(a).dtype, what
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=what)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(DEDUP_STREAMS))
def test_dedup_plain_matches_jax_bit_exact(monkeypatch, mode, name):
    monkeypatch.setenv(jsk.ENV_FLAG, mode)
    assert jsk.resolve_impl("dedup_ids") == mode
    ids = DEDUP_STREAMS[name]
    want = jsk.dedup_ids(jnp.asarray(ids))
    got = tsk.dedup_ids(torch.from_numpy(ids))
    _assert_dedup_equal(want, got)


@pytest.mark.parametrize("mode", MODES)
def test_dedup_truncation_keeps_full_ranks(monkeypatch, mode):
    """size < distinct count: uids cut, inv at full rank, count the total."""
    monkeypatch.setenv(jsk.ENV_FLAG, mode)
    ids = np.random.default_rng(1).permutation(np.arange(1, 51)) \
        .astype(np.int32)
    want = jsk.dedup_ids(jnp.asarray(ids), size=10)
    got = tsk.dedup_ids(torch.from_numpy(ids), size=10)
    _assert_dedup_equal(want, got)
    assert int(got[2]) == 50 and int(got[1].max()) == 49


def test_dedup_empty_stream_and_cpu_dispatch_counts_nothing():
    u, inv, c = tsk.dedup_ids(torch.zeros((0,), dtype=torch.int32), size=4)
    assert u.shape == (4,) and inv.shape == (0,) and int(c) == 0
    assert not u.any()
    before = tsk.launches("dedup_ids")
    ids = torch.from_numpy(DEDUP_STREAMS["random"])
    _assert_dedup_equal(tsk.dedup_ids_plain(ids, ids.numel()),
                        tsk.dedup_ids(ids))
    # int64 ids take the plain version on the CPU, exact at any width
    wide = ids.to(torch.int64) * (1 << 33)
    u64, inv64, _ = tsk.dedup_ids(wide)
    assert u64.dtype == torch.int64 and torch.equal(inv64, tsk.dedup_ids(
        ids)[1])
    assert tsk.launches("dedup_ids") == before


def test_dedup_kernel_refuses_int64_and_cpu_tensors():
    """The kernel's contract: int32 and int64 ids (a 96-bit sort key for
    int64), on a CUDA device only; other dtypes are refused."""
    cuda = tsk.KERNELS["dedup_ids"].cuda
    for dtype in (torch.int32, torch.int64):
        # the dtype passes; the CPU tensor is what is refused
        with pytest.raises(ValueError, match="CUDA device"):
            cuda(torch.zeros(4, dtype=dtype), 4)
    for dtype in (torch.int16, torch.uint8, torch.float32):
        with pytest.raises(TypeError, match="int32 or int64"):
            cuda(torch.zeros(4, dtype=dtype), 4)


# -- merge_apply -------------------------------------------------------------


def _convention_uids(rng, s, vocab, with_zero=False):
    lo = 0 if with_zero else 1
    u = np.unique(rng.integers(lo, vocab, size=s))
    uids = np.zeros(s, np.int32)
    uids[: u.size] = u
    return uids, u.size


#: apply-only cases -> the 2-D table's width: tests/test_sparse_kernels.py's
#: 6, and 3 and 33, where the card's apply takes one float a lane (one row
#: of 3 columns per lane group, a 33-column row across the whole warp)
APPLY_WIDTHS = {"apply_2d": 6, "apply_d3": 3, "apply_d33": 33}


def _merge_apply_case(kind):
    """(table, accum, uids, rows, inv, lr, denom) of tests/test_sparse_
    kernels.py's merge_apply tests: merge mode on a 2-D table with
    denom 4, and apply-only on the 1-D (FM w) and 2-D tables (the
    widths of :data:`APPLY_WIDTHS`)."""
    rng = np.random.default_rng({"merge_2d": 3, "apply_1d": 4, "apply_2d": 5,
                                 "apply_d3": 6, "apply_d33": 7}[kind])
    if kind == "merge_2d":
        m, s, vocab, d = 160, 40, 64, 5
        uids, nu = _convention_uids(rng, s, vocab, with_zero=True)
        inv = rng.integers(0, nu, size=m).astype(np.int32)
        rows = rng.normal(size=(m, d)).astype(np.float32)
        shape, lr, denom = (vocab, d), 0.1, 4.0
    else:
        s, vocab = 24, 48
        uids, nu = _convention_uids(rng, s, vocab, with_zero=True)
        shape = ((vocab,) if kind == "apply_1d"
                 else (vocab, APPLY_WIDTHS[kind]))
        rows = rng.normal(size=(s,) + shape[1:]).astype(np.float32)
        rows[nu:] = 3.0  # pad slots: the dispatch's mask must zero them
        inv, lr, denom = None, 0.05, (1.0 if kind == "apply_1d" else 4.0)
    table = rng.normal(size=shape).astype(np.float32)
    accum = np.abs(rng.normal(size=shape)).astype(np.float32)
    return table, accum, uids, rows, inv, lr, denom


def _run_merge_apply_torch(table, accum, uids, rows, inv, lr, denom):
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    out = tsk.merge_apply(
        t, a, torch.from_numpy(uids), torch.from_numpy(rows),
        None if inv is None else torch.from_numpy(inv), lr=lr, eps=1e-7,
        denom=denom)
    assert out[0] is t and out[1] is a  # in place
    return [x.numpy() for x in out]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["merge_2d", "apply_1d", "apply_2d",
                                  "apply_d3", "apply_d33"])
def test_merge_apply_plain_matches_jax(monkeypatch, mode, kind):
    """Within the JAX test's own bounds (FMA-contraction ulp on table and
    accum, float tolerance on the sum of squares); untouched rows
    bit-identical."""
    monkeypatch.setenv(jsk.ENV_FLAG, mode)
    table, accum, uids, rows, inv, lr, denom = _merge_apply_case(kind)
    w0, a0, s0 = jsk.merge_apply(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(uids),
        jnp.asarray(rows), None if inv is None else jnp.asarray(inv),
        lr=lr, eps=1e-7, denom=denom)
    w1, a1, s1 = _run_merge_apply_torch(table, accum, uids, rows, inv, lr,
                                        denom)
    np.testing.assert_allclose(w1, np.asarray(w0), rtol=0, atol=2e-7)
    np.testing.assert_allclose(a1, np.asarray(a0), rtol=2e-6, atol=0)
    np.testing.assert_allclose(float(s1), float(s0), rtol=1e-5)
    untouched = np.setdiff1d(np.arange(table.shape[0]), uids)
    np.testing.assert_array_equal(w1[untouched], table[untouched])
    np.testing.assert_array_equal(a1[untouched], accum[untouched])


def test_merge_apply_skips_pad_slots_and_counts_nothing():
    """Pad slots (uid 0 past slot 0) move nothing even with nonzero rows;
    a real id 0 at slot 0 is applied once."""
    table = np.arange(8, dtype=np.float32) + 1.0
    accum = np.ones(8, np.float32)
    uids = np.array([0, 3, 5, 0, 0], np.int32)
    rows = np.array([0.5, -1.0, 2.0, 9.0, 9.0], np.float32)
    before = tsk.launches("merge_apply")
    w, a, s = _run_merge_apply_torch(table, accum, uids, rows, None, 0.1,
                                     1.0)
    assert tsk.launches("merge_apply") == before
    np.testing.assert_allclose(a[[0, 3, 5]], accum[[0, 3, 5]]
                               + rows[:3] ** 2, rtol=1e-6)
    touched = {0, 3, 5}
    for r in range(8):
        if r not in touched:
            assert w[r] == table[r] and a[r] == accum[r]
    np.testing.assert_allclose(float(s), float(np.sum(rows[:3] ** 2)),
                               rtol=1e-6)


@pytest.mark.parametrize("inv", [None, np.arange(6, dtype=np.int32)])
def test_merge_apply_drops_uids_outside_the_table(inv):
    """Uids outside [0, rows) as the JAX reference's scatter takes them: a
    uid in [-rows, 0) wraps to uid + rows and updates that row; any other
    is dropped from the update.  The sum of squares counts every merged
    row (matches the reference)."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(8, 3)).astype(np.float32)
    accum = np.abs(rng.normal(size=(8, 3))).astype(np.float32)
    rows = rng.normal(size=(6, 3)).astype(np.float32)
    bad = np.array([0, 3, -2, 5, 8, 0], np.int32)
    w0, a0, s0 = jsk.KERNELS["merge_apply"].reference(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(bad),
        jnp.asarray(rows * np.array([1, 1, 1, 1, 1, 0], np.float32)[:, None]
                    if inv is None else rows),
        None if inv is None else jnp.asarray(inv), 0.1, 1e-7, 1.0)
    w1, a1, s1 = _run_merge_apply_torch(table, accum, bad, rows, inv, 0.1,
                                        1.0)
    np.testing.assert_allclose(w1, np.asarray(w0), rtol=0, atol=2e-7)
    np.testing.assert_allclose(a1, np.asarray(a0), rtol=2e-6, atol=0)
    np.testing.assert_allclose(float(s1), float(s0), rtol=1e-6)
    assert w1[6].tolist() != table[6].tolist()      # -2 wrapped to row 6
    np.testing.assert_array_equal(w1[[1, 2, 4, 7]], table[[1, 2, 4, 7]])


def test_merge_apply_kernel_refuses_merge_mode_and_bad_inputs():
    """Merge mode launches (it gets past every check to the device, where
    a CPU tensor is refused, as in apply mode); bad inputs are refused."""
    t = torch.zeros((4, 2))
    u = torch.zeros(3, dtype=torch.int32)
    r = torch.zeros((3, 2))
    cuda = tsk.KERNELS["merge_apply"].cuda
    with pytest.raises(ValueError, match="CUDA device"):
        cuda(t, t.clone(), u, r, torch.zeros(3, dtype=torch.int32), 0.1,
             1e-7, 1.0)
    with pytest.raises(TypeError, match="int32 uids"):
        cuda(t, t.clone(), u.long(), r, None, 0.1, 1e-7, 1.0)
    with pytest.raises(TypeError, match="float32"):
        cuda(t.double(), t.clone(), u, r, None, 0.1, 1e-7, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda(t, t.clone(), u, r, None, 0.1, 1e-7, 1.0)


# -- fused_adagrad -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(1000, 8), (8003,), (1,)])
def test_fused_adagrad_plain_matches_jax_interpret(shape):
    """Against the JAX Pallas kernel under the interpreter, three steps,
    at sizes that do and do not divide its 1024 block
    (tests/test_fused_adagrad.py's tolerances)."""
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    w0 = rng.normal(size=shape).astype(np.float32)
    gs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jw, ja = jnp.asarray(w0), jnp.zeros(shape, jnp.float32)
    tw, ta = torch.from_numpy(w0.copy()), torch.zeros(shape)
    for g in gs:
        jw, ja = j_adagrad(jw, ja, jnp.asarray(g), lr=0.1, block=1 << 10,
                           interpret=True)
        out = fused_adagrad_update(tw, ta, torch.from_numpy(g), 0.1)
        assert out[0] is tw and out[1] is ta  # in place
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)


def test_fused_adagrad_matches_the_adagrad_transform():
    rng = np.random.default_rng(11)
    w0 = torch.from_numpy(rng.normal(size=(1000, 8)).astype(np.float32))
    gs = [torch.from_numpy(rng.normal(size=(1000, 8)).astype(np.float32))
          for _ in range(3)]
    tx = t_adagrad_tx(0.1)
    state, w_ref = tx.init(w0), w0
    w, a = w0.clone(), torch.zeros_like(w0)
    for g in gs:
        u, state = tx.update(g, state, w_ref)
        w_ref = t_apply(w_ref, u)
        fused_adagrad_update(w, a, g, 0.1)
    torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(a, state.accum, rtol=1e-6, atol=1e-7)


def test_fused_adagrad_kernel_refuses_bad_inputs():
    cuda = tsk.KERNELS["fused_adagrad"].cuda
    z = torch.zeros(8)
    with pytest.raises(TypeError, match="float32"):
        cuda(z.double(), z, z, 0.1, 1e-7)
    with pytest.raises(ValueError, match="sizes differ"):
        cuda(z, z, torch.zeros(9), 0.1, 1e-7)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda(z, z.clone(), z.clone(), 0.1, 1e-7)
    assert tsk.dispatch("fused_adagrad", z.device) is fused_adagrad_plain


# -- the registry --------------------------------------------------------------


@pytest.mark.parametrize("name, phase, head", [
    ("dedup_ids", "dedup", "def _dedup_pallas("),
    ("merge_apply", "apply", "def _merge_apply_pallas("),
    ("fused_adagrad", "adagrad", "def _adagrad_pallas("),
])
def test_registry_points_at_the_tpu_kernels(name, phase, head):
    kd = tsk.KERNELS[name]
    assert kd.phase == phase
    assert os.path.isfile(os.path.join(tsk.CSRC_DIR, kd.source))
    path, line = kd.replaces.rsplit(":", 1)
    with open(os.path.join(REPO_ROOT, path)) as f:
        src = f.read().splitlines()
    assert src[int(line) - 1].startswith(head)
    assert name in tsk.launches()
