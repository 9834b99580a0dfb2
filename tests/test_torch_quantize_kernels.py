"""The data-parallel slice's kernels in the port (``merge_rows``,
``merge_apply``'s merge mode, ``quantize_pack``, ``quantize_pack_ef``,
``quantize_pack_ef_update``) and the quantile codec (``ops/quantize.py``):
each plain version against the JAX package's function on the same numpy
inputs — the quantize kernels fed the SAME table arrays in both packages —
plus a numpy model of the order in which the card's merge adds (held to
the plain version, ``segment_sum`` and the interpreted TPU kernel under
hypothesis), dispatch, launch counts, the CUDA wrappers' refusals and the
registry's pointers to the TPU kernels.
The kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import itertools
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lightctr_tpu.ops import quantize as jquant
from lightctr_tpu.ops import sparse_kernels as jsk
from lightctr_tpu_torch.ops import quantize as tquant
from lightctr_tpu_torch.ops import sparse_kernels as tsk

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: ulp bounds of normal and log tables between the packages (symmetric
#: ranges): ``ndtri`` and ``pow`` differ by a few ulp between XLA and
#: PyTorch, and a log table's smallest edges carry their relative error
NORMAL_ULP, LOG_ULP = 16, 32


def ulp(a, b) -> int:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(1 << 31) - i, i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _same_table(jt):
    """The JAX table's arrays as a port table (both packages encode
    through the SAME boundaries and values)."""
    return tquant.QuantTable(torch.from_numpy(np.array(jt.boundaries)),
                             torch.from_numpy(np.array(jt.values)), jt.bits)


# -- build_table ---------------------------------------------------------------

RANGES = [(-1.0, 1.0), (-0.37, 0.37), (-3e-5, 3e-5), (-2.0, 0.5)]


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_uniform_tables_are_bit_identical(bits):
    """Python-float ranges and a measured range (a 0-d tensor; a traced
    scalar in JAX)."""
    for lo, hi in RANGES:
        j = jquant.build_table(lo, hi, bits, "uniform")
        t = tquant.build_table(lo, hi, bits, "uniform")
        np.testing.assert_array_equal(t.boundaries.numpy(),
                                      np.asarray(j.boundaries))
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    for r in (0.123, 1.7, 3.3e-4):
        jb = jax.jit(lambda x: jquant.build_table(
            -x, x, bits, "uniform").boundaries)(jnp.float32(r))
        tr = torch.tensor(r, dtype=torch.float32)
        np.testing.assert_array_equal(
            tquant.build_table(-tr, tr, bits, "uniform").boundaries.numpy(),
            np.asarray(jb))


@pytest.mark.parametrize("mode, bound", [("normal", NORMAL_ULP),
                                         ("log", LOG_ULP)])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_normal_and_log_tables_within_ulp(mode, bound, bits):
    for r in (1.0, 0.37, 3e-5):
        j = jquant.build_table(-r, r, bits, mode)
        t = tquant.build_table(-r, r, bits, mode)
        assert t.bits == bits and t.values.dtype == torch.float32
        assert ulp(t.boundaries.numpy(), j.boundaries) <= bound
        assert ulp(t.values.numpy(), j.values) <= bound
        assert torch.all(t.boundaries[1:] > t.boundaries[:-1])


def test_custom_table_and_refusals():
    edges = np.linspace(-2, 2, 17).astype(np.float32) ** 3
    j = jquant.build_table(0, 0, 4, "custom", custom_cdf_values=edges)
    t = tquant.build_table(0, 0, 4, "custom",
                           custom_cdf_values=torch.from_numpy(edges))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    with pytest.raises(ValueError, match="custom_cdf_values"):
        tquant.build_table(0, 1, 4, "custom")
    with pytest.raises(ValueError, match="17 edges"):
        tquant.build_table(0, 1, 4, "custom",
                           custom_cdf_values=torch.zeros(5))
    with pytest.raises(ValueError, match="unknown mode"):
        tquant.build_table(0, 1, 4, "cubic")


def test_compress_extract_and_nibbles_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(33, 5)).astype(np.float32)
    x.reshape(-1)[:4] = [np.inf, -np.inf, np.nan, 0.0]
    for bits, mode in ((4, "normal"), (8, "uniform"), (16, "uniform")):
        jt = jquant.build_table(-1.5, 1.5, bits, mode)
        tt = _same_table(jt)
        jc = jquant.compress(jt, jnp.asarray(x))
        tc = tquant.compress(tt, torch.from_numpy(x))
        assert tc.dtype == tquant.code_dtype(bits)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tquant.extract(tt, tc).numpy(),
                                      np.asarray(jquant.extract(jt, jc)))
    codes = rng.integers(0, 16, size=33).astype(np.uint8)
    packed = tquant.pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jquant.pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        tquant.unpack_nibbles(packed, 33).numpy(), codes)


# -- quantize_pack -------------------------------------------------------------


def _payload(seed, shape=(257, 6)):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1)[:6] = [np.inf, -np.inf, np.nan, 3.0, -3.0, 0.0]
    return x


@pytest.mark.parametrize("bits, mode", [(4, "normal"), (8, "uniform"),
                                        (8, "normal"), (16, "uniform")])
def test_quantize_pack_plain_is_compress_bit_exact(bits, mode):
    """Against the JAX reference (``quantize.compress``), NaN and +-inf
    included: NaN and +inf take the top code, -inf code 0.  (The TPU's
    compare-count kernel gives NaN code 0 instead.)"""
    jt = jquant.build_table(-2.0, 2.0, bits, mode)
    x = _payload(bits)
    want = np.asarray(jquant.compress(jt, jnp.asarray(x)))
    before = tsk.launches("quantize_pack")
    got = tsk.quantize_pack(_same_table(jt), torch.from_numpy(x))
    assert tsk.launches("quantize_pack") == before
    np.testing.assert_array_equal(got.numpy(), want)
    top = (1 << bits) - 1
    assert got.reshape(-1)[:3].tolist() == [top, 0, top]
    packed = tsk.quantize_pack_packed(_same_table(jt), torch.from_numpy(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(jsk.ENV_FLAG, "xla")
        jpacked = jsk.quantize_pack_packed(jt, jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_pack_plain_matches_the_interpreted_tpu_kernel(
        monkeypatch, bits):
    """The Pallas compare-count kernel under the interpreter, on finite
    values and +-inf (where the two encodes agree)."""
    monkeypatch.setenv(jsk.ENV_FLAG, "interpret")
    jt = jquant.build_table(-2.0, 2.0, bits, "normal")
    x = _payload(bits + 1)
    x[np.isnan(x)] = 0.5
    want = np.asarray(jsk.quantize_pack(jt, jnp.asarray(x)))
    got = tsk.quantize_pack(_same_table(jt), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the card's search layout (csrc/quantile_search.cuh), in numpy ------------


def _header_int(name):
    """A ``constexpr int`` of the search header, so the model follows the
    split the header sets."""
    path = os.path.join(REPO_ROOT, "lightctr_tpu_torch", "csrc",
                        "quantile_search.cuh")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def tree_rank(i, levels):
    """Node i's in-order rank in an Eytzinger tree of ``levels`` levels."""
    i = np.asarray(i, np.int64)
    level = np.frexp(i.astype(np.float64))[1] - 1
    return ((2 * (i - (1 << level)) + 1) << (levels - 1 - level)) - 1


def tree_node(r, levels):
    """The node holding sorted index r (``tree_rank``'s inverse)."""
    p = np.asarray(r, np.int64) + 1
    z = np.frexp((p & -p).astype(np.float64))[1] - 1
    return (1 << (levels - 1 - z)) + (p >> (z + 1))


def tree_descend(tree, x, levels):
    """Right past every node below x; the number of keys below x."""
    i = np.ones(x.shape, np.int64)
    for _ in range(levels):
        i = 2 * i + (tree[i] < x)
    return i - (1 << levels)


def tree_code_model(bnd, x):
    """``stage_tree`` then ``shared_code``: the table (up to 8 bits) as an
    Eytzinger tree, node i holding boundary ``tree_rank(i)``, +inf past
    the last."""
    levels, nb = _header_int("kTreeLevels"), bnd.size
    tree = np.full(1 << levels, np.inf, np.float32)
    i = np.arange(1, 1 << levels)
    r = tree_rank(i, levels)
    tree[i] = np.where(r < nb, bnd[np.minimum(r, nb - 1)], np.inf)
    return np.where(np.isnan(x), nb, tree_descend(tree, x, levels))


def split_code_model(bnd, x, mis):
    """``split_table``, ``stage_split`` then ``split_code`` for boundaries
    whose address is ``mis`` floats past 16 bytes: a head of (4 - mis) % 4
    boundaries, segments of kSegWidth after it keyed by their last
    boundary in a kTopLevels tree (+inf from the last segment on), then a
    count inside the one segment, its positions past nb masked.  Asserts
    the float4 loads start on 16 bytes and stay in the table's last
    16-byte chunk."""
    levels, width = _header_int("kTopLevels"), _header_int("kSegWidth")
    nb = bnd.size
    head = min((4 - mis) % 4, nb)
    nseg = (nb - head + width - 1) // width
    r = np.arange((1 << levels) - 1)
    key_at = head + r * width + width - 1
    tree = np.full(1 << levels, np.inf, np.float32)
    tree[tree_node(r, levels)] = np.where(
        r < nseg - 1, bnd[np.minimum(key_at, nb - 1)], np.inf)
    j = tree_descend(tree, x, levels)
    first = head + j * width
    chunk = first[:, None] + 4 * np.arange(width // 4)
    loaded = chunk[chunk < nb]
    assert ((mis + loaded) % 4 == 0).all()
    assert ((mis + loaded) // 4 <= (mis + nb - 1) // 4).all()
    pos = np.arange(width)
    seg = bnd[np.clip(first[:, None] + pos, 0, nb - 1)]
    inside = ((pos < (nb - first)[:, None]) & (seg < x[:, None])).sum(1)
    below_head = (bnd[:head][None, :] < x[:, None]).sum(1)
    code = j * width + np.where(j == 0, below_head, head) + inside
    return np.where(np.isnan(x), nb, code)


def search_values(bnd, seed):
    """Every boundary and one ulp either side, values between, NaN, +-inf,
    +-0 and values past both ends, shuffled."""
    rng = np.random.default_rng(seed)
    inf = np.float32(np.inf)
    x = np.concatenate([
        bnd, np.nextafter(bnd, inf), np.nextafter(bnd, -inf),
        rng.normal(size=2000).astype(np.float32) * max(1.0, abs(bnd).max()),
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30],
                 np.float32)])
    return rng.permutation(x)


def assert_codes_match_jax(jt, x, got):
    """``got`` equals the JAX package's ``compress`` wherever x is not
    subnormal: XLA's CPU code flushes subnormal inputs to zero (the
    smallest one above a 0.0 boundary takes the code below it there),
    where numpy, PyTorch and the card compare them as they are."""
    normal = (x == 0) | ~(np.abs(x) < np.finfo(np.float32).tiny)
    want = np.asarray(jquant.compress(jt, jnp.asarray(x)))
    np.testing.assert_array_equal(got[normal], want[normal])


def test_search_tree_ranks_and_nodes_are_inverse():
    """``tree_rank`` (the 8-bit tree's staging) and ``tree_node`` (the top
    tree's) are each other's inverse, and a descent lands on every rank."""
    for levels in (_header_int("kTreeLevels"), _header_int("kTopLevels"),
                   1, 5):
        nodes = np.arange(1, 1 << levels)
        ranks = tree_rank(nodes, levels)
        assert sorted(ranks.tolist()) == list(range((1 << levels) - 1))
        np.testing.assert_array_equal(tree_node(ranks, levels), nodes)
        keys = np.arange((1 << levels) - 1, dtype=np.float32)
        tree = np.full(1 << levels, np.inf, np.float32)
        tree[nodes] = keys[ranks]
        np.testing.assert_array_equal(
            tree_descend(tree, keys + 0.5, levels), np.arange(keys.size) + 1)


@pytest.mark.parametrize("mode", ["uniform", "normal"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_tree_search_model_is_searchsorted(bits, mode):
    """The 8-bit tree as the card stages and walks it gives
    ``np.searchsorted(side='left')`` and the JAX package's ``compress``
    (NaN and +inf the top code, -inf 0), on ties and ulp neighbours."""
    jt = jquant.build_table(-1.5, 1.5, bits, mode)
    bnd = np.asarray(jt.boundaries)
    x = search_values(bnd, bits)
    got = tree_code_model(bnd, x)
    want = np.searchsorted(bnd, x, side="left")
    np.testing.assert_array_equal(got, want)
    assert_codes_match_jax(jt, x, got)


@pytest.mark.parametrize("mis", [0, 1, 2, 3])
@pytest.mark.parametrize("bits", [1, 4, 8, 9, 12, 16])
def test_split_search_model_is_searchsorted(bits, mis):
    """The two-stage search as the card stages and walks it, for
    boundaries at each alignment, gives ``np.searchsorted(side='left')``
    and the JAX package's ``compress`` at every width: on each boundary,
    one ulp either side (so on both edges of every segment), NaN, +-inf;
    and ``np.searchsorted`` on a table whose boundaries repeat."""
    jt = jquant.build_table(-1.0, 1.0, bits, "normal")
    bnd = np.asarray(jt.boundaries)
    x = search_values(bnd, bits + 16 * mis)
    got = split_code_model(bnd, x, mis)
    np.testing.assert_array_equal(got, np.searchsorted(bnd, x, side="left"))
    assert_codes_match_jax(jt, x, got)
    dup = np.sort(np.round(bnd * 8) / 8).astype(np.float32)
    np.testing.assert_array_equal(
        split_code_model(dup, x, mis), np.searchsorted(dup, x, side="left"))


@pytest.mark.parametrize("mis", [0, 1, 2, 3])
def test_flat_pack_layout_covers_each_value_once(mis):
    """quantize_pack.cu's split of a payload ``mis`` floats past 16 bytes:
    a scalar head up to the first 16-byte boundary, float4 vectors, a
    scalar tail, each value once, every vector on 16 bytes."""
    for n in (0, 1, 2, 3, 4, 5, 7, 8, 33, 4096 + 3):
        head = min((4 - mis) % 4, n)
        nvec = (n - head) // 4
        tail = head + 4 * nvec
        idx = list(range(head)) + [head + 4 * v + k for v in range(nvec)
                                   for k in range(4)] + list(range(tail, n))
        assert idx == list(range(n))
        assert nvec == 0 or (mis + head) % 4 == 0
        assert n - tail <= 3


# -- quantize_pack_ef ----------------------------------------------------------


def _qp_ef_case(seed, bits, mask_kind, nan=False, p=96, d=6):
    """The JAX bench's layout at a small size: a payload with +-inf (and
    NaN) past the table's edges, a carry from an earlier step, and a 0/1
    mask of one value per row ([P, 1]) or per value ([P, d])."""
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(p, d)) * 0.6).astype(np.float32)
    rows.reshape(-1)[:2] = [np.inf, -np.inf]
    if nan:
        rows.reshape(-1)[2] = np.nan
    carried = (rng.normal(size=(p, d)) * 0.05).astype(np.float32)
    shape = (p, 1) if mask_kind == "row" else (p, d)
    mask = (rng.random(shape) > 0.25).astype(np.float32)
    return jquant.build_table(-1.0, 1.0, bits, "normal" if bits <= 8
                              else "uniform"), rows, carried, mask


@pytest.mark.parametrize("mask_kind", ["row", "value"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_pack_ef_plain_matches_jax_reference(bits, mask_kind):
    """Codes and delta bit for bit against ``_qp_ef_reference``, NaN and
    +-inf in the rows included (NaN takes the top code there)."""
    jt, rows, carried, mask = _qp_ef_case(bits, bits, mask_kind, nan=True)
    jc, jd = jsk._qp_ef_reference(jt, jnp.asarray(rows),
                                  jnp.asarray(carried), jnp.asarray(mask))
    before = tsk.launches("quantize_pack_ef")
    tc, td = tsk.quantize_pack_ef(_same_table(jt), torch.from_numpy(rows),
                                  torch.from_numpy(carried),
                                  torch.from_numpy(mask))
    assert tsk.launches("quantize_pack_ef") == before
    assert tc.dtype == tquant.code_dtype(bits) and td.dtype == torch.float32
    assert tc.shape == rows.shape and td.shape == rows.shape
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tc.reshape(-1)[2]) == (1 << bits) - 1


@pytest.mark.parametrize("mask_kind", ["row", "value"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_pack_ef_plain_matches_the_interpreted_tpu_kernel(
        bits, mask_kind):
    """``_qp_ef_pallas`` under the interpreter, bit for bit, on finite
    values and +-inf (its compare-count gives NaN code 0, the reference
    the top code: the same documented difference as quantize_pack's)."""
    jt, rows, carried, mask = _qp_ef_case(10 + bits, bits, mask_kind)
    jc, jd = jsk._qp_ef_pallas(jt, jnp.asarray(rows), jnp.asarray(carried),
                               jnp.asarray(mask), interpret=True)
    tc, td = tsk.quantize_pack_ef(_same_table(jt), torch.from_numpy(rows),
                                  torch.from_numpy(carried),
                                  torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_pack_ef_fractional_mask_matches_jax_reference():
    """A mask between 0 and 1 makes carried*mask a rounded product: the
    plain version keeps the reference's order of operations."""
    jt, rows, carried, _ = _qp_ef_case(7, 8, "row")
    mask = np.random.default_rng(8).random((rows.shape[0], 1)).astype(
        np.float32)
    jc, jd = jsk._qp_ef_reference(jt, jnp.asarray(rows),
                                  jnp.asarray(carried), jnp.asarray(mask))
    tc, td = tsk.quantize_pack_ef(_same_table(jt), torch.from_numpy(rows),
                                  torch.from_numpy(carried),
                                  torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_pack_ef_wrapper_refuses_bad_inputs():
    tt = _same_table(jquant.build_table(-1.0, 1.0, 8, "normal"))
    x = torch.zeros((4, 3))
    ef = tsk.KERNELS["quantize_pack_ef"].cuda
    with pytest.raises(TypeError, match="float32 rows and carried"):
        ef(tt, x.double(), x, torch.ones((4, 1)))
    with pytest.raises(ValueError, match="carried"):
        ef(tt, x, torch.zeros((4, 2)), torch.ones((4, 1)))
    with pytest.raises(ValueError, match="does not broadcast"):
        ef(tt, x, x, torch.ones((3, 1)))
    with pytest.raises(ValueError, match="CUDA device"):
        ef(tt, x, x, torch.ones((4, 1)))
    with pytest.raises(ValueError, match="rows on"):
        tsk.quantize_pack_ef(tt, x, x, torch.ones((4, 1), device="meta"))


# -- quantize_pack_ef_update -----------------------------------------------------


def _ef_case(seed, d, bits, vocab=64, s=40):
    """Uids of the dedup convention (sorted unique, padded with id 0; a
    real id 0 at slot 0), the mask that keeps pads out, rows 3x the range
    so the clip feeds the carry, and a carry from an earlier step."""
    rng = np.random.default_rng(seed)
    u = np.unique(rng.integers(1, vocab, size=s - 12))
    uids = np.zeros(s, np.int32)
    uids[1:1 + u.size] = u
    shape = (vocab,) if d == 1 else (vocab, d)
    rows = (rng.normal(size=(s,) + shape[1:]) * 3.0).astype(np.float32)
    mask = ~((uids == 0) & (np.arange(s) > 0))
    rows[~mask] = 0.0
    mask = mask.astype(np.float32).reshape((-1,) + (1,) * (len(shape) - 1))
    residual = (rng.normal(size=shape) * 0.1).astype(np.float32)
    return jquant.build_table(-1.0, 1.0, bits, "normal" if bits <= 8
                              else "uniform"), rows, uids, residual, mask


@pytest.mark.parametrize("d, bits", list(itertools.product((1, 3, 5, 33),
                                                           (8, 16))))
def test_quantize_pack_ef_update_plain_matches_jax_reference(d, bits):
    """Codes, dec and the residual (updated in place) bit for bit against
    ``KERNELS["quantize_pack_ef_update"].reference``, twice in a row, at
    widths where the card's kernel takes one float a lane (3, 5, and 33,
    a row across the whole warp) and whole slots (1)."""
    jt, rows, uids, residual, mask = _ef_case(d * 10 + bits, d, bits)
    tt = _same_table(jt)
    jres = jnp.asarray(residual)
    tres = torch.from_numpy(residual.copy())
    for step in range(2):
        r = rows * (1.0 + step)
        jc, jres, jd = jsk.KERNELS["quantize_pack_ef_update"].reference(
            jt, jnp.asarray(r), jnp.asarray(uids), jres, jnp.asarray(mask))
        tc, out, td = tsk.quantize_pack_ef_update(
            tt, torch.from_numpy(r), torch.from_numpy(uids), tres,
            torch.from_numpy(mask))
        assert out is tres  # in place
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    untouched = np.setdiff1d(np.arange(residual.shape[0]), uids)
    np.testing.assert_array_equal(tres.numpy()[untouched],
                                  residual[untouched])


def test_quantize_pack_ef_update_uids_outside_the_table_match_jax():
    """A uid in [-V, 0) wraps (its carry is read and written at uid + V);
    any other out-of-table uid reads NaN (``jnp.take``'s fill) and writes
    nothing."""
    jt, rows, _, residual, _ = _ef_case(3, 4, 8, vocab=16, s=20)
    rows = rows[:6]
    uids = np.array([0, -1, 5, 17, -20, 9], np.int32)
    mask = np.ones((6, 1), np.float32)
    jc, jres, jd = jsk.KERNELS["quantize_pack_ef_update"].reference(
        jt, jnp.asarray(rows), jnp.asarray(uids), jnp.asarray(residual),
        jnp.asarray(mask))
    tres = torch.from_numpy(residual.copy())
    tc, _, td = tsk.quantize_pack_ef_update(
        _same_table(jt), torch.from_numpy(rows), torch.from_numpy(uids),
        tres, torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))


# -- merge_rows and merge_apply's merge mode ---------------------------------------


@pytest.mark.parametrize("m, nseg, d", [(5000, 40, 32), (2000, 3, 1),
                                        (777, 900, 5), (64, 8, (2, 3))])
def test_merge_rows_plain_is_segment_sum_bit_exact(m, nseg, d):
    """Heavy duplicates, out-of-range segments of both signs, rows of
    mixed magnitude (so the order of the adds shows in the bits)."""
    rng = np.random.default_rng(m)
    shape = (m,) + ((d,) if isinstance(d, int) else d)
    rows = (rng.normal(size=shape) * rng.lognormal(
        size=(m,) + (1,) * (len(shape) - 1)) * 10).astype(np.float32)
    inv = rng.integers(-3, nseg + 3, size=m).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(rows), jnp.asarray(inv),
                                          num_segments=nseg))
    before = tsk.launches("merge_rows")
    got = tsk.merge_rows(torch.from_numpy(rows), torch.from_numpy(inv), nseg)
    assert tsk.launches("merge_rows") == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the card's plain route (rounds of unique segments) adds in the same
    # order as the CPU's index_add_
    keep = (inv >= 0) & (inv < nseg)
    rounds = tsk.add_in_rounds(torch.zeros(want.shape),
                               torch.from_numpy(inv[keep]).long(),
                               torch.from_numpy(rows[keep]))
    np.testing.assert_array_equal(rounds.numpy(), want)


def test_merge_rows_matches_the_interpreted_tpu_kernel(monkeypatch):
    monkeypatch.setenv(jsk.ENV_FLAG, "interpret")
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(300, 4)).astype(np.float32)
    inv = rng.integers(-1, 50, size=300).astype(np.int32)
    want = jsk.merge_rows(jnp.asarray(rows), jnp.asarray(inv), 48)
    got = tsk.merge_rows(torch.from_numpy(rows), torch.from_numpy(inv), 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsk.merge_rows(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int32),
                          3).shape == (3, 4)


def merge_order_model(rows, inv, nseg):
    """The order in which the card's merge (csrc/segment_runs.cuh) adds,
    in numpy: key ``inv`` for a kept slot and ``nseg`` for a dropped or
    all-zero one, a stable sort of the keys, then each run of one key
    below ``nseg`` summed from +0.0 in float32, in sorted (slot) order."""
    m = rows.shape[0]
    flat = rows.reshape(m, int(np.prod(rows.shape[1:])))
    zero = ~(flat != 0).any(axis=1)
    keys = np.where((inv >= 0) & (inv < nseg) & ~zero, inv, nseg)
    order = np.argsort(keys, kind="stable")
    ranked = keys[order]
    out = np.zeros((nseg, flat.shape[1]), np.float32)
    starts = np.flatnonzero(np.r_[True, ranked[1:] != ranked[:-1]]) \
        if m else np.zeros(0, np.int64)
    for a, b in zip(starts, np.r_[starts[1:], m]):
        if ranked[a] >= nseg:
            continue  # the dropped slots, last
        acc = np.zeros(flat.shape[1], np.float32)
        with np.errstate(invalid="ignore"):  # inf + -inf is NaN
            for slot in order[a:b]:
                acc = acc + flat[slot]
        out[ranked[a]] = acc
    return out.reshape((nseg,) + rows.shape[1:])


def assert_same_bits(got, want):
    """NaN at the same places, every other value bit for bit (signed zeros
    included).  A NaN's sign and payload are the adder's: XLA's CPU code
    makes inf + -inf a positive NaN, numpy and PyTorch a negative one."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


#: row values that show the order of the adds and the drop rules: signed
#: zeros, NaN, infinities, magnitudes far apart
_MERGE_VALUES = [0.0, -0.0, 1.0, -1.0, 3.5, 1e-8, -1e8, 1e30, -1e30,
                 float("nan"), float("inf"), -float("inf"), 0.1, -7.25]


@st.composite
def merge_cases(draw):
    nseg = draw(st.one_of(st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
                          st.integers(1, 40)))
    m = draw(st.integers(0, 48))
    d = draw(st.sampled_from([1, 3]))
    vals = st.sampled_from(_MERGE_VALUES)
    rows = np.array([[draw(vals) for _ in range(d)] for _ in range(m)],
                    np.float32).reshape(m, d)
    # whole rows of +-0, which the kernel leaves out
    for i in range(m):
        if draw(st.integers(0, 4)) == 0:
            rows[i] = [draw(st.sampled_from([0.0, -0.0])) for _ in range(d)]
    # segments drawn from a few (so some stay empty) and past both ends
    pool = draw(st.lists(st.integers(-3, nseg + 2), min_size=1, max_size=6))
    inv = np.array([draw(st.sampled_from(pool)) for _ in range(m)], np.int32)
    return rows, inv, nseg


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(merge_cases())
def test_merge_order_model_is_segment_sum_bit_exact(case):
    """The kernel's order (sorted keys, runs walked from +0) gives the
    plain version's bits and ``jax.ops.segment_sum``'s, and the
    interpreted TPU kernel's, with +-0, NaN and infinite rows, segments
    out of range on both sides, empty segments and nseg at powers of two.
    The interpreted kernel adds a dropped slot's row times 0 to segment 0,
    so it differs where a dropped row holds NaN or an infinity (NaN there;
    ROADMAP.md); that comparison skips such cases."""
    rows, inv, nseg = case
    got = merge_order_model(rows, inv, nseg)
    assert_same_bits(got, tsk.merge_rows_plain(
        torch.from_numpy(rows), torch.from_numpy(inv), nseg).numpy())
    assert not np.signbit(got[got == 0]).any()  # a sum from +0 is never -0
    if rows.shape[0] == 0:
        return
    assert_same_bits(got, jax.ops.segment_sum(
        jnp.asarray(rows), jnp.asarray(inv), num_segments=nseg))
    dropped = (inv < 0) | (inv >= nseg)
    if np.isfinite(rows[dropped]).all():
        with mock.patch.dict(os.environ, {jsk.ENV_FLAG: "interpret"}):
            assert_same_bits(got, jsk.merge_rows(
                jnp.asarray(rows), jnp.asarray(inv), nseg))


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("d", [1, 6])
def test_merge_apply_merge_mode_matches_jax(monkeypatch, mode, d):
    """The allgather exchange's layout: 2 ranks' 48 gathered rows merged
    onto the union of their uids (a real dedup, id 0 included) with the
    mean's denom; at the merge_apply tests' bounds (FMA-contraction ulp on
    table and accum, float tolerance on the sum of squares)."""
    monkeypatch.setenv(jsk.ENV_FLAG, mode)
    rng = np.random.default_rng(d)
    ids = rng.integers(0, 40, size=48).astype(np.int32)
    uids, inv, _ = tsk.dedup_ids(torch.from_numpy(ids))
    shape = (64,) if d == 1 else (64, d)
    rows = rng.normal(size=(48,) + shape[1:]).astype(np.float32)
    table = rng.normal(size=shape).astype(np.float32)
    accum = np.abs(rng.normal(size=shape)).astype(np.float32)
    w0, a0, s0 = jsk.merge_apply(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(uids.numpy()),
        jnp.asarray(rows), jnp.asarray(inv.numpy()), lr=0.05, eps=1e-7,
        denom=2.0)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    _, _, s1 = tsk.merge_apply(t, a, uids, torch.from_numpy(rows), inv,
                               lr=0.05, eps=1e-7, denom=2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(w0), rtol=0, atol=2e-7)
    np.testing.assert_allclose(a.numpy(), np.asarray(a0), rtol=2e-6, atol=0)
    np.testing.assert_allclose(float(s1), float(s0), rtol=1e-5)


# -- the CUDA wrappers refuse what they do not take -------------------------------


def test_new_kernel_wrappers_refuse_bad_inputs():
    jt = jquant.build_table(-1.0, 1.0, 8, "normal")
    tt = _same_table(jt)
    x = torch.zeros(8)
    qp = tsk.KERNELS["quantize_pack"].cuda
    with pytest.raises(TypeError, match="float32 payload"):
        qp(tt, x.double())
    with pytest.raises(ValueError, match="CUDA device"):
        qp(tt, x)
    mr = tsk.KERNELS["merge_rows"].cuda
    with pytest.raises(TypeError, match="float32 rows"):
        mr(torch.zeros((4, 2), dtype=torch.float64),
           torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(TypeError, match="int32 inv"):
        mr(torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="segment ids for"):
        mr(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA device"):
        mr(torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int32), 3)
    ef = tsk.KERNELS["quantize_pack_ef_update"].cuda
    res = torch.zeros((10, 2))
    u = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 uids"):
        ef(tt, torch.zeros((4, 2)), u.long(), res, torch.ones(4))
    with pytest.raises(ValueError, match="rows"):
        ef(tt, torch.zeros((4, 3)), u, res, torch.ones(4))
    with pytest.raises(ValueError, match="one mask value per slot"):
        ef(tt, torch.zeros((4, 2)), u, res, torch.ones((4, 2)))
    with pytest.raises(ValueError, match="CUDA device"):
        ef(tt, torch.zeros((4, 2)), u, res, torch.ones((4, 1)))
    bad = tquant.QuantTable(tt.boundaries[:-1], tt.values, 8)
    from lightctr_tpu_torch.ops.sparse_kernels import check_table
    with pytest.raises(ValueError, match="one boundary fewer"):
        check_table("quantize_pack", bad, torch.device("cpu"))


@pytest.mark.parametrize("name, phase, head", [
    ("merge_rows", "merge", "def _merge_pallas("),
    ("quantize_pack", "pack", "def _qp_pallas("),
    ("quantize_pack_ef", "pack", "def _qp_ef_pallas("),
    ("quantize_pack_ef_update", "pack", "def _qp_ef_update_pallas("),
])
def test_new_kernels_point_at_the_tpu_kernels(name, phase, head):
    kd = tsk.KERNELS[name]
    assert kd.phase == phase
    assert os.path.isfile(os.path.join(tsk.CSRC_DIR, kd.source))
    path, line = kd.replaces.rsplit(":", 1)
    with open(os.path.join(REPO_ROOT, path)) as f:
        src = f.read().splitlines()
    assert src[int(line) - 1].startswith(head)
    assert tsk.dispatch(name, torch.device("cpu")) is kd.plain
