"""The port's kernel layer (lightctr_tpu_torch/ops/sparse_kernels.py) against
the JAX package's: ``gather_rows``'s plain version bit-exact against the JAX
``gather_rows`` under the Pallas interpreter and under its XLA reference,
a model of the gather kernel's plan and walk, the
``next_pow2`` ladder, the registry, and dispatch by tensor device."""

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightctr_tpu.ops import sparse_kernels as jsk
from lightctr_tpu_torch.ops import sparse_kernels as tsk

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gather_inputs(d, n, rows=37, seed=0):
    """A [rows, d] fp32 block and n int32 indices, a third outside
    [0, rows) and the first ones at the clip's edges."""
    rng = np.random.default_rng(seed + 1000 * d + n)
    block = rng.standard_normal((rows, d)).astype(np.float32)
    idx = rng.integers(-rows // 2, rows + rows // 2, n).astype(np.int32)
    edges = np.array([-1, rows, np.iinfo(np.int32).min,
                      np.iinfo(np.int32).max, rows - 1, 0], np.int32)
    m = min(n, len(edges))
    idx[:m] = edges[:m]
    return block, idx


def _jax_gather(block, idx):
    return np.asarray(jsk.gather_rows(jnp.asarray(block), jnp.asarray(idx)))


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("n", [1, 8, 31, 32, 33, 1000, 4097])
@pytest.mark.parametrize("d", [1, 4, 9, 32, 33, 128])
def test_gather_rows_plain_matches_jax_bit_exact(monkeypatch, mode, d, n):
    """At the kernel's edges (n around a warp's 32 rows and past 4096; d
    of one float, one float4, one warp of float4 and one float past it),
    int32 ids at the clip's edges, the same ids as int64 moved by
    multiples of 2^32 (they wrap back in the int32 cast), and at d 33 the
    block as [R, 3, 11]."""
    monkeypatch.setenv("LIGHTCTR_KERNELS", mode)
    assert jsk.resolve_impl("gather_rows") == mode
    block, idx = _gather_inputs(d, n)
    want = _jax_gather(block, idx)
    got = tsk.gather_rows_plain(torch.from_numpy(block),
                                torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape == (n, d)
    np.testing.assert_array_equal(got, want)
    wide = idx.astype(np.int64) + (np.arange(n) % 3 - 1) * (1 << 32)
    np.testing.assert_array_equal(_jax_gather(block, wide), want)
    np.testing.assert_array_equal(
        tsk.gather_rows_plain(torch.from_numpy(block),
                              torch.from_numpy(wide)).numpy(), want)
    if d == 33:
        block3 = block.reshape(-1, 3, 11)
        want3 = _jax_gather(block3, idx)
        got3 = tsk.gather_rows_plain(torch.from_numpy(block3),
                                     torch.from_numpy(idx)).numpy()
        assert got3.shape == want3.shape == (n, 3, 11)
        np.testing.assert_array_equal(got3, want3)
        np.testing.assert_array_equal(want3.reshape(n, d), want)


class InFlight(NamedTuple):
    """Vectors a lane copies a tile, at most, by lane kind
    (csrc/gather_rows.cu's ``kOwnRows``, ``kVecRows``, ``kScalarRows``)."""
    own: int      # a row of one vector: rows a lane takes
    vec: int      # float4 lanes
    scalar: int   # one-float lanes


class Plan(NamedTuple):
    vec: bool
    wide: bool
    cv: int
    tile_rows: int
    magic: int


def _plan(rows, d, n, block_ptr, out_ptr, in_flight):
    """csrc/gather_rows.cu's ``launch()`` plan, in Python: float4 lanes
    where d % 4 == 0 and both pointers sit on 16 bytes; 64-bit index math
    where n * d or R * d reaches 2^31; a row of one vector a lane's own;
    a wider row's tile of 1 to 32 rows with the ``__umulhi`` multiplier
    floor((2^32 - 1) / cv) + 1 (0 for a tile of one row)."""
    vec = d % 4 == 0 and block_ptr % 16 == 0 and out_ptr % 16 == 0
    cv = d // 4 if vec else d
    wide = n * d >= 1 << 31 or rows * d >= 1 << 31
    if cv == 1:
        return Plan(vec, wide, cv, 32 * in_flight.own, 0)
    per_lane = in_flight.vec if vec else in_flight.scalar
    tile = max(1, min(32, 32 * per_lane // cv))
    magic = 0 if tile == 1 else ((1 << 32) - 1) // cv + 1
    return Plan(vec, wide, cv, tile, magic)


#: the kernel's in-flight counts (1, 1, 4) and others of the sweep's range
IN_FLIGHT = [InFlight(1, 1, 1), InFlight(1, 1, 4), InFlight(1, 4, 4),
             InFlight(2, 2, 2), InFlight(4, 1, 8)]


@pytest.mark.parametrize("in_flight", IN_FLIGHT)
def test_gather_rows_plan_divides_exactly(in_flight):
    """Every d up to 4096 on every lane kind: a row of one vector is a
    lane's own (32 * in_flight.own rows a tile, no multiplier); a wider
    row's tile holds 1 to 32 rows, a lane's share of its vectors at most
    its kind's in_flight where the tile holds more than one row, and the
    multiplier gives t // cv for every t of the tile (the kernel's 32-bit
    ``__umulhi``, modelled in uint64)."""
    for d in range(1, 4097):
        for ptr in (0, 4):
            plan = _plan(1000, d, 5000, 256 + ptr, 512, in_flight)
            assert plan.vec == (d % 4 == 0 and ptr == 0)
            assert plan.cv == (d // 4 if plan.vec else d)
            assert not plan.wide
            if plan.cv == 1:
                assert (plan.tile_rows, plan.magic) == (32 * in_flight.own,
                                                        0)
                continue
            assert 1 <= plan.tile_rows <= 32
            assert (plan.magic == 0) == (plan.tile_rows == 1)
            if plan.tile_rows > 1:
                per_lane = in_flight.vec if plan.vec else in_flight.scalar
                assert -(-plan.tile_rows * plan.cv // 32) <= per_lane
                assert plan.magic < 1 << 32
                t = np.arange(plan.tile_rows * plan.cv, dtype=np.uint64)
                q = (t * np.uint64(plan.magic)) >> np.uint64(32)
                np.testing.assert_array_equal(q, t // np.uint64(plan.cv))


def _walk_model(block, idx, plan, in_flight):
    """The gather kernel's index arithmetic in numpy, warp by warp over
    tiles (the grid's order does not matter to a copy): each output float
    it writes and from which block float; asserts each output float is
    written once."""
    rows_n = block.shape[0]
    v = 4 if plan.vec else 1
    n, cv, tile = idx.size, plan.cv, plan.tile_rows
    src = np.full(n * cv * v, -1, np.int64)
    r_all = np.clip(idx.astype(np.int64).astype(np.int32).astype(np.int64),
                    0, rows_n - 1)
    lane = np.arange(32)
    for base in range(0, n, tile):
        if cv == 1:
            p = lane[None, :] + 32 * np.arange(in_flight.own)[:, None]
            rows_t, dst = r_all[np.minimum(base + p, n - 1)], base + p
            ok = base + p < n
        else:
            pre = np.zeros(32, np.int64)
            m = min(tile, n - base)
            pre[:m] = r_all[base:base + m]
            per_lane = in_flight.vec if plan.vec else in_flight.scalar
            span = m * cv
            k = np.arange(0, span, 32 * per_lane)[:, None, None]
            t = k + lane[None, None, :] \
                + 32 * np.arange(per_lane)[None, :, None]
            q = (t.astype(np.uint64) * np.uint64(plan.magic)) \
                >> np.uint64(32)
            q = q.astype(np.int64)
            rows_t = pre[q & 31] * cv + t - q * cv
            dst = base * cv + t
            ok = t < span
        for c in range(v):
            s_idx = rows_t[ok] * v + c
            d_idx = dst[ok] * v + c
            assert (src[d_idx] == -1).all()
            src[d_idx] = s_idx
    assert (src >= 0).all()
    return block.reshape(-1)[src].reshape((n,) + block.shape[1:])


@pytest.mark.parametrize("n", [1, 31, 33, 1000])
@pytest.mark.parametrize("d, vec", [(d, vec) for d in (1, 3, 4, 8, 32, 33,
                                                       128, 300)
                                    for vec in (False, True)
                                    if d % 4 == 0 or not vec])
def test_gather_rows_walk_model_matches_plain(d, vec, n):
    """The kernel's walk, modelled in numpy with the plan its launch
    makes, copies ``gather_rows_plain``'s result bit for bit, every
    output float once: the tile's flat range, the multiplier's row, the
    shuffle's source lane, the masks of a short last tile; float4 lanes
    where d % 4 == 0, one float otherwise."""
    block, idx = _gather_inputs(d, n)
    for in_flight in IN_FLIGHT:
        plan = _plan(block.shape[0], d, n, 0 if vec else 4, 0, in_flight)
        assert plan.vec == vec
        got = _walk_model(block, idx, plan, in_flight)
        want = tsk.gather_rows_plain(torch.from_numpy(block),
                                     torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(got, want)


def test_gather_rows_dispatch_on_cpu_takes_plain_and_counts_nothing():
    block, idx = _gather_inputs(33, 100)
    tb, ti = torch.from_numpy(block), torch.from_numpy(idx)
    before = tsk.launches("gather_rows")
    out = tsk.gather_rows(tb, ti)
    assert torch.equal(out, tsk.gather_rows_plain(tb, ti))
    # int64 indices take the same int32 cast as the JAX kernel's
    wide = ti.to(torch.int64) + (1 << 32)
    assert torch.equal(tsk.gather_rows(tb, wide), out)
    # the count is of kernel launches: the plain version adds nothing
    assert tsk.launches("gather_rows") == before
    empty = tsk.gather_rows(tb, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 33)


def test_gather_rows_rejects_mixed_and_unknown_devices():
    block = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="no implementation"):
        tsk.gather_rows(block.to("meta"), torch.zeros(2, dtype=torch.int32,
                                                      device="meta"))
    with pytest.raises(ValueError, match="on one CUDA device"):
        tsk.KERNELS["gather_rows"].cuda(block, torch.zeros(2,
                                                           dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        tsk.KERNELS["gather_rows"].cuda(block.double(),
                                        torch.zeros(2, dtype=torch.int32))


def test_next_pow2_ladder_matches_jax():
    for n in range(0, 5000):
        assert tsk.next_pow2(n) == jsk.next_pow2(n), n
    for floor in (1, 2, 16):
        for n in (0, 1, 3, 17, 1 << 20, (1 << 20) + 1):
            assert tsk.next_pow2(n, floor) == jsk.next_pow2(n, floor)


def test_registry_names_sources_and_the_tpu_kernels_they_replace():
    kd = tsk.KERNELS["gather_rows"]
    assert kd.phase == "gather" and kd.phase in tsk.KERNEL_PHASES
    assert os.path.isfile(os.path.join(tsk.CSRC_DIR, kd.source))
    path, line = kd.replaces.rsplit(":", 1)
    with open(os.path.join(REPO_ROOT, path)) as f:
        src = f.read().splitlines()
    assert src[int(line) - 1].startswith("def _gather_pallas(")
    assert "gather_rows" in tsk.launches()
    with pytest.raises(ValueError, match="phase"):
        tsk.register_kernel("bogus", phase="nope", plain=len, cuda=len,
                            source="x.cu", bind=len, replaces="x:1")


def test_launch_counts_reset():
    tsk._count_launch("gather_rows")
    assert tsk.launches("gather_rows") >= 1
    tsk.reset_launches()
    assert tsk.launches() == {k: 0 for k in tsk.KERNELS}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolchain is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setattr(tsk, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tsk.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tsk.compile_source("gather_rows.cu")
