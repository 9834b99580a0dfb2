"""The port's kernel layer (lightctr_tpu_torch/ops/sparse_kernels.py) against
the JAX package's: ``gather_rows``'s plain version bit-exact against the JAX
``gather_rows`` under the Pallas interpreter and under its XLA reference,
the ``next_pow2`` ladder, the registry, and dispatch by tensor device."""

import os

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


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("n", [1, 8, 1000])
@pytest.mark.parametrize("d", [1, 9, 33])
def test_gather_rows_plain_matches_jax_bit_exact(monkeypatch, mode, d, n):
    monkeypatch.setenv("LIGHTCTR_KERNELS", mode)
    assert jsk.resolve_impl("gather_rows") == mode
    block, idx = _gather_inputs(d, n)
    want = np.asarray(jsk.gather_rows(jnp.asarray(block), jnp.asarray(idx)))
    got = tsk.gather_rows_plain(torch.from_numpy(block),
                                torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape == (n, d)
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
