"""The port's CUDA kernels and trainers on the card, each against its plain
version on the same inputs.  Every test needs an NVIDIA GPU: it carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false.
This file imports neither ``jax`` nor the JAX package, so it runs on a
machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.models import fm
from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
from lightctr_tpu_torch.models.sparse_trainer import SparseTableCTRTrainer
from lightctr_tpu_torch.ops import sparse_kernels as sk
from lightctr_tpu_torch.optim import fused_adagrad as fa

pytestmark = pytest.mark.cuda
MAX_ULP = 2  # the Adagrad apply's bound (ROADMAP B.5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def ulp(a, b) -> int:
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(1 << 31) - i, i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def id_streams():
    rng = np.random.default_rng(0)
    i32 = np.iinfo(np.int32)
    limits = np.array([i32.min, i32.max, 0, -1, i32.min, i32.max])
    return {
        "criteo_u4": (rng.random(39 * 64) ** 4 * (1 << 20)).astype(np.int32),
        "negative_and_limits": np.concatenate(
            [rng.integers(-5000, 5000, 3000), limits]).astype(np.int32),
        "all_zero": np.zeros(777, np.int32),
        "all_equal": np.full(4097, -3, np.int32),
        "single": np.array([42], np.int32),
    }


@pytest.mark.parametrize("name", sorted(id_streams()))
def test_dedup_kernel_matches_plain(dev, name):
    ids = torch.from_numpy(id_streams()[name]).to(dev)
    count = int(sk.dedup_ids_plain(ids, ids.numel())[2])
    for size in sorted({ids.numel(), max(1, count // 3)}):
        before = sk.launches("dedup_ids")
        got = sk.dedup_ids(ids, size)
        assert sk.launches("dedup_ids") == before + 1
        for a, b in zip(got, sk.dedup_ids_plain(ids, size)):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_dedup_kernel_refuses_int64(dev):
    with pytest.raises(TypeError, match="int32"):
        sk.dedup_ids(torch.zeros(8, dtype=torch.int64, device=dev))


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("denom", [1.0, 4.0])
def test_merge_apply_kernel_matches_plain(dev, d, denom):
    rng = np.random.default_rng(d)
    ids = torch.from_numpy(
        (rng.random(3000) ** 4 * 4096).astype(np.int32)).to(dev)
    uids, _, _ = sk.dedup_ids(ids)
    shape = (4096,) if d == 1 else (4096, d)
    gen = torch.Generator(device=dev).manual_seed(d)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    rows = torch.randn((uids.numel(),) + shape[1:], generator=gen, device=dev)
    t1, a1, s1 = sk.merge_apply(table.clone(), accum.clone(), uids, rows,
                                lr=0.05, denom=denom)
    t2, a2, s2 = sk.merge_apply_plain(table.clone(), accum.clone(), uids,
                                      rows, None, 0.05, 1e-7, denom)
    assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)


def test_merge_apply_kernel_drops_uids_outside_the_table(dev):
    """Both versions drop a uid outside the table, out of the update and
    the sum of squares."""
    uids = torch.tensor([0, 3, -2, 5, 8, 0], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn((8, 3), generator=gen, device=dev)
    accum = torch.rand((8, 3), generator=gen, device=dev)
    rows = torch.randn((6, 3), generator=gen, device=dev)
    t1, a1, s1 = sk.merge_apply(table.clone(), accum.clone(), uids, rows,
                                lr=0.1)
    t2, a2, s2 = sk.merge_apply_plain(table.clone(), accum.clone(), uids,
                                      rows, None, 0.1, 1e-7, 1.0)
    assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
    assert torch.equal(t1[[1, 2, 4, 6, 7]], table[[1, 2, 4, 6, 7]])
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)


def test_merge_apply_on_card_refuses_merge_mode(dev):
    t = torch.zeros((4, 2), device=dev)
    i = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        sk.merge_apply(t, t.clone(), i, torch.zeros((3, 2), device=dev), i,
                       lr=0.1)


@pytest.mark.parametrize("n, offset", [(1, 0), (1001, 0), (4096, 0),
                                       (4096, 1)])
def test_fused_adagrad_kernel_matches_plain(dev, n, offset):
    """N % 4 != 0 and a start one float into the buffers take the scalar
    path; the rest the float4 path."""
    gen = torch.Generator(device=dev).manual_seed(n + offset)
    w, a, g = (torch.randn(n + offset, generator=gen, device=dev)[offset:]
               for _ in range(3))
    a = a.abs()
    w2, a2 = fa.fused_adagrad_plain(w.clone(), a.clone(), g, 0.05, 1e-7)
    fa.fused_adagrad_update(w, a, g, 0.05)
    assert ulp(w, w2) <= MAX_ULP and ulp(a, a2) <= MAX_ULP


def fm_batch(seed, n=96, f=512, nnz=5):
    rng = np.random.default_rng(seed)
    return {
        "fids": rng.integers(0, f, size=(n, nnz)).astype(np.int32),
        "vals": rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32),
        "mask": np.ones((n, nnz), np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
    }


@pytest.mark.parametrize("fused", [False, True])
def test_trainers_on_card_match_cpu(dev, fused):
    """Six full-batch epochs on the card and on the CPU from one init: the
    sparse trainer launches one dedup and two applies an epoch, the fused
    dense trainer two Adagrad kernels; losses and params agree."""
    p = fm.init(torch.Generator().manual_seed(0), 512, 8)
    cfg = TrainConfig(learning_rate=0.1, lambda_l2=0.001)

    def make(device):
        if fused:
            return CTRTrainer(p, fm.logits, cfg, fused_fn=fm.logits_with_l2,
                              fused_adagrad=True, device=device)
        return SparseTableCTRTrainer(
            p, fm.logits, cfg, sparse_tables={"w": ["fids"], "v": ["fids"]},
            fused_fn=fm.logits_with_l2, device=device)

    card, cpu = make(dev), make("cpu")
    card.health = cpu.health = None
    b = fm_batch(1)
    sk.reset_launches()
    lc = card.fit_fullbatch_scan(b, 6)
    n = sk.launches()
    assert (n["fused_adagrad"] == 12 if fused
            else (n["dedup_ids"], n["merge_apply"]) == (6, 12))
    np.testing.assert_allclose(lc, cpu.fit_fullbatch_scan(b, 6), rtol=1e-5,
                               atol=1e-6)
    for k in ("w", "v"):
        torch.testing.assert_close(card.params[k].cpu(), cpu.params[k],
                                   rtol=1e-5, atol=1e-6)
    ev = card.evaluate(b, batch_size=40)
    assert set(ev) == {"logloss", "accuracy", "auc"}
