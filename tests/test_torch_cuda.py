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
from lightctr_tpu_torch.nn import flash_attention as fl
from lightctr_tpu_torch.ops import quantize as qz
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


@pytest.mark.parametrize("name", sorted(id_streams()))
def test_dedup_kernel_int64_matches_plain(dev, name):
    """int64 ids: each stream shifted past int32, with int64's limits."""
    ids = id_streams()[name].astype(np.int64) * (1 << 33) - 5
    ids[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max][:ids.size]
    ids = torch.from_numpy(ids).to(dev)
    count = int(sk.dedup_ids_plain(ids, ids.numel())[2])
    for size in sorted({ids.numel(), max(1, count // 3)}):
        got = sk.dedup_ids(ids, size)
        for a, b in zip(got, sk.dedup_ids_plain(ids, size)):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def digit_streams(k):
    """Streams that only a stable radix sort with its digit skip keeps
    right: int64 ids that differ only above bit 40, ids that differ only
    in the lowest 8-bit digit, ids that differ only in the sign bit (int32
    and int64), each with repeats in shuffled order."""
    rng = np.random.default_rng(k)
    i64 = np.iinfo(np.int64)
    return {
        "int64_above_bit40": (rng.integers(0, 64, k).astype(np.int64) << 41)
        + 0x123456789,
        "int32_lowest_digit": (rng.integers(0, 256, k) + 0x5A5A5A00)
        .astype(np.int32),
        "int64_lowest_digit": rng.integers(0, 256, k).astype(np.int64)
        - (1 << 50),
        "int32_sign_bit": np.where(rng.random(k) < 0.5, -(1 << 31), 0)
        .astype(np.int32),
        "int64_sign_bit": np.where(rng.random(k) < 0.5, i64.min, 0)
        .astype(np.int64),
    }


@pytest.mark.parametrize("k", [4095, 4096, 4097, (1 << 18) + 1])
@pytest.mark.parametrize("name", sorted(digit_streams(1)))
def test_dedup_kernel_digit_streams_match_plain(dev, name, k):
    """Bit for bit at K around the sort's 4096-key tile and past 2^18:
    uids, inv (stability across tiles shows only there) and the count."""
    ids = torch.from_numpy(digit_streams(k)[name]).to(dev)
    count = int(sk.dedup_ids_plain(ids, k)[2])
    for size in sorted({k, max(1, count // 2)}):
        got = sk.dedup_ids(ids, size)
        for a, b in zip(got, sk.dedup_ids_plain(ids, size)):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k, size)


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
    """Both versions take out-of-table uids as the JAX reference does (the
    plain version is held to it on the CPU): -2 wraps to row 6, 8 is
    dropped, and the sum of squares counts every row."""
    uids = torch.tensor([0, 3, -2, 5, 8, 0], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn((8, 3), generator=gen, device=dev)
    accum = torch.rand((8, 3), generator=gen, device=dev)
    rows = torch.randn((6, 3), generator=gen, device=dev)
    for inv in (None, torch.tensor([0, 1, 2, 3, 4, 4], dtype=torch.int32,
                                   device=dev)):
        t1, a1, s1 = sk.merge_apply(table.clone(), accum.clone(), uids, rows,
                                    inv, lr=0.1)
        t2, a2, s2 = sk.merge_apply_plain(table.clone(), accum.clone(), uids,
                                          rows, inv, 0.1, 1e-7, 1.0)
        assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
        assert torch.equal(t1[[1, 2, 4, 7]], table[[1, 2, 4, 7]])
        assert not torch.equal(t1[6], table[6])
        torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [1, 8])
def test_merge_apply_merge_mode_kernel_matches_plain(dev, d):
    """Merge mode: merge_rows into the [S, d] scratch, then the apply,
    on two ranks' gathered ids; one launch of each kernel."""
    rng = np.random.default_rng(d + 3)
    ids = torch.from_numpy(
        (rng.random(6000) ** 4 * 4096).astype(np.int32)).to(dev)
    uids, inv, _ = sk.dedup_ids(ids)
    shape = (4096,) if d == 1 else (4096, d)
    gen = torch.Generator(device=dev).manual_seed(d)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    rows = torch.randn((ids.numel(),) + shape[1:], generator=gen, device=dev)
    sk.reset_launches()
    t1, a1, s1 = sk.merge_apply(table.clone(), accum.clone(), uids, rows,
                                inv, lr=0.05, denom=2.0)
    assert sk.launches("merge_rows") == 1 and sk.launches("merge_apply") == 1
    t2, a2, s2 = sk.merge_apply_plain(table.clone(), accum.clone(), uids,
                                      rows, inv, 0.05, 1e-7, 2.0)
    assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [1, 32])
def test_merge_rows_kernel_matches_plain(dev, d):
    """Bit for bit (slot-order sums): heavy duplicates and out-of-range
    segments of both signs."""
    rng = np.random.default_rng(d)
    m, nseg = 20000, 3000
    inv = (rng.random(m) ** 4 * (nseg + 6)).astype(np.int32) - 3
    inv[:50] = nseg // 2  # one heavy segment
    inv = torch.from_numpy(inv).to(dev)
    gen = torch.Generator(device=dev).manual_seed(d)
    rows = torch.randn((m, d), generator=gen, device=dev) * 10
    got = sk.merge_rows(rows, inv, nseg)
    assert torch.equal(got, sk.merge_rows_plain(rows, inv, nseg))


@pytest.mark.parametrize("bits, mode", [(4, "normal"), (8, "uniform"),
                                        (8, "normal"), (16, "uniform")])
def test_quantize_pack_kernel_matches_plain(dev, bits, mode):
    """Bit for bit, NaN and +-inf included (NaN and +inf take the top
    code)."""
    gen = torch.Generator(device=dev).manual_seed(bits)
    x = torch.randn((5000, 7), generator=gen, device=dev)
    x.view(-1)[:5] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                                   4.0, -4.0], device=dev)
    table = qz.build_table(-2.0, 2.0, bits=bits, mode=mode, device=dev)
    got = sk.quantize_pack(table, x)
    want = sk.quantize_pack_plain(table, x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    top = (1 << bits) - 1
    assert got.view(-1)[:3].tolist() == [top, 0, top]


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_pack_ef_update_kernel_matches_plain(dev, d, bits):
    """Codes, dec and the residual bit for bit: dedup uids with a real id
    0 and masked pads, rows past the fixed range, a carry from before."""
    rng = np.random.default_rng(d * bits)
    ids = (rng.random(3000) ** 4 * 4096).astype(np.int32)
    ids[0] = 0
    uids, _, _ = sk.dedup_ids(torch.from_numpy(ids).to(dev))
    k = uids.numel()
    shape = (4096,) if d == 1 else (4096, d)
    gen = torch.Generator(device=dev).manual_seed(d)
    table = qz.build_table(-1.0, 1.0, bits=bits,
                           mode="normal" if bits <= 8 else "uniform",
                           device=dev)
    mask = (~((uids == 0) & (torch.arange(k, device=dev) > 0))).float() \
        .reshape((-1,) + (1,) * (len(shape) - 1))
    rows = torch.randn((k,) + shape[1:], generator=gen, device=dev) * 3 * mask
    residual = torch.randn(shape, generator=gen, device=dev) * 0.1
    r1, r2 = residual.clone(), residual.clone()
    c1, _, d1 = sk.quantize_pack_ef_update(table, rows, uids, r1, mask)
    c2, _, d2 = sk.quantize_pack_ef_update_plain(table, rows, uids, r2, mask)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    assert torch.equal(r1, r2)


@pytest.mark.parametrize("mask_kind", ["row", "value", "scalar"])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_pack_ef_kernel_matches_plain(dev, bits, mask_kind):
    """Codes and delta bit for bit: +-inf and NaN in the rows and in the
    carry, masked and unmasked values, a mask of one value per row, per
    value, or one for all."""
    gen = torch.Generator(device=dev).manual_seed(bits)
    rows = torch.randn((3000, 9), generator=gen, device=dev) * 0.8
    rows.view(-1)[:3] = torch.tensor([float("inf"), float("-inf"),
                                      float("nan")], device=dev)
    carried = torch.randn((3000, 9), generator=gen, device=dev) * 0.05
    carried.view(-1)[20:22] = torch.tensor([float("inf"), float("nan")],
                                           device=dev)
    shape = {"row": (3000, 1), "value": (3000, 9), "scalar": ()}[mask_kind]
    mask = (torch.rand(shape, generator=gen, device=dev) > 0.3).float()
    table = qz.build_table(-1.0, 1.0, bits=bits,
                           mode="normal" if bits <= 8 else "uniform",
                           device=dev)
    before = sk.launches("quantize_pack_ef")
    c1, d1 = sk.quantize_pack_ef(table, rows, carried, mask)
    assert sk.launches("quantize_pack_ef") == before + 1
    c2, d2 = sk.quantize_pack_ef_plain(table, rows, carried, mask)
    assert c1.dtype == c2.dtype and torch.equal(c1, c2)
    assert torch.equal(d1.view(torch.int32), d2.view(torch.int32))


#: flash attention: float32 within the JAX test's tolerance; 16-bit types
#: within a few ulps of theirs at |o| < 2 (max) and on average
FLASH_F32 = (2e-4, 2e-5)
FLASH_16_MAX, FLASH_16_MEAN = 2e-2, 2e-3


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(2, 256, 4, 32), (2, 32, 2, 8),
                                   (1, 100, 3, 72), (2, 130, 2, 128),
                                   (1, 70, 2, 20)])
def test_flash_attention_kernel_matches_plain(dev, shape, dtype, causal):
    """Tiles past T and columns past D masked in the kernel (T = 100, 130,
    70; D = 8, 20, 72); one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for _ in range(3))
    before = sk.launches("flash_attention")
    got = fl.flash_attention(q, k, v, causal=causal)
    assert sk.launches("flash_attention") == before + 1
    want = fl.flash_attention_plain(q, k, v, causal)
    assert got.dtype == dt and got.shape == q.shape
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=FLASH_F32[0],
                                   atol=FLASH_F32[1])
    else:
        err = (got.float() - want.float()).abs()
        assert float(err.max()) <= FLASH_16_MAX
        assert float(err.mean()) <= FLASH_16_MEAN


def flash_check(dev, shape, dt, causal):
    """One kernel call against the plain version at ``shape``; returns the
    design that ran."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + causal)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for _ in range(3))
    sk.reset_launches()
    got = fl.flash_attention(q, k, v, causal=causal)
    runs = sk.variant_launches("flash_attention")
    assert sk.launches("flash_attention") == 1 and sum(runs.values()) == 1
    want = fl.flash_attention_plain(q, k, v, causal)
    assert got.dtype == dt and got.shape == q.shape
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=FLASH_F32[0],
                                   atol=FLASH_F32[1])
    else:
        err = (got.float() - want.float()).abs()
        assert bool(torch.isfinite(got.float()).all())
        assert float(err.max()) <= FLASH_16_MAX, float(err.max())
        assert float(err.mean()) <= FLASH_16_MEAN, float(err.mean())
    return next(iter(runs))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernel_refuses_wide_heads(dev, dtype):
    """D = 129 was refused (D <= 128); it now gives a result within the
    tolerances: a 16-bit head whose row stride TMA refuses and that the
    mma.sync kernel cannot take runs the FMA kernel in 128-column output
    slices, as float32 does."""
    assert flash_check(dev, (1, 200, 2, 129), getattr(torch, dtype),
                       True) == "fma"


@pytest.mark.parametrize("t", [100, 1000, 4096])
@pytest.mark.parametrize("d", [64, 128, 160, 256, 320])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_attention_kernel_head_widths_match_plain(dev, dtype, causal,
                                                        d, t):
    """Every head width the JAX kernel takes: the aligned 16-bit shapes
    through D = 256 run the wgmma design, D = 320 the FMA kernel's
    column slices."""
    route = flash_check(dev, (1, t, 2, d), getattr(torch, dtype), causal)
    assert route == ("wgmma" if d <= 256 else "fma")


def test_flash_attention_kernel_many_heads_match_plain(dev):
    """B*H = 65,600, past gridDim.y's 65,535: work items ride gridDim.x."""
    assert flash_check(dev, (32800, 16, 2, 64), torch.bfloat16,
                       True) == "wgmma"


@pytest.mark.parametrize("shape", [(2, 4096, 8, 64), (4, 1024, 8, 64),
                                   (2, 4096, 8, 128)])
def test_flash_attention_aligned_bf16_runs_wgmma(dev, shape):
    """The attention path's and the bench's shapes go through the Hopper
    design, and an offset view of the same data through mma.sync."""
    assert flash_check(dev, shape, torch.bfloat16, True) == "wgmma"
    n = int(np.prod(shape))
    x = torch.randn(n + 1, device=dev).to(torch.bfloat16)[1:].view(shape)
    assert fl.flash_route(x, x, x) == ("mma_sync" if shape[-1] <= 128
                                       else "fma")


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
