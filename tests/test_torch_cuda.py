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

import segment_runs_model as runs_model

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


#: a slot count past one sweep of the touched-row kernels' persistent
#: grid at every width (at most 1024 blocks of 8 warps, 128 slots a warp
#: tile at d = 1 and fewer at any other width)
SWEEP_S = (1 << 21) + 5
#: (d, S, storage offset of rows in floats) of the touched-row kernels'
#: cases: float4 lanes (d % 4 == 0), one float a lane (3, 33), whole slots
#: a lane (1, and 4 on float4), a row across the whole warp (33); S from
#: one slot to past a sweep; rows one float off their 16-byte alignment,
#: so the float4 widths take the one-float path
TOUCHED_CASES = ([(d, s, 0) for d in (1, 3, 4, 8, 32, 33, 64)
                  for s in (1, 31, 4097, SWEEP_S)]
                 + [(d, 4097, 1) for d in (8, 32, 64)] + [(32, SWEEP_S, 1)])


def touched_uids(seed, s, vocab):
    """[s] int32 uids of the dedup convention for the touched-row kernels:
    a real id 0 at slot 0 (past one slot), then distinct rows in shuffled
    order, a quarter of them as ``row - vocab`` (which wraps to the row),
    about 1 % outside the table either side (dropped), then id-0 pads for
    the last third of the slots."""
    rng = np.random.default_rng(seed)
    lead = 1 if s > 1 else 0
    n = max(1, min(s - lead - s // 3, vocab - 1))
    u = rng.choice(np.arange(1, vocab), size=n, replace=False)
    wrap = rng.random(n) < 0.25
    u[wrap] -= vocab
    out = rng.random(n) < 0.01
    u[out] = np.where(rng.random(out.sum()) < 0.5,
                      vocab + rng.integers(0, 100, out.sum()),
                      -vocab - 1 - rng.integers(0, 100, out.sum()))
    uids = np.zeros(s, np.int32)
    uids[lead:lead + n] = u
    return uids


def offset_rows(rows, offset):
    """``rows`` copied into a contiguous view ``offset`` floats into its
    storage."""
    if not offset:
        return rows
    buf = torch.empty(rows.numel() + offset, dtype=rows.dtype,
                      device=rows.device)
    view = buf[offset:].view(rows.shape)
    view.copy_(rows)
    return view


def merge_apply_touched(dev, d, s, offset, seed):
    """(table, accum, uids, rows) of a touched-row case: vocab 2^20 at the
    largest S, 8192 otherwise."""
    vocab = 1 << 20 if s > 8192 else 8192
    uids = torch.from_numpy(touched_uids(seed, s, vocab)).to(dev)
    shape = (vocab,) if d == 1 else (vocab, d)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    rows = torch.randn((s,) + shape[1:], generator=gen, device=dev)
    return table, accum, uids, offset_rows(rows, offset)


@pytest.mark.parametrize("d, s, offset", TOUCHED_CASES)
@pytest.mark.parametrize("denom", [1.0, 4.0])
def test_merge_apply_kernel_matches_plain(dev, d, s, offset, denom):
    """The apply mode within 2 ulp of the plain version and sumsq within
    rtol 1e-5, with pads, wrapping uids and uids outside the table."""
    table, accum, uids, rows = merge_apply_touched(dev, d, s, offset, d + s)
    assert rows.storage_offset() == offset and rows.is_contiguous()
    sk.reset_launches()
    t1, a1, s1 = sk.merge_apply(table.clone(), accum.clone(), uids, rows,
                                lr=0.05, denom=denom)
    assert sk.variant_launches("merge_apply") == {"apply": 1}
    t2, a2, s2 = sk.merge_apply_plain(table.clone(), accum.clone(), uids,
                                      rows, None, 0.05, 1e-7, denom)
    assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [1, 3, 4, 32])
def test_merge_apply_kernel_sumsq_is_the_same_every_call(dev, d):
    """The apply mode's sum of squares is bitwise the same over two calls
    and over three replays of one captured CUDA graph; the table and
    accumulator a replay leaves are those of an eager call."""
    table, accum, uids, rows = merge_apply_touched(dev, d, 159744, 0, 11)
    runs = []
    for _ in range(2):
        t, a = table.clone(), accum.clone()
        runs.append((t, a, sk.merge_apply(t, a, uids, rows, lr=0.05,
                                          denom=2.0)[2].clone()))
    assert torch.equal(runs[0][2].view(torch.int32),
                       runs[1][2].view(torch.int32))
    t, a = table.clone(), accum.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sk.merge_apply(t, a, uids, rows, lr=0.05, denom=2.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, _, ssq = sk.merge_apply(t, a, uids, rows, lr=0.05, denom=2.0)
    for _ in range(3):
        t.copy_(table)
        a.copy_(accum)
        ssq.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ssq.view(torch.int32), runs[0][2].view(torch.int32))
        assert torch.equal(t, runs[0][0]) and torch.equal(a, runs[0][1])


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


def merge_mode_case(dev, d, n_ids=6000, vocab=4096, seed=3):
    """Two ranks' gathered ids deduped onto their union (uids with id-0
    pads), a [vocab, d] table and accumulator, and the gathered rows."""
    rng = np.random.default_rng(d + seed)
    ids = torch.from_numpy(
        (rng.random(n_ids) ** 4 * vocab).astype(np.int32)).to(dev)
    uids, inv, count = sk.dedup_ids(ids)
    shape = (vocab,) if d == 1 else (vocab, d)
    gen = torch.Generator(device=dev).manual_seed(d + seed)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    rows = torch.randn((ids.numel(),) + shape[1:], generator=gen, device=dev)
    return uids, inv, int(count), table, accum, rows


def check_merge_mode(uids, inv, table, accum, rows, denom=2.0):
    """The fused merge mode against the plain version: one launch of
    merge_apply in its ``merge`` design and none of merge_rows; table and
    accum within 2 ulp, sumsq within rtol 1e-5.  Returns both results."""
    sk.reset_launches()
    t1, a1, s1 = sk.merge_apply(table.clone(), accum.clone(), uids, rows,
                                inv, lr=0.05, denom=denom)
    assert sk.launches("merge_rows") == 0 and sk.launches("merge_apply") == 1
    assert sk.variant_launches("merge_apply") == {"merge": 1}
    t2, a2, s2 = sk.merge_apply_plain(table.clone(), accum.clone(), uids,
                                      rows, inv, 0.05, 1e-7, denom)
    assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)
    return (t1, a1), (t2, a2)


@pytest.mark.parametrize("d", [1, 8, 32, 33])
def test_merge_apply_merge_mode_kernel_matches_plain(dev, d):
    """Merge mode, fused: the sorted runs' sums applied straight to the
    table, on two ranks' gathered ids; one launch, of merge_apply's
    ``merge`` design, and no merge_rows launch."""
    uids, inv, _, table, accum, rows = merge_mode_case(dev, d)
    check_merge_mode(uids, inv, table, accum, rows)


@pytest.mark.parametrize("d", [1, 32])
def test_merge_apply_merge_mode_zero_rows_get_the_plain_update(dev, d):
    """A real uid whose gathered rows are all +-0 receives no kept row: it
    still gets the plain version's update with g = +0, which turns a -0.0
    accumulator into +0.0, bit for bit."""
    uids, inv, count, table, accum, rows = merge_mode_case(dev, d, seed=11)
    seg = 3
    uid = int(uids[seg])
    assert uid != 0 and seg < count
    hit = inv == seg
    assert int(hit.sum()) >= 1
    rows[hit] = torch.where(torch.rand_like(rows[hit]) < 0.5, 0.0, -0.0)
    accum[uid] = -0.0
    table[uid] = torch.where(torch.rand_like(table[uid]) < 0.5, 0.0, -0.0)
    (t1, a1), (t2, a2) = check_merge_mode(uids, inv, table, accum, rows)
    for got, want in ((t1, t2), (a1, a2)):
        assert torch.equal(got[uid].view(torch.int32),
                           want[uid].view(torch.int32))
    assert not bool(torch.signbit(a1[uid]).any())  # -0.0 became +0.0


def test_merge_apply_merge_mode_heavy_run_and_wide_segments(dev):
    """A segment of 4,096 rows (summed in slot order, one column a thread),
    and segments past 2^24, so the radix sort moves its top digit: S =
    2^24 + 4,096 distinct uids of a 2^25-row table at d = 1."""
    uids, inv, _, table, accum, rows = merge_mode_case(dev, 32)
    inv = inv.clone()
    inv[:4096] = 5
    check_merge_mode(uids, inv, table, accum, rows)
    gen = torch.Generator(device=dev).manual_seed(9)
    vocab, s, m = 1 << 25, (1 << 24) + 4096, 200_000
    uids = torch.randperm(vocab, generator=gen, device=dev)[:s].sort() \
        .values.to(torch.int32)
    inv = torch.randint(0, s, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    inv[:1000] = torch.arange(s - 1000, s, device=dev, dtype=torch.int32)
    assert int((inv >= (1 << 24)).sum()) > 1000
    table = torch.randn((vocab,), generator=gen, device=dev)
    accum = torch.rand((vocab,), generator=gen, device=dev)
    rows = torch.randn((m,), generator=gen, device=dev)
    check_merge_mode(uids, inv, table, accum, rows, denom=1.0)


@pytest.mark.parametrize("mode", ["uniform", "normal", "log"])
def test_quantile_tables_on_the_card_equal_the_cpu_tables(dev, mode):
    """A table for the card (a fixed range, or a measured range that
    lives on the card) is the CPU's table bit for bit: the card's
    ``ndtri`` differs from the CPU's in the last ulp, and a coded
    exchange that re-encodes sums of decoded values meets boundaries
    exactly, so the card and the CPU would code some values apart."""
    rng = np.random.default_rng(1)
    for bits in (1, 4, 8, 16):
        for lim in [1.0, 0.05] + list(rng.uniform(1e-3, 3.0, 8)):
            want = qz.build_table(-lim, lim, bits=bits, mode=mode)
            lt = torch.tensor(lim, dtype=torch.float32)
            want_t = qz.build_table(-lt, lt, bits=bits, mode=mode)
            for got, ref in ((qz.build_table(-lim, lim, bits=bits,
                                             mode=mode, device=dev), want),
                             (qz.build_table(-lt.to(dev), lt.to(dev),
                                             bits=bits, mode=mode), want_t)):
                for part in ("boundaries", "values"):
                    g = getattr(got, part)
                    assert g.device.type == "cuda"
                    assert torch.equal(g.cpu(), getattr(ref, part)), (
                        mode, bits, lim, part)


def rs_owners(dev, n=8, k=2000, vocab=1 << 14, seed=0):
    """n ranks' u^4 id streams down the reduce-scatter's id path on one
    process: each rank's dedup and owner partition, and each owner's n
    received buckets in the ring's slot order -> ([n*bucket_cap] ids an
    owner, the shard capacity)."""
    from lightctr_tpu_torch.dist import collectives as coll

    rng = np.random.default_rng(seed)
    bucket, shard = coll.rs_default_caps(n, k, vocab)
    plans = []
    for _ in range(n):
        ids = (rng.random(k) ** 4 * vocab).astype(np.int32)
        u, _, _ = sk.dedup_ids(torch.from_numpy(ids).to(dev))
        plans.append(coll.rs_owner_partition(u, n, bucket))
    owners = [torch.stack([plans[(r - i) % n][2][r] for i in range(n)])
              .reshape(-1) for r in range(n)]
    return owners, shard


@pytest.mark.parametrize("cut", ["shard_cap", "below_count"])
def test_rs_merge_ids_dedup_cut_matches_plain(dev, cut):
    """The owner's id merge: dedup_ids on the n*bucket_cap received ids
    cut at the shard capacity (size < K), and cut below the distinct
    count (the overflow case: ``inv`` keeps full ranks, past the cut):
    one launch each, bit for bit the plain version's, overflow counted."""
    from lightctr_tpu_torch.dist import collectives as coll

    owners, shard = rs_owners(dev)
    for all_ids in owners:
        count = int(sk.dedup_ids_plain(all_ids.cpu(), all_ids.numel())[2])
        size = shard if cut == "shard_cap" else count // 2
        assert size < all_ids.numel()
        before = sk.launches("dedup_ids")
        got = coll._rs_merge_ids(all_ids, size)
        assert sk.launches("dedup_ids") == before + 1
        want = coll._rs_merge_ids(all_ids.cpu(), size)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert int(got[2]) == max(0, count - size)


@pytest.mark.parametrize("d", [1, 32])
def test_merge_apply_apply_on_gathered_shards_matches_plain(dev, d):
    """The apply mode on the reduce-scatter's all-gathered owner shards:
    ``out_ids`` is n sorted shards end to end, each foreign shard led by
    an id-0 pad whose (coded) row is not zero and must be skipped, every
    other uid distinct; within 2 ulp of the plain version, sumsq rtol
    1e-5."""
    from lightctr_tpu_torch.dist import collectives as coll

    owners, shard = rs_owners(dev)
    out_ids = torch.cat([coll._rs_merge_ids(a, shard)[0] for a in owners])
    s = out_ids.numel()
    pad = (out_ids == 0) & (torch.arange(s, device=dev) > 0)
    assert bool(pad[shard::shard].all())  # each foreign shard's lead
    real = out_ids[~pad]
    assert real.unique().numel() == real.numel()
    gen = torch.Generator(device=dev).manual_seed(d)
    vocab = 1 << 14
    shape = (vocab,) if d == 1 else (vocab, d)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    rows = torch.randn((s,) + shape[1:], generator=gen, device=dev)
    t1, a1, t2, a2 = table.clone(), accum.clone(), table.clone(), \
        accum.clone()
    before = sk.variant_launches("merge_apply").get("apply", 0)
    _, _, s1 = sk.merge_apply(t1, a1, out_ids, rows, lr=0.05, eps=1e-7)
    assert sk.variant_launches("merge_apply")["apply"] == before + 1
    _, _, s2 = sk.merge_apply_plain(t2, a2, out_ids, rows, None, 0.05,
                                    1e-7, 1.0)
    assert ulp(t1, t2) <= MAX_ULP and ulp(a1, a2) <= MAX_ULP
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=0)


def test_rs_owner_partition_on_card_matches_cpu(dev):
    """The owner partition and the bucket scatter (PyTorch ops, no
    kernel of the port's) give the CPU's plan on the card: the stable
    owner order, the destinations, the buckets and the overflow."""
    from lightctr_tpu_torch.dist import collectives as coll

    rng = np.random.default_rng(3)
    u = np.unique(rng.integers(1, 4096, size=3000)).astype(np.int32)
    uids = np.zeros(3000, np.int32)
    uids[:u.size] = u
    rows = rng.normal(size=(3000, 32)).astype(np.float32)
    for cap in (500, 250):
        got = coll.rs_owner_partition(torch.from_numpy(uids).to(dev), 8, cap)
        want = coll.rs_owner_partition(torch.from_numpy(uids), 8, cap)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(
            coll.rs_scatter_rows(torch.from_numpy(rows).to(dev), got[0],
                                 got[1], 8, cap).cpu(),
            coll.rs_scatter_rows(torch.from_numpy(rows), want[0], want[1],
                                 8, cap))


@pytest.mark.parametrize("d", [1, 8, 32, 33])
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


@pytest.mark.parametrize("case", ["heavy_run", "zero_segments", "nseg_2p24"])
def test_merge_rows_kernel_edge_cases_match_plain(dev, case):
    """A run of 4,096 rows in one segment; segments whose every row is +-0
    (left at +0); nseg past 2^24, so all four radix digits move."""
    gen = torch.Generator(device=dev).manual_seed(13)
    m, nseg, d = 30000, 5000, 32
    if case == "nseg_2p24":
        m, nseg, d = 200_000, (1 << 24) + 77, 1
    inv = torch.randint(-2, nseg + 2, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = torch.randn((m, d), generator=gen, device=dev)
    if case == "heavy_run":
        inv[5000:9096] = 17
    if case == "zero_segments":
        zero = (inv % 7) == 0
        rows[zero] = torch.where(torch.rand_like(rows[zero]) < 0.5, 0.0, -0.0)
    sk.reset_launches()
    got = sk.merge_rows(rows, inv, nseg)
    assert sk.launches("merge_rows") == 1
    want = sk.merge_rows_plain(rows, inv, nseg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("d", [1, 32, 33, 300])
def test_merge_long_runs_match_plain(dev, d):
    """A run far longer than a walker block's tile (as the coded
    exchange's padding makes: about half the rows in one segment), and
    runs of 16 and 17 rows, around the length where the whole block takes
    a run over from one thread a column: merge_rows bit for bit, merge
    mode within 2 ulp."""
    gen = torch.Generator(device=dev).manual_seed(d + 21)
    m, nseg, vocab = 40_000, 2000, 8192
    inv = torch.randint(-2, nseg + 2, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    inv[1000:21000] = 7
    inv[30000:30016] = 100
    inv[30100:30117] = 101
    rows = torch.randn((m, d), generator=gen, device=dev)
    got = sk.merge_rows(rows, inv, nseg)
    want = sk.merge_rows_plain(rows, inv, nseg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    uids = torch.randperm(vocab, generator=gen, device=dev)[:nseg].sort() \
        .values.to(torch.int32)
    shape = (vocab,) if d == 1 else (vocab, d)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    check_merge_mode(uids, inv % nseg, table, accum,
                     rows.reshape(-1) if d == 1 else rows)


def long_run_merges(dev, rows, inv, nseg, vocab, seed):
    """merge_rows twice and merge_apply's merge mode twice on ``rows`` and
    ``inv`` (segments ``nseg``, merge mode onto ``nseg`` sorted distinct
    uids of a ``vocab``-row table), each watched: merge_rows equals
    ``merge_rows_plain`` (the CPU's slot-order sums) and itself bit for
    bit, the merge mode its plain version (``check_merge_mode``) and
    itself (tables, accumulators and the sum of squares bit for bit).
    Returns the two kernels' ``long_run_stats``."""
    with sk.watch_long_runs():
        got = [sk.merge_rows(rows, inv, nseg) for _ in range(2)]
        stats = sk.long_run_stats("merge_rows")
    assert torch.equal(got[0].view(torch.int32), got[1].view(torch.int32))
    want = sk.merge_rows_plain(rows.cpu(), inv.cpu(), nseg)
    assert torch.equal(got[0].cpu().view(torch.int32), want.view(torch.int32))
    del got
    d = rows[0].numel()
    gen = torch.Generator(device=dev).manual_seed(seed)
    uids = torch.randperm(vocab, generator=gen, device=dev)[:nseg].sort() \
        .values.to(torch.int32)
    shape = (vocab,) if d == 1 else (vocab, d)
    table = torch.randn(shape, generator=gen, device=dev)
    accum = torch.rand(shape, generator=gen, device=dev)
    flat = rows.reshape(-1) if d == 1 else rows
    with sk.watch_long_runs():
        (t1, a1), _ = check_merge_mode(uids, inv, table, accum, flat)
        merge_stats = sk.long_run_stats("merge_apply")
    sums = []
    for _ in range(2):
        t, a = table.clone(), accum.clone()
        sums.append((t, a, sk.merge_apply(t, a, uids, flat, inv, lr=0.05,
                                          denom=2.0)[2]))
    for t, a, ssq in sums:
        assert torch.equal(t.view(torch.int32), t1.view(torch.int32))
        assert torch.equal(a.view(torch.int32), a1.view(torch.int32))
        assert torch.equal(ssq.view(torch.int32),
                           sums[0][2].view(torch.int32))
    return stats, merge_stats


def expected_long_runs(inv, nseg, d):
    """The model's run list of ``inv``: (count, longest run)."""
    starts, ends, _ = runs_model.runs_of(inv, nseg)
    lst = runs_model.run_list(starts, ends, inv.size, nseg, d)
    return lst["length"].size, int(lst["length"].max(initial=0))


@pytest.mark.parametrize("d", [1, 10, 32])
def test_long_run_walk_at_the_criteo_shape(dev, d):
    """The benchmark's batch shape: 65,536 rows x 39 fields, 26 drawn
    from power laws, 13 holding one id in every row (13 whole-batch runs).
    merge_rows equals its plain version and itself bit for bit, and so
    does B5's merge mode on the same ids; every long run is listed and
    walked, and the busiest walker takes at most 1.3 times the longest
    run's slots (the fixed assignment of tiles to walkers put several
    whole-batch runs on one)."""
    ids = runs_model.criteo_ids(65536, seed=d).reshape(-1)
    nseg = runs_model.criteo_vocab()
    gen = torch.Generator(device=dev).manual_seed(d)
    rows = torch.randn((ids.size, d), generator=gen, device=dev)
    inv = torch.from_numpy(ids).to(dev)
    stats, merge_stats = long_run_merges(dev, rows, inv, nseg, 1 << 20, d)
    count, longest = expected_long_runs(ids, nseg, d)
    assert longest == 65536
    for st in (stats, merge_stats):
        assert st["listed"] == st["walked"] == count
        assert st["longest_run_slots"] == longest
        assert longest <= st["busiest_walker_slots"] <= 1.3 * longest


@pytest.mark.parametrize("d", [1, 32])
@pytest.mark.parametrize("case", runs_model.EDGE_CASES)
def test_long_run_list_edge_cases(dev, case, d):
    """A tile that starts several long runs, a run across many tiles, all
    slots in one run (the coded padding), no long run, and segments left
    without kept rows (+0 from merge_rows, the +0 update from the merge
    mode): bit for bit as above, and the counters as the model lists
    them."""
    inv_np, nseg = runs_model.edge_case(case)
    gen = torch.Generator(device=dev).manual_seed(d + 31)
    rows = torch.randn((inv_np.size, d), generator=gen, device=dev)
    inv = torch.from_numpy(inv_np).to(dev)
    stats, merge_stats = long_run_merges(dev, rows, inv, nseg, 1 << 14,
                                         d + 31)
    count, longest = expected_long_runs(inv_np, nseg, d)
    for st in (stats, merge_stats):
        assert st["listed"] == st["walked"] == count
        assert st["longest_run_slots"] == longest
        assert (st["busiest_walker_slots"] >= longest if count
                else st["busiest_walker_slots"] == 0)
    if case == "one_run":
        assert stats["busiest_walker_slots"] == inv_np.size
    if case == "empty_segments":
        empty = np.setdiff1d(np.arange(nseg), inv_np)
        assert empty.size > nseg // 2
        out = sk.merge_rows(rows, inv, nseg)[torch.from_numpy(empty).to(dev)]
        assert not bool(out.view(torch.int32).any())  # +0, every bit


GATHER_DS = (1, 4, 32, 33, 128)
GATHER_NS = (1, 31, 32, 33, 1000, 4097, 8192, 159744)


def gather_case(dev, d, n, offset, seed):
    """A [R, d] block stored ``offset`` floats past 16 bytes (R 2^20 at
    the train batch's n, 65,536 below) and n int32 ids: every clip edge
    first (-1, R, int32's limits, R - 1, 0, -R, 2R), then uniform over
    [-R/4, 5R/4)."""
    rows = 1 << 20 if n > 100000 else 65536
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = offset_rows(torch.randn((rows, d), generator=gen, device=dev),
                        offset)
    idx = torch.randint(-rows // 4, rows + rows // 4, (n,), generator=gen,
                        device=dev, dtype=torch.int64)
    edges = torch.tensor([-1, rows, -(1 << 31), (1 << 31) - 1, rows - 1, 0,
                          -rows, 2 * rows])
    m = min(n, edges.numel())
    idx[:m] = edges[:m]
    return block, idx.to(torch.int32)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", GATHER_NS)
@pytest.mark.parametrize("d", GATHER_DS)
def test_gather_rows_kernel_matches_plain(dev, d, n, offset):
    """Bit for bit (``torch.equal``), one launch a call: the block
    ``offset`` floats off 16 bytes and the output ``offset + 1`` (so the
    float4 lanes' alignment test sees each pointer off alone and both), the
    same ids as int64 moved by multiples of 2^32 (the int32 cast wraps them
    back), and at d 33 the block as [R, 3, 11]."""
    block, idx = gather_case(dev, d, n, offset, 7 * d + n + offset)
    want = sk.gather_rows_plain(block, idx)
    before = sk.launches("gather_rows")
    assert torch.equal(sk.gather_rows(block, idx), want)
    assert sk.launches("gather_rows") == before + 1
    out = offset_rows(torch.empty_like(want), (offset + 1) % 4)
    sk._gather_rows_into(block, idx, out)
    assert torch.equal(out, want)
    wide = idx.to(torch.int64) \
        + (torch.arange(n, device=dev) % 3 - 1) * (1 << 32)
    assert torch.equal(sk.gather_rows(block, wide), want)
    if d == 33:
        assert torch.equal(sk.gather_rows(block.view(-1, 3, 11), idx),
                           want.view(n, 3, 11))


def test_gather_rows_into_refuses_a_wrong_out(dev):
    """The launcher writes only into a float32 out of n rows of a float32
    block's width, from int32/int64 ids, and launches (and counts) nothing
    otherwise, nor for n 0."""
    block, idx = gather_case(dev, 33, 100, 0, 5)
    before = sk.launches("gather_rows")
    for out in (torch.empty((99, 33), device=dev),
                torch.empty((100, 32), device=dev)):
        with pytest.raises(ValueError, match="gather_rows: out"):
            sk._gather_rows_into(block, idx, out)
    out = torch.empty((100, 33), device=dev)
    for args in ((block, idx.to(torch.float32), out),
                 (block, idx.to(torch.int16), out),
                 (block.double(), idx, out.double()),
                 (block, idx, out.double())):
        with pytest.raises(TypeError, match="gather_rows kernel takes"):
            sk._gather_rows_into(*args)
    with pytest.raises(ValueError, match="nothing to gather"):
        sk._gather_rows_into(block, idx[:0], out[:0])
    with pytest.raises(TypeError, match="gather_rows kernel takes"):
        sk.gather_rows(block.double(), idx)
    assert sk.launches("gather_rows") == before


@pytest.mark.parametrize("d", [1, 33, 128])
def test_gather_rows_floor_moves_nothing_and_counts_nothing(dev, d):
    """The floor launches an empty kernel at the gather's grid: out keeps
    what it held, and no gather launch is counted."""
    block, idx = gather_case(dev, d, 8192, 0, 3)
    out = torch.full((8192, d), 7.0, device=dev)
    before = sk.launches("gather_rows")
    sk.gather_rows_floor(block, idx, out)
    torch.cuda.synchronize()
    assert sk.launches("gather_rows") == before
    assert bool((out == 7.0).all())


@pytest.mark.parametrize("edge", ["n_times_d", "rows_times_d"])
def test_gather_rows_kernel_wide_index_math_matches_plain(dev, edge):
    """The 64-bit instantiation, bit for bit: n * d past 2^31 (d 33, one
    float lanes), and R * d past 2^31 (d 128, float4 lanes, ids up to the
    block's last row)."""
    if edge == "n_times_d":
        rows, d, n = 4096, 33, (1 << 31) // 33 + 1000
    else:
        rows, d, n = (1 << 24) + 3, 128, 100000
    assert n * d >= 1 << 31 or rows * d >= 1 << 31
    gen = torch.Generator(device=dev).manual_seed(11)
    block = torch.randn((rows, d), generator=gen, device=dev)
    idx = torch.randint(0, rows + 10, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([rows - 1, rows], device=dev)
    got = sk.gather_rows(block, idx)
    assert torch.equal(got, sk.gather_rows_plain(block, idx))


def variant_delta(name, before):
    """Launches of kernel ``name`` by design since ``before`` (a
    ``variant_launches`` snapshot), the designs that ran only."""
    after = sk.variant_launches(name)
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def check_quantize_pack(table, x):
    """The kernel's codes against the plain version's bit for bit, through
    the design the table's width names, in one launch."""
    before = sk.variant_launches("quantize_pack")
    got = sk.quantize_pack(table, x)
    assert variant_delta("quantize_pack", before) == {
        sk.search_design(table.bits): 1}
    want = sk.quantize_pack_plain(table, x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    return got


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
@pytest.mark.parametrize("bits, mode", [(1, "uniform"), (4, "normal"),
                                        (8, "uniform"), (8, "normal"),
                                        (16, "uniform")])
def test_quantize_pack_kernel_matches_plain(dev, bits, mode, tail, offset):
    """Bit for bit, NaN and +-inf included (NaN and +inf take the top
    code), at n = 4k + tail values starting ``offset`` floats past 16
    bytes (a scalar head and tail around the float4 body), the codes on
    their own alignment."""
    gen = torch.Generator(device=dev).manual_seed(bits + 16 * tail)
    x = torch.randn((5000, 7), generator=gen, device=dev)
    x.view(-1)[:5] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                                   4.0, -4.0], device=dev)
    x = offset_rows(x.view(-1)[:35000 + tail], offset)
    x.view(-1)[-1] = float("nan")  # a NaN in the scalar tail
    table = qz.build_table(-2.0, 2.0, bits=bits, mode=mode, device=dev)
    got = check_quantize_pack(table, x)
    top = (1 << bits) - 1
    assert got.view(-1)[:3].tolist() == [top, 0, top]
    assert int(got.view(-1)[-1]) == top


def split_edge_values(bnd, head, seg):
    """Every boundary, one ulp either side, and the boundaries at each
    segment's edges of the two-stage search (its first and last, the
    head's), with NaN, +-inf and values past both ends."""
    b = bnd.cpu()
    idx = torch.arange(b.numel())
    edges = b[((idx - head) % seg == 0) | ((idx - head) % seg == seg - 1)
              | (idx < head)]
    inf = torch.tensor(float("inf"))
    vals = torch.cat([b, torch.nextafter(b, inf), torch.nextafter(b, -inf),
                      edges, torch.nextafter(edges, inf),
                      torch.nextafter(edges, -inf),
                      torch.tensor([float("nan"), float("inf"),
                                    float("-inf"), 1e30, -1e30, 0.0,
                                    -0.0])])
    return vals[torch.randperm(vals.numel(),
                               generator=torch.Generator().manual_seed(3))]


@pytest.mark.parametrize("bnd_offset", [0, 1, 2, 3])
@pytest.mark.parametrize("bits", [9, 12, 16])
def test_quantize_pack_split_search_edges_match_plain(dev, bits, bnd_offset):
    """The two-stage search above 8 bits, bit for bit: values on every
    boundary, one ulp either side, on each segment edge (segments start on
    16 bytes, so the boundaries' own offset moves them), NaN and +-inf,
    the payload itself misaligned."""
    t = qz.build_table(-1.0, 1.0, bits=bits, mode="normal", device=dev)
    buf = torch.empty(t.boundaries.numel() + bnd_offset, device=dev)
    table = qz.QuantTable(buf[bnd_offset:].copy_(t.boundaries), t.values,
                          bits)
    head = (4 - (table.boundaries.data_ptr() % 16) // 4) % 4
    for seg in (8, 16, 32):
        x = split_edge_values(table.boundaries, head, seg).to(dev)
        check_quantize_pack(table, x)
        check_quantize_pack(table, offset_rows(x, 1))


def check_ef_update(dev, uids, shape, bits, offset, seed):
    """Codes, dec and the residual of the kernel and the plain version bit
    for bit, in one launch through the design the table's width names:
    pads (uid 0 past slot 0) masked and zero, rows past the fixed range, a
    carry from before."""
    k = uids.numel()
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = qz.build_table(-1.0, 1.0, bits=bits,
                           mode="normal" if bits <= 8 else "uniform",
                           device=dev)
    mask = (~((uids == 0) & (torch.arange(k, device=dev) > 0))).float() \
        .reshape((-1,) + (1,) * (len(shape) - 1))
    rows = offset_rows(
        torch.randn((k,) + shape[1:], generator=gen, device=dev) * 3 * mask,
        offset)
    residual = torch.randn(shape, generator=gen, device=dev) * 0.1
    r1, r2 = residual.clone(), residual.clone()
    before = sk.variant_launches("quantize_pack_ef_update")
    c1, _, d1 = sk.quantize_pack_ef_update(table, rows, uids, r1, mask)
    assert variant_delta("quantize_pack_ef_update", before) == {
        sk.search_design(bits): 1}
    c2, _, d2 = sk.quantize_pack_ef_update_plain(table, rows, uids, r2, mask)
    assert c1.dtype == c2.dtype and torch.equal(c1, c2)
    assert torch.equal(d1, d2) and torch.equal(r1, r2)


@pytest.mark.parametrize("d, s, offset", TOUCHED_CASES)
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_pack_ef_update_kernel_matches_plain(dev, d, s, offset,
                                                      bits):
    """Codes, dec and the residual bit for bit at the touched-row walk's
    widths, slot counts and offsets: a real id 0 at slot 0, pads (uid 0
    past slot 0) masked and zero, wrapping uids and uids outside the table
    (their carry reads NaN, which takes the top code), rows past the fixed
    range, a carry from before; each launch counted under its design
    (``tree`` at 8 bits, ``split`` at 16)."""
    vocab = 1 << 20 if s > 8192 else 8192
    uids = torch.from_numpy(touched_uids(d * s + bits, s, vocab)).to(dev)
    check_ef_update(dev, uids, (vocab,) if d == 1 else (vocab, d), bits,
                    offset, d + bits)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [1, 3, 4, 32, 33])
@pytest.mark.parametrize("mask_kind", ["row", "value", "scalar"])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_pack_ef_kernel_matches_plain(dev, bits, mask_kind, d,
                                               offset):
    """Codes and delta bit for bit: +-inf and NaN in the rows and in the
    carry, masked and unmasked values, a mask of one value per row, per
    value, or one for all; rows of d values (d = 1: a 1-D payload) from
    float4 lanes to one float a lane, and rows, carry and mask ``offset``
    floats off 16 bytes (one float a lane); one launch of the design the
    table's width names."""
    gen = torch.Generator(device=dev).manual_seed(bits + d)
    p = 3000
    shape = (p,) if d == 1 else (p, d)
    rows = torch.randn(shape, generator=gen, device=dev) * 0.8
    rows.view(-1)[:3] = torch.tensor([float("inf"), float("-inf"),
                                      float("nan")], device=dev)
    carried = torch.randn(shape, generator=gen, device=dev) * 0.05
    carried.view(-1)[20:22] = torch.tensor([float("inf"), float("nan")],
                                           device=dev)
    mshape = {"row": (p,) + (1,) * (len(shape) - 1), "value": shape,
              "scalar": ()}[mask_kind]
    mask = (torch.rand(mshape, generator=gen, device=dev) > 0.3).float()
    rows, carried = offset_rows(rows, offset), offset_rows(carried, offset)
    mask = offset_rows(mask, offset) if mask.dim() else mask
    table = qz.build_table(-1.0, 1.0, bits=bits,
                           mode="normal" if bits <= 8 else "uniform",
                           device=dev)
    before = sk.variant_launches("quantize_pack_ef")
    c1, d1 = sk.quantize_pack_ef(table, rows, carried, mask)
    assert variant_delta("quantize_pack_ef", before) == {
        sk.search_design(bits): 1}
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


def test_flash_attention_kernel_refuses_grads(dev):
    """The kernel has no backward: a bf16 call whose inputs require grad
    raises before any launch; under no_grad it runs, and its output is a
    constant to autograd."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 256, 2, 64), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    sk.reset_launches()
    for which in range(3):
        args = [q, k, v]
        args[which] = args[which].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="full_attention"):
            fl.flash_attention(*args, causal=True)
    assert sk.launches("flash_attention") == 0
    with torch.no_grad():
        out = fl.flash_attention(q.requires_grad_(True), k, v, causal=True)
    assert out.grad_fn is None and sk.launches("flash_attention") == 1


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


@pytest.mark.parametrize("d", [1, 32])
def test_lookup_backward_is_merge_rows_bit_for_bit(dev, d):
    """The gather's backward on the card launches merge_rows once and
    equals ``merge_rows_plain`` (slot-order sums) and the CPU's
    ``index_add_`` bit for bit, and itself across two calls; the ids carry
    the Criteo layout's long runs (a numeric field's id in every row)."""
    from lightctr_tpu_torch.embed.table import lookup

    rng = np.random.default_rng(d)
    rows = 1 << 16
    shape = (rows,) if d == 1 else (rows, d)
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ids = (rng.random((2048, 39)) ** 4 * rows).astype(np.int32)
    ids[:, 26:] = np.arange(26, 39)
    grad = torch.from_numpy(rng.normal(
        size=ids.shape + shape[1:]).astype(np.float32))
    got = []
    for _ in range(2):
        t = table.to(dev).requires_grad_()
        before = sk.launches("merge_rows")
        lookup(t, torch.from_numpy(ids).to(dev)).backward(grad.to(dev))
        assert sk.launches("merge_rows") == before + 1
        got.append(t.grad)
    assert torch.equal(got[0], got[1])
    m = ids.size
    plain = sk.merge_rows_plain(grad.to(dev).reshape(m, -1),
                                torch.from_numpy(ids).to(dev).reshape(-1),
                                rows).reshape(shape)
    assert torch.equal(got[0], plain)
    cpu = table.clone().requires_grad_()
    cpu.index_select(0, torch.from_numpy(ids).reshape(-1).long()) \
        .reshape(grad.shape).backward(grad)
    assert torch.equal(got[0].cpu(), cpu.grad)


def test_coded_hybrid_step_twice_is_bit_identical(dev, tmp_path):
    """One coded hybrid step (8 bits, measured range) over 2 gloo ranks
    on the card, run twice from the same state: every rank's tables and
    accumulators bit-identical across the two runs and across the ranks
    (the measured range follows the gradients, which now sum in slot
    order)."""
    import torch_dp_worlds

    from lightctr_tpu_torch.core.mesh import spawn_world

    spawn_world(torch_dp_worlds.repeat_step_rank, 2, "gloo", deadline_s=300,
                args=(str(tmp_path),))
    runs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]
    for rank_runs in runs:
        for k, v in rank_runs[0].items():
            np.testing.assert_array_equal(rank_runs[1][k], v, err_msg=k)
            np.testing.assert_array_equal(runs[0][0][k], v, err_msg=k)


def test_hier_step_twice_is_bit_identical(dev, tmp_path):
    """One step of the two-level exchange (a host of 2 gloo ranks on the
    card, the fp32 wire through reduce shards in this process) run twice
    from the same state: every rank's tables and accumulators
    bit-identical across the two runs and across the ranks."""
    import torch_hier_worlds

    from lightctr_tpu_torch.core.mesh import spawn_world
    from lightctr_tpu_torch.dist.hier import SparseReduceShard

    shards = [SparseReduceShard(n_hosts=1) for _ in range(2)]
    try:
        spawn_world(torch_hier_worlds.hier_repeat_step_rank, 2, "gloo",
                    deadline_s=300,
                    args=(str(tmp_path), [s.address for s in shards]))
    finally:
        for s in shards:
            s.close()
    runs = [torch.load(tmp_path / f"host0_rank{r}.pt", weights_only=False)
            for r in range(2)]
    for rank_runs in runs:
        for k, v in rank_runs[0].items():
            np.testing.assert_array_equal(rank_runs[1][k], v, err_msg=k)
            np.testing.assert_array_equal(runs[0][0][k], v, err_msg=k)


def test_prefetch_with_a_cuda_prepare_matches_the_synchronous_batches(dev):
    """``prefetch_batches`` with the dense trainer's staging (pinned host
    copies and a side stream) delivers, once claimed on the step's
    stream, tensors equal to the synchronous ``_put``; ``fit_stream``
    with prefetch trains bit-identically to the run without."""
    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.data import ingest

    p = fm.init(torch.Generator().manual_seed(0), 512, 8)
    cfg = TrainConfig(learning_rate=0.1, lambda_l2=0.001)

    def make():
        tr = CTRTrainer(p, fm.logits, cfg, fused_fn=fm.logits_with_l2,
                        device=dev)
        tr.health = None
        tr.telemetry = obs.MetricsRegistry()
        return tr

    tr = make()
    batches = [fm_batch(s, n=4096, nnz=39) for s in range(8)]
    staged = list(ingest.prefetch_batches(iter(batches), depth=2,
                                          prepare=tr._stage,
                                          registry=obs.MetricsRegistry()))
    for b, s in zip(batches, staged):
        assert s.ready is not None
        got = tr._claim(s)
        want = tr._put(b)
        for k in want:
            assert got[k].is_cuda and torch.equal(got[k], want[k]), k
    a, b = make(), make()
    la = a.fit_stream(iter(batches))
    lb = b.fit_stream(iter(batches), prefetch=2)
    assert la == lb
    for k in ("w", "v"):
        assert torch.equal(a.params[k], b.params[k])


# -- the Wide&Deep family ------------------------------------------------------


def family_batch(seed, n=64, f=512, fields=4, nnz=6):
    from lightctr_tpu_torch.models.widedeep import field_representatives

    rng = np.random.default_rng(seed)
    fids = rng.integers(0, f, size=(n, nnz)).astype(np.int32)
    fld = rng.integers(0, fields, size=(n, nnz)).astype(np.int32)
    mask = np.ones((n, nnz), np.float32)
    rep, rep_mask = field_representatives(fids, fld, mask, fields)
    return {"fids": fids, "vals": rng.uniform(0.5, 1.5, (n, nnz)).astype(
        np.float32), "mask": mask, "rep_fids": rep, "rep_mask": rep_mask,
        "labels": (rng.random(n) > 0.5).astype(np.float32)}


def family(kind):
    """(params, logits, logits_with_l2, sparse tables) of ``kind`` at
    vocab 512, 4 fields, D 8, hidden 16."""
    from lightctr_tpu_torch.models import deepfm, widedeep

    g = torch.Generator().manual_seed(0)
    if kind == "dcn":
        return (deepfm.dcn_init(g, 512, 4, 8, n_cross=2, hidden=16),
                deepfm.dcn_logits, deepfm.dcn_logits_with_l2,
                {"embed": ["rep_fids"]})
    p = widedeep.init(g, 512, 4, 8, hidden=16)
    tables = {"w": ["fids"], "embed": ["rep_fids"]}
    if kind == "widedeep":
        return p, widedeep.logits, None, tables
    return p, deepfm.logits, deepfm.logits_with_l2, tables


def flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["widedeep", "deepfm", "dcn"])
def test_family_trainers_on_card_match_cpu(dev, kind, fused):
    """Six full-batch steps of each kind on the card and on the CPU from
    one init: the sparse trainer launches a dedup, a lookup backward and an
    apply per table a step; the fused dense trainer a lookup backward per
    table and an Adagrad kernel per leaf.  Losses and every leaf agree
    (tanh on two devices: rtol 1e-4 / atol 1e-5)."""
    p, logits, fused_fn, tables = family(kind)
    cfg = TrainConfig(learning_rate=0.1, lambda_l2=0.001)
    kw = {} if fused_fn is None else {"fused_fn": fused_fn}

    def make(device):
        if fused:
            return CTRTrainer(p, logits, cfg, fused_adagrad=True,
                              device=device, **kw)
        return SparseTableCTRTrainer(p, logits, cfg, sparse_tables=tables,
                                     device=device, **kw)

    card, cpu = make(dev), make("cpu")
    card.health = cpu.health = None
    b = family_batch(1)
    sk.reset_launches()
    lc = card.fit_fullbatch_scan(b, 6)
    n = sk.launches()
    t = len(tables)
    if fused:
        assert n["fused_adagrad"] == 6 * len(flat_params(p))
        assert n["merge_rows"] == 6 * t
    else:
        assert (n["dedup_ids"], n["merge_rows"], n["merge_apply"]) == (
            6 * t, 6 * t, 6 * t)
    np.testing.assert_allclose(lc, cpu.fit_fullbatch_scan(b, 6), rtol=1e-4,
                               atol=1e-5)
    assert lc[-1] < lc[0]
    want = flat_params(cpu.params)
    for k, v in flat_params(card.params).items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=1e-4, atol=1e-5)


def test_family_sparse_step_twice_is_bit_identical(dev):
    """One DeepFM step of the sparse trainer, run twice from the same
    state on the card: tables, accumulators and the MLP bit-identical
    (the lookups' backward sums in slot order; the MLP's products are
    cuBLAS's, deterministic on one stream)."""
    p, logits, fused_fn, tables = family("deepfm")
    b = family_batch(2, n=256)
    out = []
    for _ in range(2):
        tr = SparseTableCTRTrainer(
            p, logits, TrainConfig(learning_rate=0.1, lambda_l2=0.001),
            sparse_tables=tables, fused_fn=fused_fn, device=dev)
        tr.health = None
        tr.train_step(b)
        out.append({**flat_params(tr.params),
                    **flat_params(tr.opt_state["accum"], "accum/")})
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k


@pytest.mark.parametrize("kind", ["widedeep", "deepfm", "dcn"])
def test_family_serving_on_card_matches_cpu(dev, kind, tmp_path):
    """A compressed artifact decoded on the card equals the CPU's decode bit
    for bit; local and PS-row-backed scores on the card agree with the
    CPU's."""
    from lightctr_tpu_torch import serve
    from lightctr_tpu_torch.models import export

    p, _, _, _ = family(kind)
    path = str(tmp_path / f"{kind}.npz")
    export.save_compressed_npz(path, p, model=kind, device="cpu")
    on_card, _ = export.load_compressed_npz(path, device=dev)
    on_cpu, _ = export.load_compressed_npz(path, device="cpu")
    want = flat_params(on_cpu)
    for k, v in flat_params(on_card).items():
        assert v.device.type == dev.type and torch.equal(v.cpu(), want[k]), k
    b = family_batch(3, n=20)
    card = serve.load_model(path, device=dev)
    cpu = serve.load_model(path, device="cpu")
    np.testing.assert_allclose(card.score(b), cpu.score(b), atol=1e-5)
    leaves = ({"embed": (1, 9, False)} if kind == "dcn"
              else serve.fm_ps_row_leaves(8, table_leaf="embed"))
    w = on_cpu.get("w", torch.zeros(512))
    rows = torch.cat([w[:, None], on_cpu["embed"]], dim=1)
    ps = serve.ServingModel(kind, {k: v for k, v in on_card.items()
                                   if k not in leaves},
                            row_leaves=leaves, row_dim=9, device=dev)
    uids = ps.touched_uids(b)
    got = ps.score_rows(b, uids, rows[torch.from_numpy(uids)].to(dev))
    np.testing.assert_allclose(got, cpu.score(b), atol=1e-5)


# -- DLRM-DCNv2 ----------------------------------------------------------------


def test_pooled_lookup_on_card_matches_cpu(dev):
    """The pooled bags at tests/test_torch_dlrm.py's small size on the card
    and on the CPU: each bag summed in slot order by one thread
    (``segment_reduce``), the table's gradient B4's slot-order merge,
    launched once and bit for bit the CPU's."""
    import test_torch_dlrm as small
    from lightctr_tpu_torch.embed import table as ttable

    gen = torch.Generator().manual_seed(3)
    t = torch.randn((sum(small.ROWS), small.DIM), generator=gen)
    ids = small.make_batch(4, n=128)["bag_ids"]
    g = torch.randn((128, len(small.BAGS), small.DIM), generator=gen)
    got = {}
    for d in (dev, torch.device("cpu")):
        leaf = t.to(d).requires_grad_(True)
        before = sk.launches("merge_rows")
        out = ttable.pooled_lookup(leaf, ids.to(d), ttable.Bags(small.BAGS))
        out.backward(g.to(d))
        if d.type == "cuda":
            assert sk.launches("merge_rows") == before + 1
        got[d.type] = (out.detach().cpu(), leaf.grad.cpu())
    torch.testing.assert_close(got["cuda"][0], got["cpu"][0], rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got["cuda"][1], got["cpu"][1])


def test_dlrm_card_step_matches_the_reference(dev):
    """One ``SparseTableCTRTrainer`` step of DLRM-DCNv2 on the card at
    tests/test_torch_dlrm.py's small size against the plain reference on
    the card (float32, TF32 off): B2, B4 and B5 launch once each, and the
    loss, every leaf's change and every accumulator agree within that
    file's tolerances."""
    import dlrm_reference as ref
    import test_torch_dlrm as small
    from lightctr_tpu_torch.models import dlrm

    params = small.make_params(6)
    batch = small.make_batch(40)
    tr = SparseTableCTRTrainer(
        small.nest(params), dlrm.make_logits(small.BAGS),
        TrainConfig(learning_rate=small.LR, lambda_l2=0.0),
        sparse_tables={"embed": ["bag_ids"]}, eps=1e-7, device=dev)
    tr.health = None
    sk.reset_launches()
    loss = float(tr.train_step(batch))
    n = sk.launches()
    assert (n["dedup_ids"], n["merge_rows"], n["merge_apply"]) == (1, 1, 1)
    on_card = {k: v.to(dev) for k, v in params.items()}
    want = ref.steps(on_card, [{k: v.to(dev) for k, v in batch.items()}],
                     small.BAGS, small.LR)
    assert abs(loss - want["losses"][0]) / abs(want["losses"][0]) \
        < small.REL
    got = small.flat(tr.params)
    accum = {"embed": tr.opt_state["accum"]["embed"],
             **small.flat(tr.opt_state["dense"].accum)}
    for k, p in on_card.items():
        assert small.rel(got[k] - p, want["params"][k] - p) \
            < small.STEP_REL, k
        assert small.rel(accum[k], want["accum"][k]) < small.STEP_REL, k


def test_pq_on_the_card_matches_cpu(dev):
    """The k-means loop from one set of initial centroids on the card and
    on the CPU (the distances and the one-hot M step are matrix products,
    never atomics), and encode/decode on one codebook, equal codes."""
    from lightctr_tpu_torch.ops import pq

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32))
    parts = pq._parts(x, 4)
    c0 = parts[:, :64, :].clone()
    got = pq._kmeans(parts.to(dev), c0.to(dev), 5)
    want = pq._kmeans(parts, c0, 5)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    book = pq.PQCodebook(centroids=want)
    codes = pq.encode(pq.PQCodebook(centroids=want.to(dev)), x.to(dev))
    assert torch.equal(codes.cpu(), pq.encode(book, x))
    assert torch.equal(pq.decode(pq.PQCodebook(centroids=want.to(dev)),
                                 codes).cpu(), pq.decode(book, codes.cpu()))
    again = pq.train(torch.Generator(device=dev).manual_seed(0), x.to(dev),
                     part_cnt=4, cluster_cnt=64, iters=3)
    assert torch.equal(again.centroids, pq.train(
        torch.Generator(device=dev).manual_seed(0), x.to(dev), part_cnt=4,
        cluster_cnt=64, iters=3).centroids)


def test_lookup_backward_on_ffms_3d_table_is_merge_rows_bit_for_bit(dev):
    """FFM's v is [V, 39, 8] at the Criteo layout: the gather's backward
    runs merge_rows on rows of 312 floats (float4 lanes), launched once,
    equal to ``merge_rows_plain`` and to the CPU's slot-order sums bit for
    bit, and to itself across two calls."""
    from lightctr_tpu_torch.embed.table import lookup

    rng = np.random.default_rng(5)
    rows, fields, k = 1 << 14, 39, 8
    table = torch.from_numpy(rng.normal(size=(rows, fields, k)).astype(
        np.float32))
    ids = (rng.random((512, fields)) ** 4 * rows).astype(np.int32)
    ids[:, 26:] = np.arange(26, 39)
    grad = torch.from_numpy(rng.normal(size=ids.shape + (fields, k)).astype(
        np.float32))
    got = []
    for _ in range(2):
        t = table.to(dev).requires_grad_()
        before = sk.launches("merge_rows")
        lookup(t, torch.from_numpy(ids).to(dev)).backward(grad.to(dev))
        assert sk.launches("merge_rows") == before + 1
        got.append(t.grad)
    assert torch.equal(got[0], got[1])
    plain = sk.merge_rows_plain(grad.to(dev).reshape(ids.size, -1),
                                torch.from_numpy(ids).to(dev).reshape(-1),
                                rows).reshape(table.shape)
    assert torch.equal(got[0], plain)
    cpu = table.clone().requires_grad_()
    lookup(cpu, torch.from_numpy(ids)).backward(grad)
    assert torch.equal(got[0].cpu(), cpu.grad)


def test_ffm_step_run_twice_is_bit_identical(dev):
    """One CTRTrainer step of FFM (39 fields, k 8, the gathers' backward
    on merge_rows) from one state, twice on the card: params and Adagrad
    state bit-identical; the loss within 1e-5 of the CPU's."""
    from lightctr_tpu_torch.models import ffm

    rng = np.random.default_rng(6)
    n, fields, vocab = 1024, 39, 4096
    fids = (rng.random((n, fields)) ** 4 * vocab).astype(np.int32)
    batch = {"fids": fids,
             "fields": np.tile(np.arange(fields, dtype=np.int32), (n, 1)),
             "vals": rng.uniform(0.5, 1.5, (n, fields)).astype(np.float32),
             "mask": np.ones((n, fields), np.float32),
             "labels": (rng.random(n) > 0.5).astype(np.float32)}
    p = ffm.init(torch.Generator().manual_seed(0), vocab, fields, 8)
    cfg = TrainConfig(learning_rate=0.1, lambda_l2=0.001)
    states, losses = [], []
    for device in (dev, dev, "cpu"):
        tr = CTRTrainer(p, ffm.logits, cfg, fused_fn=ffm.logits_with_l2,
                        device=device)
        tr.health = None
        losses.append(float(tr.train_step(batch)))
        states.append([t.cpu() for t in (tr.params["w"], tr.params["v"],
                                         tr.opt_state.accum["w"],
                                         tr.opt_state.accum["v"])])
    for a, b in zip(states[0], states[1]):
        assert torch.equal(a, b)
    assert losses[0] == losses[1]
    assert abs(losses[0] - losses[2]) <= 1e-5 * abs(losses[2])


def test_ckpt_round_trips_cuda_params_to_the_same_device(dev, tmp_path):
    """``ckpt.save`` of CUDA params and optimizer state writes CPU tensors;
    ``restore`` without a template puts each back on the card it came
    from, and with one on the template's device, bit for bit."""
    from lightctr_tpu_torch import ckpt
    from lightctr_tpu_torch.models import nfm

    p = nfm.init(torch.Generator(device=dev).manual_seed(0), 1000, 8, 16,
                 device=dev)
    tr = CTRTrainer(p, nfm.logits, TrainConfig(), device=dev)
    state = {"params": tr.params, "opt_state": tr.opt_state}
    ckpt.save(str(tmp_path), 1, state)
    saved = torch.load(tmp_path / "step_1" / "leaves.pt", weights_only=True)
    assert all(t.device.type == "cpu" for t in saved)
    for out in (ckpt.restore(str(tmp_path)),
                ckpt.restore(str(tmp_path), like=state)):
        assert type(out["opt_state"]) is type(tr.opt_state)
        for a, b in ((out["params"]["fc1"]["w"], p["fc1"]["w"]),
                     (out["params"]["v"], p["v"]),
                     (out["opt_state"].accum["v"],
                      tr.opt_state.accum["v"])):
            assert a.device == b.device and torch.equal(a, b)


def gbm_data(rows, feats, seed):
    """Templated rows with NaNs, a binary label: the GBM tests' data."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, feats)).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 3]) > 0).astype(
        np.float32)
    return x, y


def test_gbm_fit_twice_gives_bit_identical_trees(dev):
    """The histograms and leaf sums are merge_rows (slot-order sums), so a
    second fit on the card repeats every tree bit for bit; the first tree
    equals the CPU's (p = 1/2 exactly at the root)."""
    from lightctr_tpu_torch.models import gbm

    x, y = gbm_data(4000, 64, 0)
    cfg = gbm.GBMConfig(n_trees=4, max_depth=6)
    fits = []
    for _ in range(2):
        before = sk.launches("merge_rows")
        m = gbm.GBMModel(cfg, device="cuda")
        m.fit(x, y)
        assert sk.launches("merge_rows") - before == \
            4 * gbm.histogram_merges(6)
        fits.append(m)
    for a, b in zip(*(f.trees for f in fits)):
        for u, v in zip(a, b):
            assert torch.equal(u.view(torch.uint8) if u.dtype == torch.bool
                               else u, v.view(torch.uint8)
                               if v.dtype == torch.bool else v)
    cpu = gbm.GBMModel(gbm.GBMConfig(n_trees=1, max_depth=6), device="cpu")
    cpu.fit(x, y)
    for u, v in zip(fits[0].trees[0], cpu.trees[0]):
        assert torch.equal(u.cpu(), v)


def test_gbm_root_histograms_on_card_equal_cpu_bit_for_bit(dev):
    from lightctr_tpu_torch.models import gbm

    x, y = gbm_data(3000, 100, 1)
    bins, _ = gbm.quantile_bins(x, 32)
    rng = np.random.default_rng(2)
    g = rng.normal(size=len(y)).astype(np.float32)
    h = rng.random(len(y)).astype(np.float32)
    m = (rng.random(len(y)) < 0.7).astype(np.float32)
    args = [torch.from_numpy(a) for a in (bins, g, h, m)]
    want = gbm.root_histograms(*args, 32)
    got = gbm.root_histograms(*(a.cuda() for a in args), 32)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_merge_rows_at_the_gbm_root_histogram_shape(dev):
    """B4 at GBM's CLI shape: 10,000 x 784 slots (7.84 M) at d 1 into
    784 x 33 segments, bit for bit against its plain version."""
    rng = np.random.default_rng(3)
    n, f, slots = 10000, 784, 33
    bins = rng.integers(0, slots, (n, f))
    seg = torch.from_numpy((np.arange(f)[None, :] * slots + bins).reshape(-1)
                           .astype(np.int32)).cuda()
    stat = torch.from_numpy(rng.normal(size=n).astype(np.float32)).cuda()
    rows = stat[:, None].expand(n, f).reshape(-1, 1).contiguous()
    got = sk.merge_rows(rows, seg, f * slots)
    want = sk.merge_rows_plain(rows, seg, f * slots)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode", ["negative", "hierarchical"])
def test_word2vec_step_twice_is_bit_identical(dev, mode):
    """One step from one state, run twice: the tables and the Adagrad
    accumulators bit-identical (the gathers' backward is merge_rows)."""
    from lightctr_tpu_torch.models import embedding

    rng = np.random.default_rng(4)
    vocab, b = 5000, 256
    counts = (rng.zipf(1.3, vocab) % 100000 + 1).astype(np.int64)
    tr = embedding.Word2VecTrainer(vocab, 100, TrainConfig(learning_rate=0.3),
                                   counts, mode=mode, device="cuda")
    centers = torch.from_numpy((rng.random(b) ** 3 * vocab).astype(
        np.int32)).cuda()
    contexts = torch.from_numpy((rng.random((b, 12)) ** 3 * vocab).astype(
        np.int32)).cuda()
    mask = torch.ones((b, 12), device="cuda")
    tr.step(centers, contexts, mask)        # rows of out away from zero
    start = ([t.clone() for t in tr.params],
             [t.clone() for t in tr.opt_state.accum])
    gen_state = tr.generator.get_state()
    runs = []
    for _ in range(2):
        tr.params = type(tr.params)(*(t.clone() for t in start[0]))
        tr.opt_state = type(tr.opt_state)(
            accum=type(tr.params)(*(t.clone() for t in start[1])))
        tr.generator.set_state(gen_state)
        before = sk.launches("merge_rows")
        tr.step(centers, contexts, mask)
        assert sk.launches("merge_rows") - before == \
            embedding.GATHERS[mode]
        runs.append(list(tr.params) + list(tr.opt_state.accum))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_conv_ignores_a_global_tf32_setting(dev):
    """``nn.conv.apply`` runs cuDNN in float32 (TF32 off, deterministic
    algorithms) whatever ``torch.backends.cudnn.allow_tf32`` says: its
    forward and its gradients equal the float32 run's bit for bit."""
    from lightctr_tpu_torch.nn import conv

    gen = torch.Generator(device="cuda").manual_seed(5)
    params = conv.init(gen, 5, 16, 32, device="cuda")
    x = torch.randn((64, 28, 28, 16), generator=gen, device="cuda")
    saved = torch.backends.cudnn.allow_tf32
    outs = []
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            w = params["w"].detach().clone().requires_grad_()
            xi = x.clone().requires_grad_()
            y = conv.apply({"w": w, "b": params["b"]}, xi, stride=1)
            (y * y).sum().backward()
            outs.append((y.detach(), w.grad, xi.grad))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).double(),
        params["w"].permute(3, 2, 0, 1).double()).permute(0, 2, 3, 1)
    assert float((outs[0][0].double() - want).abs().max()) < 1e-4


# -- the quality sketch, the shard cache, ANN and the DAG builder ---------------


def test_quality_sketch_on_the_card_is_merge_rows_bit_for_bit(dev):
    """The sketch at the trainers' shape (4,096 probabilities, 512 bins):
    one merge_rows launch, equal bit for bit to the sketch through the
    plain version on the card, the same bits run to run, and the CPU's
    counts, label and probability sums bit for bit (its logloss sums
    within rtol 1e-6: the card's log may differ in the last place)."""
    from lightctr_tpu_torch.obs import quality

    gen = torch.Generator(device="cuda").manual_seed(3)
    p = torch.rand(4096, generator=gen, device="cuda")
    y = (torch.rand(4096, generator=gen, device="cuda") > 0.7).float()
    before = sk.launches("merge_rows")
    a = quality.quality_sketch(p, y, 512)
    assert sk.launches("merge_rows") == before + 1
    b = quality.quality_sketch(p, y, 512)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    pc = torch.clamp(p, 1e-7, 1 - 1e-7)
    ll = -(y * torch.log(pc) + (1 - y) * torch.log1p(-pc))
    idx = torch.clamp((p * 512).to(torch.int32), 0, 511)
    plain = sk.merge_rows_plain(
        torch.stack([torch.ones_like(p), y, p, ll], dim=1), idx, 512)
    assert torch.equal(a.view(torch.int32),
                       plain.t().reshape(-1).view(torch.int32))
    cpu = quality.quality_sketch(p.cpu(), y.cpu(), 512).reshape(4, 512)
    got = a.cpu().reshape(4, 512)
    assert torch.equal(got[:3].view(torch.int32), cpu[:3].view(torch.int32))
    torch.testing.assert_close(got[3], cpu[3], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_quality_armed_step_on_the_card_equals_unarmed(dev, kind):
    """Arming the sketch on the card trains nothing differently: losses
    and tables bit for bit; one more merge_rows launch a step; every
    example reaches the tracker."""
    p = fm.init(torch.Generator().manual_seed(0), 4096, 8)
    cfg = TrainConfig(learning_rate=0.05, lambda_l2=0.001)
    batches = [fm_batch(s, n=1024, f=4096, nnz=39) for s in range(4)]
    runs = []
    for qb in (None, 512):
        if kind == "sparse":
            tr = SparseTableCTRTrainer(
                p, fm.logits, cfg, sparse_tables={"w": ["fids"],
                                                  "v": ["fids"]},
                fused_fn=fm.logits_with_l2, quality_bins=qb, device=dev)
        else:
            tr = CTRTrainer(p, fm.logits, cfg, fused_fn=fm.logits_with_l2,
                            quality_bins=qb, device=dev)
        tr.health = None
        sk.reset_launches()
        losses = [float(tr.train_step(b)) for b in batches]
        tr.flush_health()
        runs.append((losses, tr.params, sk.launches("merge_rows"),
                     tr.quality))
    (l0, p0, m0, _), (l1, p1, m1, q1) = runs
    assert l0 == l1
    for k in ("w", "v"):
        assert torch.equal(p0[k], p1[k]), k
    assert m1 == m0 + len(batches)
    assert q1.total.count == 4 * 1024
    q1.close()


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_shard_cache_replay_under_prefetch_equals_the_live_parse(
        dev, kind, tmp_path):
    """A Criteo-proxy file compiled into the shard cache and replayed
    through ``fit_stream(iter_shard_batches(...), prefetch=2)`` trains on
    the card bit for bit as the live parse without prefetch."""
    from lightctr_tpu_torch.data import ingest, streaming, synth

    path = synth.write_criteo_proxy(str(tmp_path / "c.ffm"), 4096, seed=2,
                                    vocab=4096)
    cache = ingest.compile_shards(path, 39, feature_cnt=4096,
                                  block_rows=1536)
    p = fm.init(torch.Generator().manual_seed(0), 4096, 8)
    cfg = TrainConfig(learning_rate=0.05, lambda_l2=0.001)

    def make():
        if kind == "sparse":
            tr = SparseTableCTRTrainer(
                p, fm.logits, cfg, sparse_tables={"w": ["fids"],
                                                  "v": ["fids"]},
                fused_fn=fm.logits_with_l2, device=dev)
        else:
            tr = CTRTrainer(p, fm.logits, cfg, fused_fn=fm.logits_with_l2,
                            device=dev)
        tr.health = None
        return tr

    a, b = make(), make()
    la = a.fit_stream(streaming.iter_libffm_batches(
        path, 512, 39, feature_cnt=4096, native=True))
    lb = b.fit_stream(ingest.iter_shard_batches(cache, 512), prefetch=2)
    assert len(la) == 8 and la == lb
    for k in ("w", "v"):
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_ann_brute_force_topk_on_the_card_matches_cpu(dev, metric):
    """The card's top-10 of 2^16 rows x 32 for 64 queries: the CPU's set
    wherever the 10th and 11th float64 scores are apart by more than
    1e-4, scores within rtol 1e-5 / atol 1e-4."""
    from lightctr_tpu_torch.models import ann

    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(1 << 16, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    gi, gv = ann.brute_force_topk(q, corpus, 10, metric=metric, device=dev)
    ci, cv = ann.brute_force_topk(q, corpus, 10, metric=metric,
                                  device="cpu")
    np.testing.assert_allclose(gv, cv, rtol=1e-5, atol=1e-4)
    q64, c64 = q.astype(np.float64), corpus.astype(np.float64)
    s = q64 @ c64.T
    if metric == "l2":
        s = 2 * s - (q64 ** 2).sum(1)[:, None] - (c64 ** 2).sum(1)[None]
    srt = -np.sort(-s, axis=1)
    for r in range(64):
        if srt[r, 9] - srt[r, 10] > 1e-4:
            assert set(gi[r]) == set(ci[r]), r


def test_ann_index_on_the_card_matches_cpu(dev):
    """One forest, queried with its re-rank on the card and on the CPU:
    the same top-10."""
    from lightctr_tpu_torch.models import ann

    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(4096, 16)).astype(np.float32)
    idx = ann.ANNIndex(n_trees=4, leaf_size=32, seed=0, device=dev)
    idx.build(corpus)
    for qv in rng.normal(size=(8, 16)).astype(np.float32):
        g, gv = idx.query(qv, 10, search_budget=512)
        idx.device = torch.device("cpu")
        c, cv = idx.query(qv, 10, search_budget=512)
        idx.device = torch.device(dev)
        assert set(g.tolist()) == set(c.tolist())
        np.testing.assert_allclose(gv, cv, rtol=1e-5, atol=1e-5)


def test_dag_step_on_the_card_matches_cpu(dev):
    """The DAG builder's demo (sigma(w.x + b), logistic loss, SGD 0.5) for
    20 steps at batch 4,096 on the card and the CPU: losses within rtol
    1e-5."""
    from lightctr_tpu_torch import graph, optim

    rng = np.random.default_rng(6)
    x = rng.normal(size=(4096, 4)).astype(np.float32)
    y = (rng.random(4096) < 1 / (1 + np.exp(-x @ [1.0, -2.0, 0.5, 0.0]))
         ).astype(np.float32)
    runs = []
    for device in (dev, "cpu"):
        g = graph.Graph(device=device)
        xi = g.add_node(graph.source("x"))
        w = g.add_node(graph.trainable("w", torch.zeros(4)))
        b = g.add_node(graph.trainable("b", torch.zeros(())))
        z = g.add_node(graph.add(g.add_node(graph.matmul(xi, w)), b))
        p = g.add_node(graph.activation(z, "sigmoid"))
        loss = g.add_node(graph.logistic_loss_node(p, label_name="y"))
        step, st = g.compile_train_step(loss, optim.sgd(0.5))
        params = g.init_params()
        losses = []
        for _ in range(20):
            params, st, l = step(params, st, {"x": x, "y": y})
            losses.append(float(l))
        runs.append(losses)
    assert runs[0][-1] < runs[0][0]
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "fused", "sparse"])
def test_resources_and_device_planes_armed_on_the_card_equal_unarmed(
        dev, kind):
    """Both planes armed on the card (the compile tracker over the step's
    signatures, the program catalog recording the first step's cost and
    memory, the census, the donation binding) train nothing differently:
    losses, params and optimizer state bit for bit; the catalog saw the
    kernels of the path and the allocator's peak; one signature over the
    steps."""
    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.obs import device as obs_device
    from lightctr_tpu_torch.optim.updaters import tree_leaves

    p = fm.init(torch.Generator().manual_seed(0), 4096, 8)
    cfg = TrainConfig(learning_rate=0.05)
    batches = [fm_batch(s, n=1024, f=4096, nnz=39) for s in range(4)]
    runs = []
    for armed in (False, True):
        kw = dict(resources=armed, device_telemetry=armed, device=dev)
        if kind == "sparse":
            tr = SparseTableCTRTrainer(
                p, fm.logits, cfg, sparse_tables={"w": ["fids"],
                                                  "v": ["fids"]}, **kw)
        else:
            tr = CTRTrainer(p, fm.logits, cfg,
                            fused_adagrad=kind == "fused", **kw)
        with obs.override(True):
            losses = [float(tr.train_step(b)) for b in batches]
        runs.append((losses, tr))
    (l0, t0), (l1, t1) = runs
    assert l0 == l1
    for a, b in zip(tree_leaves((t0.params, t0.opt_state)),
                    tree_leaves((t1.params, t1.opt_state))):
        assert torch.equal(a, b)
    ana = t1.device_catalog.analyze()["trainer_step"]
    want = {"dense": {"merge_rows"}, "fused": {"merge_rows", "fused_adagrad"},
            "sparse": {"dedup_ids", "merge_apply", "merge_rows"}}[kind]
    assert want <= set(ana["kernels"])
    assert ana["memory"]["temp"] > 0 and ana["flops"] > 0
    assert t1.device_catalog.peak == obs_device.peak_spec(
        torch.cuda.get_device_name(dev))
    t1.resources.poll()
    assert t1.resources.snapshot()["fns"]["trainer_step"][
        "cache_entries"] == 1
    cen = t1.device_census.sample()
    state = sum(t.numel() * t.element_size()
                for t in tree_leaves((t1.params, t1.opt_state)))
    assert cen["tags"]["trainer_state"]["bytes"] == state
    assert cen["untagged_bytes"] >= 0
    for c in (t1.resources, t1.device_catalog, t1.device_census):
        c.close()


def test_verify_donation_on_b5_apply_on_the_card(dev):
    """B5's in-place apply keeps the storages it was handed (clean), a
    copying control is a miss."""
    from lightctr_tpu_torch import obs
    from lightctr_tpu_torch.obs import device as obs_device

    watch = obs_device.DonationWatch(registry=obs.MetricsRegistry(),
                                     register=False)

    def apply(table, accum, uids, g):
        return sk.merge_apply(table, accum, uids, g, lr=0.05, eps=1e-7)

    def copy(table, accum, uids, g):
        return apply(table.clone(), accum.clone(), uids, g)

    ok = obs_device.verify_donation("b5_ok", apply, donate_argnums=(0, 1),
                                    watch=watch, sample_every=1)
    bad = obs_device.verify_donation("b5_copy", copy, donate_argnums=(0, 1),
                                     watch=watch, sample_every=1)
    uids, _, _ = sk.dedup_ids(torch.randint(0, 1 << 16, (4096,),
                                            dtype=torch.int32, device=dev))
    g = torch.randn((4096, 32), device=dev)
    sk.reset_launches()
    with obs.override(True):
        for f in (ok, bad):
            f(torch.randn((1 << 16, 32), device=dev),
              torch.rand((1 << 16, 32), device=dev), uids, g)
    assert sk.launches("merge_apply") == 2
    progs = watch.snapshot()["programs"]
    assert progs["b5_ok"] == {"checks": 1, "misses": 0}
    assert progs["b5_copy"] == {"checks": 1, "misses": 1}


@pytest.mark.parametrize("kind", ["fm", "widedeep"])
def test_online_step_twice_is_bit_identical(dev, kind):
    """One online gradient step from the same PS rows and batch, run
    twice on the card, gives the same loss and the same pushed rows bit
    for bit (the lookups' backward is merge_rows in slot order)."""
    from lightctr_tpu_torch import obs, online
    from lightctr_tpu_torch.models import widedeep

    f, k, fl = 1 << 14, 32, 39
    rng = np.random.default_rng(3)
    rows = (rng.normal(size=(f, 1 + k)) * 0.1).astype(np.float32)
    fids = (rng.random((512, fl)) ** 3 * f).astype(np.int32)
    mb = {"fids": fids, "fields": np.tile(np.arange(fl, dtype=np.int32),
                                          (512, 1)),
          "vals": np.ones((512, fl), np.float32),
          "mask": np.ones((512, fl), np.float32),
          "labels": (rng.random(512) > .5).astype(np.float32)}

    class _PS:
        def __init__(self):
            self.pushed = []

        def pull_arrays(self, keys, worker_epoch, worker_id=None):
            return keys, rows[keys]

        def push_arrays(self, worker_id, keys, g, worker_epoch):
            self.pushed.append(np.array(g))
            return True

    outs = []
    for _ in range(2):
        ps = _PS()
        kw = {}
        if kind == "widedeep":
            p = widedeep.init(torch.Generator().manual_seed(1), 8, fl, k)
            kw = dict(field_cnt=fl,
                      dense_params={n: p[n] for n in ("fc1", "fc2")})
        tr = online.OnlineTrainer(ps, kind, k, registry=obs.MetricsRegistry(),
                                  device=dev, **kw)
        sk.reset_launches()
        loss = tr.step(mb)
        assert sk.launches("merge_rows") == 2  # the w and table lookups
        outs.append((loss, ps.pushed[0]))
    assert outs[0][0] == outs[1][0]
    assert np.array_equal(outs[0][1], outs[1][1])


# -- the tiered store's hot pair on the card -----------------------------------


def _zipf_stream(vocab, batch, steps, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab).astype(np.int64)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** 1.1
    p /= p.sum()
    return [perm[rng.choice(vocab, size=batch, p=p)] for _ in range(steps)]


def _tiered_cycle(store, ids, step, target):
    rows = store.pull_batch(ids, worker_epoch=step, worker_id=0)
    uniq, first = np.unique(ids, return_index=True)
    store.push_batch(0, uniq, (0.1 * (rows[first] - target[uniq])).astype(
        np.float32), worker_epoch=step)
    return rows


def test_tiered_device_mode_on_card_matches_numpy_mode(dev, tmp_path):
    """The hot pair on the card (B3 reads it, the scatter and the
    updater's ops write it in place) follows the numpy-mode store bit for
    bit below 4,096 slots a push, where both take numpy's expression:
    pulled rows, the state snapshot, and a migration's read-back."""
    from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore

    dim, vocab = 33, 1 << 14
    rng = np.random.default_rng(5)
    target = (0.5 * rng.normal(size=(vocab, dim))).astype(np.float32)
    a = TieredEmbeddingStore(dim, 256, path=str(tmp_path / "np" / "s"),
                             device_hot=False)
    b = TieredEmbeddingStore(dim, 256, path=str(tmp_path / "dev" / "s"),
                             device="cuda")
    assert b.device_tables()[0].is_cuda
    before = sk.launches("gather_rows")
    for step, ids in enumerate(_zipf_stream(vocab, 2048, 20, seed=11)):
        assert len(np.unique(ids)) < 4096
        np.testing.assert_array_equal(_tiered_cycle(a, ids, step, target),
                                      _tiered_cycle(b, ids, step, target))
    assert sk.launches("gather_rows") > before
    sa, sb = a.snapshot_state_arrays(), b.snapshot_state_arrays()
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)
    c = TieredEmbeddingStore(dim, 256, path=str(tmp_path / "dst" / "s"),
                             device="cuda")
    mr, ma = c.migrate_in_state(*sb)
    np.testing.assert_array_equal(mr, sb[1])
    np.testing.assert_array_equal(ma, sb[2])
    for s in (a, b, c):
        s.close()


def test_tiered_fast_path_on_card_is_merge_apply_bit_for_bit(dev, tmp_path):
    """``TieredDeviceEmbedding`` all-hot on the card: each step's rows are
    B3 off the pair and its apply one B5 launch in place on it, equal bit
    for bit to B5 on a dense table given the same uids, rows and inv."""
    from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore
    from lightctr_tpu_torch.models.sparse_trainer import TieredDeviceEmbedding

    dim, vocab = 33, 1 << 12
    store = TieredEmbeddingStore(dim, 1024, path=str(tmp_path / "f" / "s"),
                                 prefetch=False, device="cuda")
    emb = TieredDeviceEmbedding(store, denom=2.0)
    rng = np.random.default_rng(0)
    keys = np.arange(1, 513, dtype=np.int64)
    emb.gather(keys)
    rows0, _, known = store.pull_state_batch(keys)
    assert known.all() and (store.hot_slots(keys) == 0).any()
    W = torch.zeros((vocab, dim), dtype=torch.float32, device=dev)
    A = torch.zeros_like(W)
    W[torch.from_numpy(keys).to(dev)] = torch.from_numpy(rows0).to(dev)
    for step in range(10):
        ids = rng.choice(keys, size=4096)
        rows_u, inv, tk = emb.gather(ids)
        uq, inv_np = np.unique(ids, return_inverse=True)
        uq_t = torch.from_numpy(uq).to(dev)
        assert torch.equal(rows_u, W[uq_t])
        g = torch.from_numpy(rng.normal(size=(4096, dim)).astype(
            np.float32)).to(dev)
        before = sk.launches("merge_apply")
        emb.apply(tk, g)
        assert sk.launches("merge_apply") == before + 1
        uids_p = np.zeros(sk.next_pow2(len(uq)), np.int32)
        uids_p[:len(uq)] = uq
        sk.merge_apply(W, A, torch.from_numpy(uids_p).to(dev), g,
                       torch.from_numpy(inv_np.astype(np.int32)).to(dev),
                       lr=store.lr, eps=store.eps, denom=2.0)
        got, accs, _ = store.pull_state_batch(keys)
        k_t = torch.from_numpy(keys).to(dev)
        np.testing.assert_array_equal(got, W[k_t].cpu().numpy())
        np.testing.assert_array_equal(accs, A[k_t].cpu().numpy())
    assert emb.fast_steps == 10
    store.close()


def test_tiered_store_defaults_to_cuda_and_raises_without_it(dev):
    """The default store's pair lives on the card; with no card visible
    the same call raises instead of falling back to the CPU."""
    import subprocess
    import sys

    from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore

    s = TieredEmbeddingStore(dim=4, hot_rows=8)
    assert s.device.type == "cuda" and s.device_tables()[0].is_cuda
    s.close()
    code = ("from lightctr_tpu_torch.embed.tiered import "
            "TieredEmbeddingStore\n"
            "try:\n    TieredEmbeddingStore(dim=4, hot_rows=8)\n"
            "except RuntimeError as e:\n    print('raised', e)\n")
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.stdout.startswith("raised"), proc.stdout + proc.stderr


# -- parameters sharded over ranks ------------------------------------------


def test_sharded_lookup_on_the_card_matches_the_cpu(dev):
    """A sharded table's pull and its block gradient on the card (an embed
    axis of one rank: the dedup, the routed exchange, the owner's gather,
    the slot-order merge into the block) equal the CPU's plain versions
    bit for bit, with one launch each of B2, B3 and B4."""
    from lightctr_tpu_torch.core.mesh import Mesh
    from lightctr_tpu_torch.embed import table as ttable

    rng = np.random.default_rng(7)
    full = rng.normal(size=(4096, 32)).astype(np.float32)
    ids = (rng.random((256, 39)) ** 4 * 4096).astype(np.int32)
    ids[:, :3] = 0
    w = rng.normal(size=ids.shape + (32,)).astype(np.float32)
    got = {}
    for d in (dev, torch.device("cpu")):
        mesh = Mesh(group=None, rank=0, device=d, axis="embed")
        t = ttable.shard_rows(full, mesh)
        leaf = t.local.clone().requires_grad_(True)
        names = ("dedup_ids", "gather_rows", "merge_rows")
        before = {k: sk.launches(k) for k in names}
        out = ttable.lookup(t.with_local(leaf), torch.from_numpy(ids).to(d))
        (out * torch.from_numpy(w).to(d)).sum().backward()
        if d.type == "cuda":
            assert {k: sk.launches(k) - before[k] for k in names} == \
                dict.fromkeys(names, 1)
        got[d.type] = (out.detach().cpu(), leaf.grad.cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0])
    assert torch.equal(got["cuda"][0], torch.from_numpy(full[ids]))
    assert torch.equal(got["cuda"][1], got["cpu"][1])


def test_merge_rows_at_local_indices_drops_the_foreign_ids(dev):
    """B4 as the sharded lookup's backward: slot rows merged into a block
    at ``id - offset``, half the ids another block's (negative, or at and
    past the block's end), bit for bit the plain version on the card and
    on the CPU."""
    rng = np.random.default_rng(8)
    rows_n, block, d = 39936, 1 << 16, 32
    ids = (rng.random(rows_n) ** 4 * 4 * block).astype(np.int32)
    seg = torch.from_numpy(ids - block)
    assert bool((seg < 0).any()) and bool((seg >= block).any())
    rows = torch.from_numpy(rng.normal(size=(rows_n, d)).astype(np.float32))
    before = sk.launches("merge_rows")
    got = sk.merge_rows(rows.to(dev), seg.to(dev), block)
    assert sk.launches("merge_rows") == before + 1
    want = sk.merge_rows_plain(rows.to(dev), seg.to(dev), block)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    cpu = sk.merge_rows_plain(rows, seg, block)
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


# -- train_step's staged put ---------------------------------------------------


def staged_trainer(kind, dev):
    """A sparse trainer of ``kind`` (FM, Wide&Deep or DLRM shaped) at a
    small vocabulary, its health feed off and a registry of its own."""
    from lightctr_tpu_torch import obs

    cfg = TrainConfig(learning_rate=0.05, lambda_l2=0.001)
    if kind == "fm":
        tr = SparseTableCTRTrainer(
            fm.init(torch.Generator().manual_seed(0), 512, 8), fm.logits,
            cfg, sparse_tables={"w": ["fids"], "v": ["fids"]},
            fused_fn=fm.logits_with_l2, device=dev)
    elif kind == "widedeep":
        p, logits, _, tables = family("widedeep")
        tr = SparseTableCTRTrainer(p, logits, cfg, sparse_tables=tables,
                                   device=dev)
    else:
        import test_torch_dlrm as small
        from lightctr_tpu_torch.models import dlrm

        tr = SparseTableCTRTrainer(
            small.nest(small.make_params(6)), dlrm.make_logits(small.BAGS),
            TrainConfig(learning_rate=small.LR, lambda_l2=0.0),
            sparse_tables={"embed": ["bag_ids"]}, eps=1e-7, device=dev)
    tr.health = None
    tr.telemetry = obs.MetricsRegistry()
    return tr


def staged_batch(kind, seed, n=None):
    """FM's numpy batch of 39 ids a row, Wide&Deep's, or DLRM's CPU
    tensors (214 bag ids a row)."""
    if kind == "fm":
        return fm_batch(seed, n=n or 4096, nnz=39)
    if kind == "widedeep":
        return family_batch(seed, n=n or 2048)
    import test_torch_dlrm as small

    return small.make_batch(seed, n=n or 256)


def run_steps(tr, batches, overwrite=False):
    """``train_step`` over ``batches``, the losses read once at the end;
    with ``overwrite`` each batch's arrays are zeroed as soon as its step
    returns."""
    losses = []
    for b in batches:
        losses.append(tr.train_step(b))
        if overwrite:
            for v in b.values():
                v[...] = 0
    return torch.stack(losses)


def assert_same_state(a, b):
    from lightctr_tpu_torch.optim.updaters import tree_leaves

    got = tree_leaves(a.params) + tree_leaves(a.opt_state)
    want = tree_leaves(b.params) + tree_leaves(b.opt_state)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def stage_counts(tr):
    c = tr.telemetry.snapshot()["counters"]
    return (c.get("trainer_input_staged_total", 0),
            c.get("trainer_input_stage_allocs_total", 0))


def pageable(tr):
    """``tr`` with train_step's put the plain pageable copy."""
    tr._put_staged = tr._put_whole
    return tr


@pytest.mark.parametrize("overwrite", [False, True])
@pytest.mark.parametrize("kind", ["fm", "widedeep", "dlrm"])
def test_staged_put_trains_as_the_pageable_put_bit_for_bit(dev, kind,
                                                           overwrite):
    """20 steps whose batches go through the staging ring against the same
    steps with the pageable put: losses, parameters and accumulators bit
    for bit.  With ``overwrite`` the caller zeroes each batch as soon as
    ``train_step`` returns, which the step must not see.  Every batch was
    staged, through two slots made once: pinned host buffers, device
    buffers on the card."""
    staged = staged_trainer(kind, dev)
    plain = pageable(staged_trainer(kind, dev))
    got = run_steps(staged, [staged_batch(kind, s) for s in range(20)],
                    overwrite)
    want = run_steps(plain, [staged_batch(kind, s) for s in range(20)])
    assert torch.equal(got, want)
    assert_same_state(staged, plain)
    assert stage_counts(staged) == (20, 2)
    assert stage_counts(plain) == (0, 0)
    for slot in staged._staging._slots:
        assert all(t.is_pinned() for t in slot.host.values())
        assert all(t.is_cuda for t in slot.dev.values())


def test_staged_put_makes_one_slot_anew_for_a_shorter_last_batch(dev):
    """Six full batches, then a shorter one (the last of an epoch): the
    slot it takes is made anew, the other kept, and the steps stay the
    pageable put's bit for bit."""
    sizes = [4096] * 6 + [1000]
    staged = staged_trainer("fm", dev)
    plain = pageable(staged_trainer("fm", dev))
    got = run_steps(staged, [staged_batch("fm", s, n)
                             for s, n in enumerate(sizes)])
    want = run_steps(plain, [staged_batch("fm", s, n)
                             for s, n in enumerate(sizes)])
    assert torch.equal(got, want)
    assert_same_state(staged, plain)
    assert stage_counts(staged) == (7, 3)
    shapes = [s.host["labels"].shape[0] for s in staged._staging._slots]
    assert shapes == [1000, 4096]


SLEEP_CYCLES = 200_000_000  # about 0.1 s of the card's clock


def test_staged_put_keeps_the_host_at_most_one_step_ahead(dev):
    """Each step sleeps about 0.1 s on the card.  When ``train_step`` k
    returns, step k - 2 has finished (its put waited on that slot's free
    event) and step k - 1 has not (the put did not wait for it): the host
    runs one step ahead of the card's running step, and no further."""
    def slow_logits(params, batch):
        torch.cuda._sleep(SLEEP_CYCLES)
        return fm.logits(params, batch)

    tr = CTRTrainer(fm.init(torch.Generator().manual_seed(0), 512, 8),
                    slow_logits, TrainConfig(learning_rate=0.05), device=dev)
    tr.health = None
    done = []
    for k in range(6):
        tr.train_step(staged_batch("fm", k))
        if k >= 2:
            assert done[k - 2].query(), k
            assert not done[k - 1].query(), k
        ev = torch.cuda.Event()
        ev.record()
        done.append(ev)
    torch.cuda.synchronize()
