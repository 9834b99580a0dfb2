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
