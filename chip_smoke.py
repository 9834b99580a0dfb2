#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lightctr_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``lightctr_tpu_torch/csrc``,
holds each against its plain PyTorch version, serves FM at Criteo width
through the PS-backed ``PredictionServer`` and checks the scores, trains FM
at Criteo width with ``SparseTableCTRTrainer`` and
``CTRTrainer(fused_adagrad=True)``, then trains it data-parallel over two
ranks on the one card, and checks the training; runs the long-context
attention path (flash attention on one card, ring attention over two
ranks) and the port's two kernel benches.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

  build    nvcc of every kernel source, nine (all started together),
           beside the g++ build of the native host codecs; seconds and
           ptxas summary.
  kernels  every kernel against its plain version on the card:
           gather_rows bit-exact (``torch.equal``) over d in {1, 33, 128}
           x n in {1, 1000, 16384} and the serve path's own shape,
           R = 65536, with negative and >= R indices that exercise the
           clip; dedup_ids bit-exact (uids, inv, count) at K in {1, 1000,
           159744} on Criteo id streams, negative ids and int32's limits,
           all-equal and all-zero streams, ids that differ only in the
           lowest digit or only in the sign bit, and with size < count, and
           on int64 streams across int64's range and ids that differ only
           above bit 40; merge_apply within 2 ulp
           (table, accum) and rtol 1e-5 (sumsq) at V = 2^20, d in {1, 32},
           S = 159744, uids of a real dedup with and without id 0, denom in
           {1, 4}, and in merge mode on 159,744 gathered rows, raw and as
           the dp path gathers them with the coded runs' non-zero padding
           rows (one launch of its fused ``merge`` design, none of
           merge_rows); merge_rows bit-exact at 159,744 rows, d in {1,
           32}, with heavy duplicates and out-of-range segments, with
           segments whose rows are all +-0, and at nseg = 2^24 + 77 (all
           four radix digits move); quantize_pack bit-exact on the
           [79872, 32] payload at 4, 8 (uniform, normal, fixed and measured
           range) and 16 bits with +-inf and NaN; quantize_pack_ef_update
           bit-exact (codes, dec, residual) on a real dedup's uids with id 0
           at 8 and 16 bits; fused_adagrad within 2 ulp at N in {1, 1001,
           2^20, 2^25} and at a misaligned start; quantize_pack_ef
           bit-exact (codes, delta) on the [79872, 32] payload at 8 and 16
           bits with +-inf and NaN, masked and unmasked rows, a [P, 1] and
           a [P, d] mask; flash_attention at the bench's causal bf16 shapes
           (4, 1024, 8, 64), (2, 4096, 8, 64), (1, 8192, 8, 64), at bf16
           heads of 128, 256 and 320 causal and not, and at B*H = 65,600
           (max abs error <= 2e-2, mean <= 2e-3), at (2, 256, 4, 32) and the
           graft entry's (2, 32, 2, 8) in fp32, causal and not (rtol 2e-4,
           atol 2e-5); each case through the design ``flash_route`` names.
  serve    FM, 39 fields (26 categorical + 13 numeric), vocabulary 2^20,
           factor dim 32: a port ``AsyncParamServer`` (rows ``[w | v]`` of
           width 33) behind ``ParamServerService``, a ``PredictionServer``
           on the card with its default 65536-row cache, 8 requests of 256
           rows sent twice through ``PredictClient``.  Every reply must be
           OK, scores within 2e-3 of a float64 numpy FM forward (the wire
           carries rows, values and scores in fp16), the cache block a
           CUDA tensor, hits > 0 on the second pass, and ``gather_rows``
           launched at least once per scored micro-batch.

  train    FM at Criteo width on synthetic Criteo batches made in memory
           (data/synth.py's recipe: u^4 head/tail ids, exponential numeric
           values, a planted logistic label), batch 4096, lr 0.05,
           lambda_l2 0.001, ``fm.logits_with_l2``.  (a) 50 steps of
           ``SparseTableCTRTrainer`` (204,800 rows): dedup_ids launched
           once a step and merge_apply twice, the last 5 losses below the
           first 5, held-out AUC > 0.55 on 20,480 rows; (b) 10 steps of
           ``CTRTrainer(fused_adagrad=True)``: fused_adagrad launched twice
           a step, the loss falling; (c) the first 3 sparse and 2 fused
           steps re-run on the CPU with the plain versions (losses rtol
           1e-4, touched rows rtol 1e-4 / atol 1e-5), and the two trainers
           on the card agreeing after 10 steps from one init.  Launch
           counts are reset just before (a) and (b) and read just after.
           Steady-state examples/s (after 3 warm-up steps, synchronised)
           and a profiler window of the sparse step's device time.
  dp       the same model, data and global batch trained by
           ``SparseTableCTRTrainer(mesh=...)`` over 2 ranks, spawned
           processes sharing the card over gloo (2048 rows, 79,872 ids a
           rank), through the hybrid sparse exchange: (a) exact, 50 steps,
           held-out AUC > 0.55; (b) 8 bits with a measured range, 10 steps;
           (c) 8 bits with its defaults (range 1.0, error feedback), 10
           steps.  Per rank and step: dedup_ids and merge_apply launched
           twice each (every merge_apply launch its fused merge mode, and
           no merge_rows launch), quantize_pack twice in (b),
           quantize_pack_ef_update twice in (c) (counts reset in each rank
           just before its steps).  Both ranks end bit-identical; the loss
           falls in every run; (b) ends within 0.05 of (a) at the same
           step.  The same runs on the CPU with the plain versions (the
           first 2 steps of (a), all of (b) and (c)): losses within rtol
           1e-4 ((a)) or 1e-3 ((b), (c)), the rows the first 2 batches
           touched within rtol 1e-4 / atol 1e-5 (a code flip may move a
           few of them in (b) and (c)).  One step of (c) at W = 1 over
           NCCL.  Steady-state examples/s of (a) with the health feed off,
           set by gloo's host staging, and rank 0's device time over 5
           more steps (torch.profiler) for the card's idle share.

  attention  the long-context path, counts reset just before it:
           ``flash_attention`` at (2, 4096, 8, 64) bf16 causal on the card,
           then ``ring_self_attention`` over a ``seq`` ring of 2 ranks
           spawned on the same card (gloo, host-staged) on the same inputs.
           Both ranks return the same tensor, within the bf16 tolerance
           above of the flash output; flash_attention launched, through its
           wgmma design, and refusing bf16 inputs that require grad (it
           has no backward).  The ring's backward on every rank: the
           gradients of sum(out ** 2) at (2, 64, 2, 16) float32 causal
           within rtol 1e-3 / atol 1e-4 of full attention's autograd.
           Ring step time and a profile of two more calls on rank 0.
  bench    counts reset, then ``lightctr_tpu_torch.tools.
           sparse_kernel_bench.run`` and ``tools.kernel_bench.run`` (no
           file written): every cell's kernel launched (merge_rows,
           quantize_pack_ef and flash_attention included; merge_apply in its
           fused merge mode); their cells are printed.

Then a ``{"kernels": [...]}`` line: each kernel at its main path's shape,
its launches on that path, its device time (``ms``, CUDA graph of
back-to-back calls), the plain version's, one PyTorch library call's where
one computes the same function (the yardstick; the port never calls it),
the eager per-call time with the host (``call_ms``) and the bound: bytes
at 3.35 TB/s, or for flash_attention the larger of that and its FLOPs at
989 TFLOP/s (its ``per_shape`` adds the path shape non-causal and
(2, 4096, 8, 128) causal, each beside SDPA; merge_rows' ``per_shape`` and
merge_apply's ``merge_mode`` give d = 32 and d = 1, the merge mode each
with the exact exchange's zero padding rows and the coded ones' non-zero
rows; merge_apply's apply mode and quantize_pack_ef_update add
``cold_ms``, each call after a read that empties the L2, at d = 1 and
d = 32).  Then the ``nvidia-smi`` name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and exits
non-zero; without CUDA, or without the ``lightctr_tpu_torch`` package beside
this file, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_FIELDS = 39
N_CAT = 26
VOCAB = 1 << 20
DIM = 32
ROW_DIM = 1 + DIM
N_REQUESTS = 8
REQUEST_ROWS = 256
PRELOAD_CHUNK = 1 << 18
CACHE_ROWS = 65536          # PredictionServer's default cache_capacity
SCORE_ATOL = 2e-3           # fp16 wire (tests/test_serve.py uses the same)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet

#: kernel shapes held against the plain version (plus the serve path's n)
KERNEL_DS = (1, 33, 128)
KERNEL_NS = (1, 1000, 16384)

# -- the train phase: tools/criteo_scale.py's constants --
TRAIN_BATCH = 4096
TRAIN_K = TRAIN_BATCH * N_FIELDS   # ids deduped per step: 159,744
SPARSE_STEPS = 50                  # 204,800 rows, criteo_scale's pass
FUSED_STEPS = 10
EVAL_ROWS = 20480
LR = 0.05
LAMBDA_L2 = 0.001
EPS = 1e-7
WARMUP_STEPS = 3
CPU_SPARSE_STEPS = 3               # re-run on the CPU with plain versions
CPU_FUSED_STEPS = 2
PARITY_STEPS = 10                  # sparse vs fused trainer on the card
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
MIN_AUC = 0.55                     # tools/criteo_scale.py's gate
MAX_ULP = 2                        # the Adagrad apply's bound (ROADMAP B.5)
DEDUP_KS = (1, 1000, TRAIN_K)
ADAGRAD_NS = (1, 1001, 1 << 20, 1 << 25)

# -- attention: the JAX bench's causal bf16 shapes [B, T, H, D] --
FLASH_BENCH_SHAPES = ((4, 1024, 8, 64), (2, 4096, 8, 64), (1, 8192, 8, 64))
FLASH_PATH_SHAPE = (2, 4096, 8, 64)     # the attention phase's
FLASH_F32_SHAPES = ((2, 256, 4, 32), (2, 32, 2, 8))  # the last: graft entry
# wide heads (bf16, causal and not) and B*H past gridDim.y's 65,535
FLASH_WIDE_SHAPES = ((2, 1024, 8, 128), (2, 1024, 4, 256), (1, 1024, 4, 320))
FLASH_MANY_HEADS_SHAPE = (32800, 16, 2, 64)
# timed beside the path shape: (shape, causal)
FLASH_EXTRA_TIMED = (((2, 4096, 8, 64), False), ((2, 4096, 8, 128), True))
FLASH_16_MAX, FLASH_16_MEAN = 2e-2, 2e-3  # a few bf16 ulps at |o| < 2
FLASH_F32_RTOL, FLASH_F32_ATOL = 2e-4, 2e-5  # the JAX flash test's
RING_WORLD = 2
# the ring's backward against full attention's autograd, float32 causal
# (tests/test_ring_attention.py::test_ring_grad_flows' tolerance)
RING_GRAD_SHAPE = (2, 64, 2, 16)
RING_GRAD_RTOL, RING_GRAD_ATOL = 1e-3, 1e-4
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16, NVIDIA's data sheet

# -- the dp phase: the same model and global batch over DP_WORLD ranks --
DP_WORLD = 2
DP_LOCAL_ROWS = TRAIN_BATCH // DP_WORLD
DP_LOCAL_K = DP_LOCAL_ROWS * N_FIELDS  # ids one rank dedups a step: 79,872


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# -- phase: build -------------------------------------------------------------


def phase_build(sk, bindings) -> dict:
    t0 = time.perf_counter()
    native = {}

    def build_native():
        native["ok"] = bindings.available()

    th = threading.Thread(target=build_native)
    th.start()
    paths = sk.build_all()
    th.join()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, log in sk.BUILD_LOGS.items()}
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "kernels": {n: os.path.relpath(p, REPO) for n, p in paths.items()},
            "native_host_codecs": bool(native.get("ok")), "ptxas": ptxas}


# -- phase: kernels -----------------------------------------------------------


def gather_inputs(torch, rows, d, n, gen, idx_dtype=None):
    """A [rows, d] fp32 block and n indices, a third of them outside
    [0, rows) and the first ones at the clip's edges."""
    idx_dtype = idx_dtype or torch.int32
    block = torch.randn((rows, d), generator=gen, device="cuda")
    idx = torch.randint(-rows // 4, rows + rows // 4, (n,), generator=gen,
                        device="cuda", dtype=torch.int64)
    edges = [-1, rows, -(1 << 31), (1 << 31) - 1, rows - 1, 0]
    if idx_dtype == torch.int64:
        edges += [(1 << 32) + 5, -(1 << 33)]   # wrap in the int32 cast
    m = min(n, len(edges))
    idx[:m] = torch.tensor(edges[:m], dtype=torch.int64)
    return block, idx.to(idx_dtype)


def phase_kernels(torch, sk, serve_ns) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [(d, n, torch.int32) for d in KERNEL_DS
             for n in sorted(set(KERNEL_NS) | set(serve_ns))]
    cases.append((ROW_DIM, 1000, torch.int64))
    max_err = 0.0
    checked = []
    for d, n, idt in cases:
        block, idx = gather_inputs(torch, CACHE_ROWS, d, n, gen, idt)
        got = sk.gather_rows(block, idx)
        torch.cuda.synchronize()
        want = sk.gather_rows_plain(block, idx)
        if not torch.equal(got, want):
            raise AssertionError(
                f"gather_rows kernel != plain at d={d} n={n} idx={idt}")
        max_err = max(max_err, float((got - want).abs().max()))
        checked.append([d, n, str(idt).replace("torch.", "")])
    return {"phase": "kernels", "gather_rows": {
        "bit_exact": True, "max_abs_err": max_err, "rows": CACHE_ROWS,
        "cases": checked}}


def ulp_diff(torch, a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors (0 where they are bit-identical)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(1 << 31) - i, i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def criteo_fids(np, rng, rows):
    """[rows, 39] int32 ids of the Criteo layout (data/synth.py): ids
    ~ u^4 * vocab in the 26 categorical fields, one fixed id per numeric
    field."""
    fids = (rng.random((rows, N_FIELDS)) ** 4 * VOCAB).astype(np.int32)
    fids[:, N_CAT:] = np.arange(N_CAT, N_FIELDS, dtype=np.int32)
    return fids


def dedup_streams(np, rng) -> dict:
    """name -> int32 id stream: Criteo ids, random ids with negatives and
    int32's limits, all-equal and all-zero, ids that differ only in the
    lowest 8-bit digit or only in the sign bit, at each K in DEDUP_KS."""
    out = {}
    for k in DEDUP_KS:
        rows = -(-k // N_FIELDS)
        out[f"criteo_k{k}"] = criteo_fids(np, rng, rows).reshape(-1)[:k]
        edge = rng.integers(-(1 << 31), 1 << 31, size=k, dtype=np.int64)
        lim = [-(1 << 31), (1 << 31) - 1, -1, 0, -(1 << 31), (1 << 31) - 1]
        edge[:min(k, len(lim))] = lim[:k]
        out[f"edges_k{k}"] = edge.astype(np.int32)
        out[f"all_equal_k{k}"] = np.full(k, -7, np.int32)
        out[f"all_zero_k{k}"] = np.zeros(k, np.int32)
        out[f"low_digit_k{k}"] = (rng.integers(0, 256, size=k)
                                  + 0x3C3C3C00).astype(np.int32)
        out[f"sign_bit_k{k}"] = np.where(rng.random(k) < 0.5, -(1 << 31),
                                         0).astype(np.int32)
    return out


def check_dedup(np, torch, sk, rng) -> dict:
    """dedup_ids kernel == plain version (torch.unique) bit for bit, at
    size = K and at a size below the distinct count."""
    cases = []
    for name, ids in dedup_streams(np, rng).items():
        t = torch.from_numpy(ids).cuda()
        count = int(sk.dedup_ids_plain(t, ids.size)[2])
        for size in sorted({ids.size, max(1, count // 2)}):
            got = sk.dedup_ids(t, size)
            torch.cuda.synchronize()
            want = sk.dedup_ids_plain(t, size)
            for a, b, what in zip(got, want, ("uids", "inv", "count")):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(
                        f"dedup_ids kernel != plain ({what}) on {name} "
                        f"size={size}")
            cases.append([name, size, count])
    return {"bit_exact": True, "max_abs_err": 0, "cases": cases}


def check_merge_apply(np, torch, sk, rng) -> dict:
    """merge_apply kernel vs plain version at the train path's shapes:
    V = 2^20, d in {1, 32} and 33 (one float a lane, a row across the
    warp), S = 159744 uids of a real dedup (Criteo ids hold id 0 about 3 %
    of the time; the other stream has none)."""
    fids = criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)
    streams = {"with_id0": fids, "without_id0": np.where(fids == 0, 1, fids)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    max_ulp = {"table": 0, "accum": 0}
    max_abs = 0.0
    max_ssq_rel = 0.0
    cases = []
    for sname, ids in streams.items():
        uids, _, count = sk.dedup_ids(torch.from_numpy(ids).cuda())
        has0 = bool(uids[0] == 0)
        for d in (1, DIM, DIM + 1):
            shape = (VOCAB,) if d == 1 else (VOCAB, d)
            table = torch.randn(shape, generator=gen, device="cuda")
            accum = torch.rand(shape, generator=gen, device="cuda")
            rows = torch.randn((uids.numel(),) + shape[1:], generator=gen,
                               device="cuda")
            for denom in (1.0, 4.0):
                t1, a1 = table.clone(), accum.clone()
                _, _, s1 = sk.merge_apply(t1, a1, uids, rows, lr=LR, eps=EPS,
                                          denom=denom)
                torch.cuda.synchronize()
                t2, a2 = table.clone(), accum.clone()
                _, _, s2 = sk.merge_apply_plain(t2, a2, uids, rows, None, LR,
                                                EPS, denom)
                ut, ua = ulp_diff(torch, t1, t2), ulp_diff(torch, a1, a2)
                rel = abs(float(s1) - float(s2)) / abs(float(s2))
                if ut > MAX_ULP or ua > MAX_ULP or rel > 1e-5:
                    raise AssertionError(
                        f"merge_apply kernel vs plain: {ut} / {ua} ulp, "
                        f"sumsq rel {rel} ({sname}, d={d}, denom={denom})")
                max_ulp["table"] = max(max_ulp["table"], ut)
                max_ulp["accum"] = max(max_ulp["accum"], ua)
                max_abs = max(max_abs, float((t1 - t2).abs().max()),
                              float((a1 - a2).abs().max()))
                max_ssq_rel = max(max_ssq_rel, rel)
                cases.append([sname, d, denom, int(count), has0])
    return {"max_ulp": max_ulp, "max_abs_err": max_abs,
            "max_sumsq_rel_err": max_ssq_rel, "cases": cases}


def check_fused_adagrad(torch, fa) -> dict:
    """fused_adagrad kernel vs plain version: N in ADAGRAD_NS (1001 is not
    a multiple of 4: the scalar path) and 2^20 starting one float into
    its buffers (misaligned: the scalar path)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    max_ulp, max_abs, cases = 0, 0.0, []
    for n, off in [(n, 0) for n in ADAGRAD_NS] + [(1 << 20, 1)]:
        w, a, g = (torch.randn(n + off, generator=gen, device="cuda")[off:]
                   for _ in range(3))
        a = a.abs()
        w1, a1 = w.clone(), a.clone()
        if off:
            w1 = torch.empty(n + off, device="cuda")[off:].copy_(w)
            a1 = torch.empty(n + off, device="cuda")[off:].copy_(a)
        fa.fused_adagrad_update(w1, a1, g, LR, EPS)
        torch.cuda.synchronize()
        w2, a2 = fa.fused_adagrad_plain(w.clone(), a.clone(), g, LR, EPS)
        u = max(ulp_diff(torch, w1, w2), ulp_diff(torch, a1, a2))
        if u > MAX_ULP:
            raise AssertionError(f"fused_adagrad kernel vs plain: {u} ulp "
                                 f"at N={n} offset={off}")
        max_ulp = max(max_ulp, u)
        max_abs = max(max_abs, float((w1 - w2).abs().max()),
                      float((a1 - a2).abs().max()))
        cases.append([n, off])
    return {"max_ulp": max_ulp, "max_abs_err": max_abs, "cases": cases}


def check_dedup64(np, torch, sk, rng) -> dict:
    """dedup_ids on int64 id streams == plain version (torch.unique) bit
    for bit: Criteo ids shifted past int32, ids across int64's range with
    its limits, an all-equal stream, and ids that differ only above bit 40
    (the radix sort's high digits, its low five skipped), at K in
    DEDUP_KS."""
    cases = []
    i64 = np.iinfo(np.int64)
    for k in DEDUP_KS:
        rows = -(-k // N_FIELDS)
        streams = {
            "criteo_shifted": criteo_fids(np, rng, rows).reshape(-1)[:k]
            .astype(np.int64) * (1 << 33) - (1 << 40),
            "edges": rng.integers(i64.min, i64.max, size=k, dtype=np.int64),
            "all_equal": np.full(k, -(1 << 35), np.int64),
            "high_digits": (rng.integers(0, 1 << 12, size=k)
                            .astype(np.int64) << 41) - (1 << 62),
        }
        lim = [i64.min, i64.max, -1, 0, i64.min, i64.max]
        streams["edges"][:min(k, len(lim))] = lim[:k]
        for name, ids in streams.items():
            t = torch.from_numpy(ids).cuda()
            count = int(sk.dedup_ids_plain(t, k)[2])
            for size in sorted({k, max(1, count // 2)}):
                got = sk.dedup_ids(t, size)
                torch.cuda.synchronize()
                want = sk.dedup_ids_plain(t, size)
                for a, b, what in zip(got, want, ("uids", "inv", "count")):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        raise AssertionError(
                            f"dedup_ids int64 kernel != plain ({what}) on "
                            f"{name} k={k} size={size}")
                cases.append([f"{name}_k{k}", size, count])
    return {"bit_exact": True, "max_abs_err": 0, "cases": cases}


#: a padding row's value after the coded exchange: the codes' tables hold
#: no exact 0, so the padding's zero rows decode to small values, which the
#: merge adds (one run of about half the gathered rows)
CODED_PAD = 1e-3


def gathered_stream(np, torch, sk, rng):
    """The dp path's merge input: the two ranks' dedup streams of one
    global batch (K = 79,872 ids each, id 0 padding each past its count),
    gathered, and their union.  Returns (ids, uniq, inv, count, pad, per
    rank), ``pad`` [M, 1] float32, 1 at each padding slot."""
    fids = criteo_fids(np, rng, DP_WORLD * DP_LOCAL_ROWS).reshape(-1)
    per_rank = [sk.dedup_ids(torch.from_numpy(
        fids[r * DP_LOCAL_K:(r + 1) * DP_LOCAL_K]).cuda())
        for r in range(DP_WORLD)]
    ids = torch.cat([u for u, _, _ in per_rank])
    uniq, inv, count = sk.dedup_ids(ids)
    slot = torch.arange(ids.numel(), device="cuda") % per_rank[0][0].numel()
    pad = ((ids == 0) & (slot > 0)).to(torch.float32).reshape(-1, 1)
    return ids, uniq, inv, int(count), pad, per_rank


def merge_inputs(np, torch, rng, m, d, nseg):
    """[m, d] rows and an inv over [-3, nseg + 3): the two ranks' gathered
    Criteo streams' heavy duplicates (a numeric field's id in every row)
    plus out-of-range segments of both signs."""
    fids = criteo_fids(np, rng, -(-m // N_FIELDS)).reshape(-1)[:m]
    _, inv = np.unique(fids, return_inverse=True)
    inv = inv.astype(np.int64) % nseg
    bad = rng.random(m) < 0.01
    inv[bad] = rng.choice([-3, -1, nseg, nseg + 2], size=int(bad.sum()))
    gen = torch.Generator(device="cuda").manual_seed(int(m + d))
    rows = torch.randn((m, d), generator=gen, device="cuda")
    return rows, torch.from_numpy(inv.astype(np.int32)).cuda()


def check_merge_rows(np, torch, sk, rng) -> dict:
    """merge_rows kernel == plain version (slot-order rounds) bit for bit
    at the allgather merge's shape: W*K = 159,744 gathered rows, d in
    {1, 32}, nseg = W*K; the same rows with every seventh segment's rows
    all +-0 (left at +0); and nseg = 2^24 + 77, so the radix sort moves all
    four digits."""
    m = DP_WORLD * DP_LOCAL_K
    cases = []
    for d, nseg, zeros in ((1, m, False), (DIM, m, False), (DIM, m, True),
                           (1, (1 << 24) + 77, False)):
        rows, inv = merge_inputs(np, torch, rng, m, d, m)
        if nseg != m:
            inv = torch.from_numpy(rng.integers(
                -2, nseg + 2, size=m).astype(np.int32)).cuda()
        if zeros:
            hit = (inv % 7) == 0
            rows[hit] = torch.where(torch.rand_like(rows[hit]) < 0.5, 0.0,
                                    -0.0)
        got = sk.merge_rows(rows, inv, nseg)
        torch.cuda.synchronize()
        want = sk.merge_rows_plain(rows, inv, nseg)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"merge_rows kernel != plain at d={d}, "
                                 f"nseg={nseg}, zero segments {zeros}: "
                                 f"max {float((got - want).abs().max())}")
        cases.append({"m": m, "d": d, "nseg": nseg, "zero_segments": zeros,
                      "dropped": int((inv < 0).sum() + (inv >= nseg).sum())})
    return {"bit_exact": True, "max_abs_err": 0.0, "cases": cases}


def check_merge_apply_merge_mode(np, torch, sk, rng) -> dict:
    """merge_apply in merge mode (one fused launch: the merge's sort and
    runs, applied straight to the table) vs the plain version: W*K =
    159,744 gathered rows merged onto the union of two ranks' dedup
    streams, V = 2^20, d in {1, 32}, denom W; each call one launch of
    merge_apply's ``merge`` design and none of merge_rows.  Then the dp
    path's own stream, the two ranks' dedup streams gathered, with the
    padding rows at CODED_PAD as the coded runs send them: one run of
    about half the rows, which the whole walker block sums."""
    fids = criteo_fids(np, rng, DP_WORLD * DP_LOCAL_ROWS).reshape(-1)
    raw_ids = torch.from_numpy(fids).cuda()
    raw = sk.dedup_ids(raw_ids)
    coded = gathered_stream(np, torch, sk, rng)
    gen = torch.Generator(device="cuda").manual_seed(17)
    max_ulp = {"table": 0, "accum": 0}
    max_abs, max_rel, cases = 0.0, 0.0, []
    for d, stream in ((1, "raw"), (DIM, "raw"), (1, "coded_pads"),
                      (DIM, "coded_pads")):
        if stream == "raw":
            ids, (uids, inv, count) = raw_ids, raw
        else:
            ids, uids, inv, count, pad, _ = coded
        shape = (VOCAB,) if d == 1 else (VOCAB, d)
        table = torch.randn(shape, generator=gen, device="cuda")
        accum = torch.rand(shape, generator=gen, device="cuda")
        rows = torch.randn((ids.numel(),) + shape[1:], generator=gen,
                           device="cuda")
        if stream == "coded_pads":
            p = pad if d > 1 else pad.reshape(-1)
            rows = rows * 0.05 * (1 - p) + CODED_PAD * p
        t1, a1 = table.clone(), accum.clone()
        sk.reset_launches()
        _, _, s1 = sk.merge_apply(t1, a1, uids, rows, inv, lr=LR, eps=EPS,
                                  denom=float(DP_WORLD))
        torch.cuda.synchronize()
        ran = (sk.launches("merge_rows"), sk.launches("merge_apply"),
               sk.variant_launches("merge_apply"))
        if ran != (0, 1, {"merge": 1}):
            raise AssertionError(f"merge_apply merge mode launched "
                                 f"(merge_rows, merge_apply, designs) {ran}")
        t2, a2 = table.clone(), accum.clone()
        _, _, s2 = sk.merge_apply_plain(t2, a2, uids, rows, inv, LR, EPS,
                                        float(DP_WORLD))
        ut, ua = ulp_diff(torch, t1, t2), ulp_diff(torch, a1, a2)
        rel = abs(float(s1) - float(s2)) / abs(float(s2))
        if ut > MAX_ULP or ua > MAX_ULP or rel > 1e-5:
            raise AssertionError(f"merge_apply merge mode vs plain: {ut} / "
                                 f"{ua} ulp, sumsq rel {rel} (d={d}, "
                                 f"{stream})")
        max_ulp["table"] = max(max_ulp["table"], ut)
        max_ulp["accum"] = max(max_ulp["accum"], ua)
        max_abs = max(max_abs, float((t1 - t2).abs().max()),
                      float((a1 - a2).abs().max()))
        max_rel = max(max_rel, rel)
        cases.append([stream, ids.numel(), d, int(count)])
    return {"max_ulp": max_ulp, "max_abs_err": max_abs,
            "max_sumsq_rel_err": max_rel, "cases": cases}


def qp_payload(torch, gen, shape, scale=0.05):
    """A gradient-like payload with +-inf, NaN and values on and past the
    table's edges."""
    x = torch.randn(shape, generator=gen, device="cuda") * scale
    flat = x.view(-1)
    flat[:6] = torch.tensor([float("inf"), float("-inf"), float("nan"), 2.0,
                             -2.0, 0.0], device="cuda")
    return x


def check_quantize_pack(np, torch, sk, qz) -> dict:
    """quantize_pack kernel == plain version (quantize.compress) bit for
    bit on the exchange's [79,872, 32] payload: 8-bit uniform and normal
    tables (fixed range 1.0 and a measured range), 16-bit uniform, and
    4-bit with its nibble-packed wire form."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = qp_payload(torch, gen, (DP_LOCAL_K, DIM))
    rng_dyn = 1.05 * x[x.isfinite()].abs().max()
    cases = []
    for bits, mode, lim in ((8, "uniform", 1.0), (8, "normal", 1.0),
                            (8, "normal", rng_dyn), (16, "uniform", 1.0),
                            (4, "normal", rng_dyn)):
        table = qz.build_table(-lim, lim, bits=bits, mode=mode,
                               device="cuda")
        got = sk.quantize_pack(table, x)
        torch.cuda.synchronize()
        want = sk.quantize_pack_plain(table, x)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"quantize_pack kernel != plain at {bits} "
                                 f"bits, {mode}")
        if bits <= 4 and not torch.equal(
                sk.quantize_pack_packed(table, x), qz.pack_nibbles(want)):
            raise AssertionError("quantize_pack_packed != pack_nibbles")
        cases.append([bits, mode, "dynamic" if torch.is_tensor(lim) else lim,
                      int(got[0, 2])])
    return {"bit_exact": True, "max_abs_err": 0, "payload": [DP_LOCAL_K, DIM],
            "nan_code": cases[0][3], "cases": cases}


def check_quantize_pack_ef_update(np, torch, sk, qz, rng) -> dict:
    """quantize_pack_ef_update kernel == plain version bit for bit (codes,
    dec, residual): the uids of a real dedup of one rank's 2048-row
    Criteo batch (id 0 included, pads masked), rows 3x the range so the
    clip feeds the carry, a carry from a previous step, d in {1, 32, 33},
    8 and 16 bits."""
    fids = criteo_fids(np, rng, DP_LOCAL_ROWS).reshape(-1)
    fids[0] = 0
    uids, _, count = sk.dedup_ids(torch.from_numpy(fids).cuda())
    k = uids.numel()
    gen = torch.Generator(device="cuda").manual_seed(29)
    cases = []
    for d in (1, DIM, DIM + 1):
        for bits, mode in ((8, "normal"), (16, "uniform")):
            table = qz.build_table(-1.0, 1.0, bits=bits, mode=mode,
                                   device="cuda")
            shape = (VOCAB,) if d == 1 else (VOCAB, d)
            residual = torch.randn(shape, generator=gen, device="cuda") * 0.1
            rows = torch.randn((k,) + shape[1:], generator=gen,
                               device="cuda") * 3.0
            mask = (~((uids == 0) & (torch.arange(k, device="cuda") > 0))) \
                .to(torch.float32).reshape((-1,) + (1,) * (rows.ndim - 1))
            rows = rows * mask
            r1, r2 = residual.clone(), residual.clone()
            c1, _, d1 = sk.quantize_pack_ef_update(table, rows, uids, r1, mask)
            torch.cuda.synchronize()
            c2, _, d2 = sk.quantize_pack_ef_update_plain(table, rows, uids,
                                                         r2, mask)
            for a, b, what in ((c1, c2, "codes"), (d1, d2, "dec"),
                               (r1, r2, "residual")):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(
                        f"quantize_pack_ef_update kernel != plain ({what}) at "
                        f"d={d}, {bits} bits")
            cases.append([k, int(count), d, bits, mode])
    return {"bit_exact": True, "max_abs_err": 0.0, "has_id0": True,
            "cases": cases}


def check_quantize_pack_ef(np, torch, sk, qz) -> dict:
    """quantize_pack_ef kernel == plain version bit for bit (codes, delta)
    on the [79,872, 32] payload: rows with +-inf and NaN, a carry with inf
    and NaN, masked and unmasked rows ([P, 1]) and values ([P, d]), 8 bits
    normal and 16 bits uniform."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    rows = qp_payload(torch, gen, (DP_LOCAL_K, DIM), scale=0.5)
    carried = torch.randn((DP_LOCAL_K, DIM), generator=gen,
                          device="cuda") * 0.05
    carried.view(-1)[40:42] = torch.tensor([float("inf"), float("nan")],
                                           device="cuda")
    cases = []
    for bits, mode in ((8, "normal"), (16, "uniform")):
        table = qz.build_table(-1.0, 1.0, bits=bits, mode=mode,
                               device="cuda")
        for shape in ((DP_LOCAL_K, 1), (DP_LOCAL_K, DIM)):
            mask = (torch.rand(shape, generator=gen, device="cuda")
                    > 0.3).to(torch.float32)
            mask[0] = 1.0   # the inf/NaN values of the first row unmasked
            mask[1] = 0.0
            c1, d1 = sk.quantize_pack_ef(table, rows, carried, mask)
            torch.cuda.synchronize()
            c2, d2 = sk.quantize_pack_ef_plain(table, rows, carried, mask)
            if c1.dtype != c2.dtype or not torch.equal(c1, c2):
                raise AssertionError(f"quantize_pack_ef kernel != plain "
                                     f"(codes) at {bits} bits, mask {shape}")
            if not torch.equal(d1.view(torch.int32), d2.view(torch.int32)):
                raise AssertionError(f"quantize_pack_ef kernel != plain "
                                     f"(delta) at {bits} bits, mask {shape}")
            cases.append([bits, mode, list(shape),
                          int((mask == 0).sum())])
    return {"bit_exact": True, "max_abs_err": 0.0,
            "payload": [DP_LOCAL_K, DIM], "nan_code": int(c1[0, 2]),
            "cases": cases}


def flash_inputs(torch, shape, dtype, seed):
    """Unit-normal q, k, v of ``shape`` from a CPU generator (the same in
    every process), on the card in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype).cuda()
            for _ in range(3)]


def flash_error(torch, got, want, dtype):
    """(max abs, mean abs) error of the kernel's output; raises past the
    dtype's tolerance."""
    err = (got.float() - want.float()).abs()
    emax, emean = float(err.max()), float(err.mean())
    if dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=FLASH_F32_RTOL,
                            atol=FLASH_F32_ATOL)
    else:
        ok = emax <= FLASH_16_MAX and emean <= FLASH_16_MEAN
    if not ok or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"flash_attention kernel vs plain: max {emax}, "
                             f"mean {emean} ({dtype})")
    return emax, emean


def check_flash(torch, sk, fl) -> dict:
    """flash_attention kernel vs plain version (float32 full_attention):
    the bench's causal bf16 shapes, bf16 heads of 128, 256 and 320 causal
    and not, B*H = 65,600, and fp32 at (2, 256, 4, 32) and the graft
    entry's (2, 32, 2, 8), causal and not.  Each case records the design
    that ran (``flash_route``)."""
    cases, max_err = [], {"bfloat16": 0.0, "float32": 0.0}
    runs = [(shape, torch.bfloat16, True) for shape in FLASH_BENCH_SHAPES]
    runs += [(shape, torch.bfloat16, causal) for shape in FLASH_WIDE_SHAPES
             for causal in (False, True)]
    runs.append((FLASH_MANY_HEADS_SHAPE, torch.bfloat16, True))
    runs += [(shape, torch.float32, causal) for shape in FLASH_F32_SHAPES
             for causal in (False, True)]
    for i, (shape, dt, causal) in enumerate(runs):
        q, k, v = flash_inputs(torch, shape, dt, 100 + i)
        sk.reset_launches()
        got = fl.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        route = sk.variant_launches("flash_attention")
        if route != {fl.flash_route(q, k, v): 1}:
            raise AssertionError(f"flash_attention {shape}: ran {route}")
        want = fl.flash_attention_plain(q, k, v, causal)
        emax, emean = flash_error(torch, got, want, dt)
        key = str(dt).replace("torch.", "")
        max_err[key] = max(max_err[key], emax)
        cases.append([list(shape), key, causal, next(iter(route)), emax,
                      emean])
        del q, k, v, got, want
    return {"max_abs_err": max(max_err.values()), "max_abs_err_by_dtype":
            max_err, "tolerance": {"16-bit": [FLASH_16_MAX, FLASH_16_MEAN],
                                   "float32": [FLASH_F32_RTOL,
                                               FLASH_F32_ATOL]},
            "cases": cases}


# -- phase: serve -------------------------------------------------------------


def make_params(np, seed):
    """FM params {"w": [F], "v": [F, k]} from a seed.  W is small random
    (not the zero init) so the linear term counts; V is N(0, 0.3^2 / k),
    a logit spread of about 0.5 like a trained CTR model's (at the
    N(0, 1/k) init four in ten scores saturate)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.01, VOCAB).astype(np.float32)
    v = (rng.standard_normal((VOCAB, DIM), dtype=np.float32)
         * np.float32(0.3 / np.sqrt(DIM)))
    return {"w": w, "v": v}


def make_requests(np, seed):
    """Criteo-layout requests (data/synth.py write_criteo_proxy): the 26
    categorical fields draw ids ~ u^4 * vocab (a frequent head, a long
    tail), the 13 numeric fields one fixed id each with an exponential
    value."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(N_REQUESTS):
        u = rng.random((REQUEST_ROWS, N_FIELDS))
        fids = (u ** 4 * VOCAB).astype(np.int32)
        fids[:, N_CAT:] = np.arange(N_CAT, N_FIELDS, dtype=np.int32)
        vals = np.ones((REQUEST_ROWS, N_FIELDS), np.float32)
        vals[:, N_CAT:] = rng.exponential(
            1.0, (REQUEST_ROWS, N_FIELDS - N_CAT)).astype(np.float32)
        out.append({"fids": fids, "vals": vals})
    return out


def fm_forward64(np, params, req):
    x = req["vals"].astype(np.float64)
    w = params["w"][req["fids"]].astype(np.float64)
    vx = params["v"][req["fids"]].astype(np.float64) * x[..., None]
    z = (w * x).sum(-1) + 0.5 * ((vx.sum(1) ** 2).sum(-1)
                                 - (vx ** 2).sum((1, 2)))
    return 1.0 / (1.0 + np.exp(-z))


def serve_gather_ns(np, sk, requests) -> list:
    """The gather's n on the serve path: each micro-batch's distinct
    ids, padded to the kernel layer's power-of-two ladder."""
    return sorted({sk.next_pow2(len(np.unique(r["fids"])))
                   for r in requests})


def phase_serve(np, torch, sk, seed, requests) -> dict:
    from lightctr_tpu_torch import serve
    from lightctr_tpu_torch.dist.ps_server import ParamServerService, PSClient
    from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

    t0 = time.perf_counter()
    params = make_params(np, seed)
    refs = [fm_forward64(np, params, r) for r in requests]
    keys, rows = serve.fused_fm_rows(params)
    store = AsyncParamServer(dim=ROW_DIM, n_workers=1, seed=seed)
    svc = ParamServerService(store)
    admin = srv = cli = None
    try:
        admin = PSClient(svc.address, ROW_DIM)
        for lo in range(0, VOCAB, PRELOAD_CHUNK):
            admin.preload_arrays(keys[lo:lo + PRELOAD_CHUNK],
                                 rows[lo:lo + PRELOAD_CHUNK])
        setup_s = time.perf_counter() - t0
        model = serve.ServingModel(
            "fm", {}, row_leaves=serve.fm_ps_row_leaves(DIM),
            row_dim=ROW_DIM, device="cuda")
        srv = serve.PredictionServer(
            model, ps=PSClient(svc.address, ROW_DIM), max_batch=256,
            device="cuda")
        cli = serve.PredictClient(srv.address)
        passes = []
        max_err = 0.0
        sk.reset_launches()
        for p in range(2):
            lat = []
            t_pass = time.perf_counter()
            for req, ref in zip(requests, refs):
                t = time.perf_counter()
                scores = cli.predict(req)   # raises on any non-OK reply
                lat.append(time.perf_counter() - t)
                if scores.shape != ref.shape or \
                        not np.all(np.isfinite(scores)):
                    raise AssertionError(f"bad scores {scores.shape}")
                err = float(np.abs(scores - ref).max())
                max_err = max(max_err, err)
                if err > SCORE_ATOL:
                    raise AssertionError(
                        f"pass {p}: score error {err} > {SCORE_ATOL}")
            wall = time.perf_counter() - t_pass
            lat_sorted = sorted(lat)
            passes.append({
                "rows_per_s": N_REQUESTS * REQUEST_ROWS / wall,
                "p50_ms": 1e3 * statistics.median(lat),
                "p99_ms": 1e3 * lat_sorted[min(len(lat) - 1,
                                               int(0.99 * len(lat)))],
                "hits": srv.cache.stats()["hits"],
            })
        launches = sk.launches()
        st = srv.stats()
        cache = st["cache"]
        batches = st["batches_scored"]
        if not (cache["device_rows"] and srv.cache._block.is_cuda):
            raise AssertionError("cache rows are not a CUDA tensor")
        if passes[1]["hits"] <= passes[0]["hits"]:
            raise AssertionError("no cache hits on the second pass")
        if launches["gather_rows"] < batches or batches < 2 * N_REQUESTS:
            raise AssertionError(
                f"gather_rows launched {launches['gather_rows']} times "
                f"for {batches} scored micro-batches")
    finally:
        for c in (cli, admin):
            if c is not None:
                c.close()
        if srv is not None:
            srv.close()
        svc.close()
    return {"phase": "serve", "model": "fm", "fields": N_FIELDS,
            "vocab": VOCAB, "factor_dim": DIM, "row_dim": ROW_DIM,
            "requests": N_REQUESTS, "request_rows": REQUEST_ROWS,
            "setup_s": setup_s, "passes": passes,
            "max_abs_score_err": max_err, "score_atol": SCORE_ATOL,
            "batches_scored": batches, "launches": launches,
            "cache": {k: cache[k] for k in ("entries", "capacity", "hits",
                                            "misses", "device_rows")}}


# -- phase: train -------------------------------------------------------------


def criteo_rows(np, rng, n) -> dict:
    """n synthetic Criteo rows in memory, data/synth.py's recipe: u^4
    head/tail ids, exponential numeric values (rounded to 3 digits), and a
    label planted as a logistic in two numeric fields plus a head-id
    effect."""
    fids = criteo_fids(np, rng, n)
    vals = np.ones((n, N_FIELDS), np.float32)
    vals[:, N_CAT:] = rng.exponential(
        1.0, (n, N_FIELDS - N_CAT)).astype(np.float32).round(3)
    z = ((vals[:, N_CAT] - 1.0) + (vals[:, N_CAT + 1] - 1.0)
         + (fids[:, 0] % 2).astype(np.float32) - 0.5)
    p = 1.0 / (1.0 + np.exp(-2.0 * z))
    labels = (rng.random(n) < p).astype(np.float32)
    return {"fids": fids, "vals": vals,
            "mask": np.ones((n, N_FIELDS), np.float32), "labels": labels}


def train_params(np, seed):
    """FM's init at Criteo width from a seed (fm_algo_abst.h:53-67): W
    zero, V ~ N(0, 1/k)."""
    rng = np.random.default_rng(seed + 3)
    v = rng.standard_normal((VOCAB, DIM), dtype=np.float32)
    return {"w": np.zeros(VOCAB, np.float32),
            "v": v * np.float32(1.0 / np.sqrt(DIM))}


def run_steps(torch, tr, batches, snapshots=()):
    """Step ``tr`` over ``batches``; returns the loss tensors, device
    clones of (w, v) after each step count in ``snapshots``, the
    synchronised wall time of the steps after the warm-up, and the median
    host time to launch one such step."""
    losses, snaps, host = [], {}, []
    t0 = None
    for i, b in enumerate(batches):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        th = time.perf_counter()
        losses.append(tr.train_step(b))
        if i >= WARMUP_STEPS:
            host.append(time.perf_counter() - th)
        if i + 1 in snapshots:
            snaps[i + 1] = {k: tr.params[k].clone() for k in ("w", "v")}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return losses, snaps, wall, statistics.median(host)


def cpu_rerun(np, torch, trainer_cls, params, batches, **kw):
    """The same steps on the CPU at full width, with the plain versions."""
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm

    tr = trainer_cls(fm.params_from_numpy(params, "cpu"), fm.logits,
                     TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
                     fused_fn=fm.logits_with_l2, device="cpu", **kw)
    tr.health = None
    losses = [float(tr.train_step(b)) for b in batches]
    return losses, tr.params


def compare_rows(np, torch, got, want, ids, what) -> float:
    """Rows ``ids`` of (w, v) within TRAIN_RTOL / TRAIN_ATOL; returns the
    max abs error."""
    idx = torch.from_numpy(np.unique(ids).astype(np.int64))
    err = 0.0
    for k in ("w", "v"):
        a = got[k].cpu().index_select(0, idx)
        b = want[k].cpu().index_select(0, idx)
        if not torch.allclose(a, b, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"{what}: {k} rows differ, max abs "
                                 f"{float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    return err


def profile_sparse_steps(torch, tr, batches) -> dict:
    """Device time by kernel over a few sparse steps."""
    return profile_calls(torch, [lambda b=b: tr.train_step(b)
                                 for b in batches])


class NoDeviceTime(AssertionError):
    """A torch.profiler session recorded no device time."""


def profile_calls(torch, calls) -> dict:
    """Device time by kernel over ``calls``, each a step (torch.profiler).
    The device's idle share rests on it, so a profile that shows no
    device time fails the phase (NoDeviceTime)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies), not the CPU ops that
        # launched them nor the annotations' device ranges, each of which
        # would count the same kernels again
        if (str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)
                and "/" not in e.key):
            dev_us = getattr(e, "self_device_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
    if not rows:
        raise NoDeviceTime("torch.profiler recorded no device time")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"steps": len(calls), "profiled_wall_ms": wall_ms,
            "device_ms_per_step": busy_ms / len(calls),
            "device_ops_per_step": sum(r[2] for r in rows) / len(calls),
            "top": [{"name": k[:60], "ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:14]]}


def launch_profile(torch, fn, calls: int = 20):
    """Device time by kernel over ``calls`` calls of ``fn``: a kernel row's
    per-launch breakdown, which gates nothing.  ``None`` when the session
    recorded no device time.  On the card torch.profiler loses the first
    device records of such a session (its ``calls`` per kernel fall short
    of the launches), and once lost all of them; the cause is not known,
    so the per-launch times are averages over the records kept."""
    try:
        return profile_calls(torch, [fn] * calls)
    except NoDeviceTime:
        return None


def phase_train(np, torch, sk, seed) -> dict:
    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.ctr_trainer import CTRTrainer
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer

    t_setup = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    data = criteo_rows(np, rng, SPARSE_STEPS * TRAIN_BATCH)
    held_out = criteo_rows(np, rng, EVAL_ROWS)
    batches = [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                for k, v in data.items()} for i in range(SPARSE_STEPS)]
    params = train_params(np, seed)
    cfg = TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2)
    tables = {"w": ["fids"], "v": ["fids"]}
    setup_s = time.perf_counter() - t_setup

    # (a) the O(touched) sparse trainer
    sparse = SparseTableCTRTrainer(
        fm.params_from_numpy(params, "cuda"), fm.logits, cfg,
        sparse_tables=tables, fused_fn=fm.logits_with_l2, device="cuda")
    sk.reset_launches()
    s_losses, s_snaps, s_wall, s_host = run_steps(
        torch, sparse, batches, snapshots=(CPU_SPARSE_STEPS, PARITY_STEPS))
    s_launch = sk.launches()
    s_losses = [float(x) for x in s_losses]
    if (s_launch["dedup_ids"] != SPARSE_STEPS
            or s_launch["merge_apply"] != 2 * SPARSE_STEPS):
        raise AssertionError(f"sparse trainer launches {s_launch} over "
                             f"{SPARSE_STEPS} steps")
    if not all(np.isfinite(s_losses)) or \
            np.mean(s_losses[-5:]) >= np.mean(s_losses[:5]):
        raise AssertionError(f"sparse trainer loss did not fall: {s_losses}")
    ev = sparse.evaluate(held_out, batch_size=TRAIN_BATCH)
    if not ev["auc"] > MIN_AUC:
        raise AssertionError(f"held-out AUC {ev['auc']} <= {MIN_AUC}")
    # untouched rows never move (the step is O(touched))
    seen = np.unique(data["fids"])
    untouched = np.setdiff1d(np.arange(VOCAB), seen)[:100000]
    ut = torch.from_numpy(untouched).cuda()
    if not torch.equal(sparse.params["v"].index_select(0, ut),
                       torch.from_numpy(params["v"]).cuda().index_select(
                           0, ut)):
        raise AssertionError("sparse trainer moved untouched rows")
    # the health feed's host share of the default step above: its touched-
    # id count (np.unique per id stream) alone, on the same batches
    t_sig = time.perf_counter()
    for b in batches[:5]:
        sparse._health_signals(b)
    signals_ms = 1e3 * (time.perf_counter() - t_sig) / 5
    # more steps with the health feed off
    sparse.health = None
    _, _, s_wall_nohealth, s_host_nohealth = run_steps(
        torch, sparse, batches[:20])
    prof = profile_sparse_steps(torch, sparse, batches[20:25])
    # the profiler's own start-up inflates its window: the idle share is
    # taken against the step time measured without it
    prof["idle_share_health_off"] = 1.0 - prof["device_ms_per_step"] / (
        1e3 * s_wall_nohealth / (20 - WARMUP_STEPS))

    # (b) the dense trainer with the fused Adagrad kernel
    fused = CTRTrainer(fm.params_from_numpy(params, "cuda"), fm.logits, cfg,
                       fused_fn=fm.logits_with_l2, fused_adagrad=True,
                       device="cuda")
    sk.reset_launches()
    f_losses, f_snaps, f_wall, f_host = run_steps(
        torch, fused, batches[:FUSED_STEPS],
        snapshots=(CPU_FUSED_STEPS, PARITY_STEPS))
    f_launch = sk.launches()
    f_losses = [float(x) for x in f_losses]
    if f_launch["fused_adagrad"] != 2 * FUSED_STEPS:
        raise AssertionError(f"fused trainer launches {f_launch} over "
                             f"{FUSED_STEPS} steps")
    if not all(np.isfinite(f_losses)) or \
            np.mean(f_losses[-3:]) >= np.mean(f_losses[:3]):
        raise AssertionError(f"fused trainer loss did not fall: {f_losses}")

    # (c) cross-checks: the CPU's plain versions, and the two trainers
    t_cpu = time.perf_counter()
    c_losses, c_params = cpu_rerun(np, torch, SparseTableCTRTrainer, params,
                                   batches[:CPU_SPARSE_STEPS],
                                   sparse_tables=tables)
    cf_losses, cf_params = cpu_rerun(np, torch, CTRTrainer, params,
                                     batches[:CPU_FUSED_STEPS],
                                     fused_adagrad=True)
    cpu_s = time.perf_counter() - t_cpu
    for got, want, what in ((s_losses[:CPU_SPARSE_STEPS], c_losses,
                             "sparse"),
                            (f_losses[:CPU_FUSED_STEPS], cf_losses,
                             "fused")):
        if not np.allclose(got, want, rtol=TRAIN_RTOL, atol=0):
            raise AssertionError(f"{what} losses card {got} vs cpu {want}")
    err_sparse_cpu = compare_rows(
        np, torch, s_snaps[CPU_SPARSE_STEPS], c_params,
        data["fids"][:CPU_SPARSE_STEPS * TRAIN_BATCH], "sparse card vs cpu")
    err_fused_cpu = compare_rows(
        np, torch, f_snaps[CPU_FUSED_STEPS], cf_params,
        data["fids"][:CPU_FUSED_STEPS * TRAIN_BATCH], "fused card vs cpu")
    err_sparse_fused = compare_rows(
        np, torch, s_snaps[PARITY_STEPS], f_snaps[PARITY_STEPS],
        data["fids"][:PARITY_STEPS * TRAIN_BATCH],
        "sparse vs fused trainer on the card")
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(s_losses[:CPU_SPARSE_STEPS] + f_losses[
                       :CPU_FUSED_STEPS], c_losses + cf_losses))
    steady = SPARSE_STEPS - WARMUP_STEPS
    return {
        "phase": "train", "model": "fm", "fields": N_FIELDS, "vocab": VOCAB,
        "factor_dim": DIM, "batch": TRAIN_BATCH, "lr": LR,
        "lambda_l2": LAMBDA_L2, "setup_s": setup_s,
        "sparse": {
            "steps": SPARSE_STEPS, "launches": s_launch,
            "loss_first5": s_losses[:5], "loss_last5": s_losses[-5:],
            "heldout": ev, "heldout_rows": EVAL_ROWS,
            "examples_per_s": steady * TRAIN_BATCH / s_wall,
            "step_ms": 1e3 * s_wall / steady,
            "host_launch_ms": 1e3 * s_host,
            "health_signals_ms": signals_ms,
            "examples_per_s_health_off":
                (20 - WARMUP_STEPS) * TRAIN_BATCH / s_wall_nohealth,
            "step_ms_health_off":
                1e3 * s_wall_nohealth / (20 - WARMUP_STEPS),
            "host_launch_ms_health_off": 1e3 * s_host_nohealth,
            "distinct_ids_first_batch": int(np.unique(
                batches[0]["fids"]).size),
            "profile": prof,
        },
        "fused": {
            "steps": FUSED_STEPS, "launches": f_launch,
            "losses": f_losses,
            "examples_per_s":
                (FUSED_STEPS - WARMUP_STEPS) * TRAIN_BATCH / f_wall,
            "step_ms": 1e3 * f_wall / (FUSED_STEPS - WARMUP_STEPS),
            "host_launch_ms": 1e3 * f_host,
        },
        "cross_checks": {
            "cpu_steps": {"sparse": CPU_SPARSE_STEPS,
                          "fused": CPU_FUSED_STEPS},
            "cpu_seconds": cpu_s,
            "max_loss_rel_err_vs_cpu": loss_rel,
            "max_abs_err_sparse_vs_cpu": err_sparse_cpu,
            "max_abs_err_fused_vs_cpu": err_fused_cpu,
            "max_abs_err_sparse_vs_fused_10_steps": err_sparse_fused,
            "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL,
        },
        "train_launches": {"dedup_ids": s_launch["dedup_ids"],
                           "merge_apply": s_launch["merge_apply"],
                           "fused_adagrad": f_launch["fused_adagrad"]},
    }


# -- phase: dp ----------------------------------------------------------------

#: (name, trainer kwargs, steps) of the dp phase's runs
DP_RUNS = (
    ("exact", {}, SPARSE_STEPS),
    ("coded_dynamic", {"compress_bits": 8, "compress_range": "dynamic"}, 10),
    ("coded_ef", {"compress_bits": 8}, 10),
)
DP_CPU_STEPS = 2            # exact steps re-run at W = 2 on the CPU
DP_LOSS_GAP = 0.05          # tests/test_sparse_exchange.py's coded bound
#: the coded runs re-run whole on the CPU: their losses on the card within
#: this relative distance of the plain versions' at every step
DP_CODED_RTOL = 1e-3
#: share of the touched values of a coded run that may differ between the
#: card and the CPU past TRAIN_RTOL / TRAIN_ATOL: one code bucket can
#: separate them where the two devices' gradients differ in the last ulp
#: next to a boundary
DP_CODE_FLIP_SHARE = 1e-3
DP_DEADLINE_S = 600.0


def dp_data(np, seed):
    """The train phase's batches and held-out rows (the same seed)."""
    rng = np.random.default_rng(seed + 2)
    data = criteo_rows(np, rng, SPARSE_STEPS * TRAIN_BATCH)
    held_out = criteo_rows(np, rng, EVAL_ROWS)
    return [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
             for k, v in data.items()} for i in range(SPARSE_STEPS)], held_out


def dp_rank(rank, world, out_dir, seed, device, run_steps):
    """One rank of the dp phase: each run named in ``run_steps`` ({name:
    steps}) trains FM at
    Criteo width from the seed's init through ``SparseTableCTRTrainer``'s
    hybrid exchange on the global batches (this rank takes its rows),
    counting launches from just before the first step to just after the
    last; writes losses, launches, digests of the trained state, the
    rows the first DP_CPU_STEPS batches touched, and (rank 0, exact run)
    the held-out evaluation."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from lightctr_tpu_torch.core.config import TrainConfig
    from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
    from lightctr_tpu_torch.models import fm
    from lightctr_tpu_torch.models.sparse_trainer import \
        SparseTableCTRTrainer
    from lightctr_tpu_torch.ops import sparse_kernels as sk

    mesh = make_mesh(MeshSpec(data=world), device=device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(mesh.device)

    def sync():
        if on_card:
            torch.cuda.synchronize(mesh.device)

    batches, held_out = dp_data(np, seed)
    params = train_params(np, seed)
    snap_ids = torch.from_numpy(np.unique(np.concatenate(
        [b["fids"].reshape(-1) for b in batches[:DP_CPU_STEPS]])).astype(
            np.int64)).to(mesh.device)
    out = {}
    for name, kw, _ in DP_RUNS:
        if name not in run_steps:
            continue
        steps = run_steps[name]
        tr = SparseTableCTRTrainer(
            fm.params_from_numpy(params, mesh.device), fm.logits,
            TrainConfig(learning_rate=LR, lambda_l2=LAMBDA_L2),
            sparse_tables={"w": ["fids"], "v": ["fids"]},
            fused_fn=fm.logits_with_l2, mesh=mesh, **kw)
        tr.health = None  # the steady state with the health feed off
        sync()
        dist.barrier()
        sk.reset_launches()
        losses, t0 = [], None
        for i, b in enumerate(batches[:steps]):
            if i == WARMUP_STEPS:
                sync()
                t0 = time.perf_counter()
            losses.append(tr.train_step(b))
            if i + 1 == DP_CPU_STEPS and rank == 0:
                torch.save({k: tr.params[k].index_select(0, snap_ids).cpu()
                            for k in ("w", "v")},
                           os.path.join(out_dir, f"snap_{name}.pt"))
        sync()
        wall = time.perf_counter() - t0 if t0 is not None else None
        launches = sk.launches()
        rec = {"steps": steps, "losses": [float(x) for x in losses],
               "launches": launches,
               "merge_apply_variants": sk.variant_launches("merge_apply"),
               "policy": dict(tr.exchange_policy),
               "bytes_per_step": dict(tr.exchange_bytes_per_step),
               "device": str(mesh.device), "backend": mesh.backend}
        if wall is not None:
            rec["steady_steps"] = steps - WARMUP_STEPS
            rec["steady_wall_s"] = wall
        if name == "exact" and steps == SPARSE_STEPS:
            if rank == 0:
                rec["heldout"] = tr.evaluate(held_out,
                                             batch_size=TRAIN_BATCH)
            if on_card:
                # 5 more steps, rank 0's under the profiler (the other
                # rank steps alongside for the collectives)
                if rank == 0:
                    rec["profile"] = profile_sparse_steps(torch, tr,
                                                          batches[:5])
                else:
                    for b in batches[:5]:
                        tr.train_step(b)
                    sync()
        # the replicated state (each rank's EF residuals are its own)
        state = {"w": tr.params["w"], "v": tr.params["v"],
                 "accum_w": tr.opt_state["accum"]["w"],
                 "accum_v": tr.opt_state["accum"]["v"]}
        rec["digest"] = {k: hashlib.sha256(
            t.detach().cpu().numpy().tobytes()).hexdigest()
            for k, t in state.items()}
        out[name] = rec
        del tr, state
        if on_card:
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_expected_launches(name, steps) -> dict:
    """Launches one rank makes in ``steps`` steps of run ``name``: two
    id streams deduped (local and gathered), two tables merged and
    applied (merge_apply's fused merge mode: no merge_rows launch), and
    each table's payload coded once in the coded runs."""
    return {"dedup_ids": 2 * steps, "merge_rows": 0,
            "merge_apply": 2 * steps,
            "quantize_pack": 2 * steps if name == "coded_dynamic" else 0,
            "quantize_pack_ef_update": 2 * steps if name == "coded_ef" else 0,
            "gather_rows": 0, "fused_adagrad": 0}


def phase_dp(np, torch, sk, seed) -> dict:
    """FM at Criteo width trained data-parallel by SparseTableCTRTrainer
    over DP_WORLD gloo ranks on the one card, its first steps re-run on
    the CPU, and one step at W = 1 over NCCL."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.core.mesh import spawn_world

    names = tuple(name for name, _, _ in DP_RUNS)
    card_steps = {name: steps for name, _, steps in DP_RUNS}
    cpu_steps = dict(card_steps, exact=DP_CPU_STEPS)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dirs = {k: os.path.join(root, k) for k in ("card", "cpu", "nccl")}
        for d in dirs.values():
            os.makedirs(d)
        t = time.perf_counter()
        spawn_world(dp_rank, DP_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(dirs["card"], seed, "cuda", card_steps))
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        spawn_world(dp_rank, DP_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(dirs["cpu"], seed, "cpu", cpu_steps))
        cpu_s = time.perf_counter() - t
        t = time.perf_counter()
        spawn_world(dp_rank, 1, "nccl", deadline_s=DP_DEADLINE_S,
                    args=(dirs["nccl"], seed, "cuda", {"coded_ef": 1}))
        nccl_s = time.perf_counter() - t
        load = lambda d, r: json.load(open(os.path.join(d, f"rank{r}.json")))
        card = [load(dirs["card"], r) for r in range(DP_WORLD)]
        cpu = load(dirs["cpu"], 0)
        nccl = load(dirs["nccl"], 0)["coded_ef"]
        batches, _ = dp_data(np, seed)
        snap_ids = np.unique(np.concatenate(
            [b["fids"].reshape(-1) for b in batches[:DP_CPU_STEPS]]))
        runs = {}
        for name in names:
            recs = [c[name] for c in card]
            steps = recs[0]["steps"]
            want = dp_expected_launches(name, steps)
            for r, rec in enumerate(recs):
                got = {k: rec["launches"].get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"dp {name} rank {r}: launches "
                                         f"{got}, expected {want}")
                if rec["merge_apply_variants"] != {
                        "merge": want["merge_apply"]}:
                    raise AssertionError(
                        f"dp {name} rank {r}: merge_apply ran "
                        f"{rec['merge_apply_variants']}, not only its "
                        "fused merge mode")
                if rec["policy"] != {"w": "sparse", "v": "sparse"}:
                    raise AssertionError(f"dp {name}: policy "
                                         f"{rec['policy']}")
                if rec["digest"] != recs[0]["digest"]:
                    raise AssertionError(f"dp {name}: rank {r}'s state is "
                                         "not bit-identical to rank 0's")
            losses = recs[0]["losses"]
            head = 5 if steps >= 20 else 3
            if not all(np.isfinite(losses)) or \
                    np.mean(losses[-head:]) >= np.mean(losses[:head]):
                raise AssertionError(f"dp {name}: loss did not fall "
                                     f"{losses}")
            cpu_losses = cpu[name]["losses"]
            rtol = TRAIN_RTOL if name == "exact" else DP_CODED_RTOL
            if not np.allclose(losses[:len(cpu_losses)], cpu_losses,
                               rtol=rtol, atol=0):
                raise AssertionError(f"dp {name}: losses card "
                                     f"{losses[:len(cpu_losses)]} vs cpu "
                                     f"{cpu_losses}")
            got_snap = torch.load(os.path.join(dirs["card"],
                                               f"snap_{name}.pt"))
            want_snap = torch.load(os.path.join(dirs["cpu"],
                                                f"snap_{name}.pt"))
            max_abs, off = 0.0, 0
            for k in ("w", "v"):
                a, b = got_snap[k], want_snap[k]
                max_abs = max(max_abs, float((a - b).abs().max()))
                off += int((~torch.isclose(a, b, rtol=TRAIN_RTOL,
                                           atol=TRAIN_ATOL)).sum())
            total = sum(got_snap[k].numel() for k in ("w", "v"))
            if name == "exact" and off:
                raise AssertionError(f"dp exact: {off} touched values differ "
                                     f"card vs cpu, max abs {max_abs}")
            if off > DP_CODE_FLIP_SHARE * total:
                raise AssertionError(f"dp {name}: {off} of {total} touched "
                                     f"values differ card vs cpu")
            runs[name] = {
                "steps": steps, "launches_per_rank": want,
                "loss_first": losses[:head], "loss_last": losses[-head:],
                "cpu_steps": len(cpu_losses),
                "loss_rel_err_vs_cpu": max(
                    abs(a - b) / abs(b) for a, b in
                    zip(losses, cpu_losses)),
                "touched_values": total, "touched_off_tolerance": off,
                "max_abs_err_vs_cpu": max_abs,
                "bytes_per_step": recs[0]["bytes_per_step"],
                "ranks_bit_identical": True}
            if "steady_wall_s" in recs[0]:
                steady = recs[0]["steady_steps"]
                runs[name]["step_ms"] = 1e3 * recs[0]["steady_wall_s"] / steady
                runs[name]["examples_per_s_gloo_host_staged"] = (
                    steady * TRAIN_BATCH / recs[0]["steady_wall_s"])
            if "profile" in recs[0]:
                prof = recs[0]["profile"]
                prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / \
                    runs[name]["step_ms"]
                runs[name]["profile_rank0"] = prof
        ev = card[0]["exact"]["heldout"]
        if not ev["auc"] > MIN_AUC:
            raise AssertionError(f"dp exact: held-out AUC {ev['auc']} <= "
                                 f"{MIN_AUC}")
        # the coded runs' final loss against the exact run's at the same
        # step.  The dynamic range stays within DP_LOSS_GAP; the fixed range
        # 1.0 with error feedback does not at this width, in the JAX package
        # as in the port (tools/torch_dp_loss_gap.py, PERF.md): its gap is
        # reported and the run is held to the CPU's plain versions above
        exact = card[0]["exact"]["losses"]
        for name in ("coded_dynamic", "coded_ef"):
            coded = card[0][name]["losses"]
            gap = abs(coded[-1] - exact[len(coded) - 1])
            runs[name]["final_loss_gap_vs_exact"] = gap
            runs[name]["final_loss_gap_vs_exact_cpu"] = abs(
                cpu[name]["losses"][-1] - card[0]["exact"]["losses"][
                    len(coded) - 1])
            if name == "coded_dynamic" and not gap < DP_LOSS_GAP:
                raise AssertionError(f"dp {name}: final loss {coded[-1]} vs "
                                     f"exact {exact[len(coded) - 1]}")
        want = dp_expected_launches("coded_ef", 1)
        got = {k: nccl["launches"].get(k, 0) for k in want}
        if got != want or nccl["merge_apply_variants"] != {
                "merge": want["merge_apply"]} or not np.isfinite(nccl["losses"][0]) or \
                nccl["backend"] != "nccl" or not nccl["device"].startswith(
                    "cuda"):
            raise AssertionError(f"dp nccl W=1: {nccl}")
        launches = {k: sum(card[0][n]["launches"].get(k, 0) for n in names)
                    for k in sk.KERNELS}
        merge_variants = {"merge": sum(
            card[0][n]["merge_apply_variants"].get("merge", 0)
            for n in names)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "dp", "model": "fm", "world": DP_WORLD,
            "backend": "gloo (host-staged), all ranks on cuda:0",
            "batch": TRAIN_BATCH, "local_rows": DP_LOCAL_ROWS,
            "local_k": DP_LOCAL_K, "vocab": VOCAB, "factor_dim": DIM,
            "runs": runs, "heldout": ev, "heldout_rows": EVAL_ROWS,
            "nccl_w1": {"loss": nccl["losses"][0],
                        "launches": nccl["launches"], "device": nccl["device"]},
            "seconds": {"card_world": card_s, "cpu_world": cpu_s,
                        "nccl_world": nccl_s},
            "dp_launches_rank0": launches,
            "dp_merge_apply_variants_rank0": merge_variants}


# -- phase: attention ---------------------------------------------------------


def ring_rank(rank, world, out_dir, seed):
    """One rank of the attention phase: ``ring_self_attention`` over a
    ``seq`` mesh of the world on this rank's card, on the phase's inputs;
    writes its output, its step time and (rank 0) a profile of two more
    calls to ``out_dir``."""
    import torch

    from lightctr_tpu_torch.core.mesh import MeshSpec, make_mesh
    from lightctr_tpu_torch.nn.ring_attention import ring_self_attention

    mesh = make_mesh(MeshSpec(seq=world), device="cuda")
    torch.cuda.set_device(mesh.device)
    q, k, v = flash_inputs(torch, FLASH_PATH_SHAPE, torch.bfloat16, seed)
    out = ring_self_attention(mesh, q, k, v, causal=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        ring_self_attention(mesh, q, k, v, causal=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_ms = 1e3 * statistics.median(times)
    calls = [lambda: ring_self_attention(mesh, q, k, v, causal=True)] * 2
    prof = None
    if rank == 0:
        prof = profile_calls(torch, calls)
        prof["idle_share"] = 1.0 - prof["device_ms_per_step"] / step_ms
    else:
        for call in calls:
            call()
        torch.cuda.synchronize()
    # the backward: the gradients of sum(out ** 2) in q, k and v
    leaves = [x.requires_grad_(True) for x in flash_inputs(
        torch, RING_GRAD_SHAPE, torch.float32, seed + 1)]
    (ring_self_attention(mesh, *leaves, causal=True) ** 2).sum().backward()
    torch.cuda.synchronize()
    torch.save({"out": out.cpu(), "axis": mesh.axis, "device":
                str(mesh.device), "backend": mesh.backend,
                "step_ms": step_ms, "profile": prof,
                "grads": [x.grad.cpu() for x in leaves]},
               os.path.join(out_dir, f"ring{rank}.pt"))


def phase_attention(torch, sk, fl, seed) -> dict:
    """The long-context path: flash attention on the card, then ring
    attention over RING_WORLD ranks sharing it (gloo), on one input."""
    import shutil
    import tempfile

    from lightctr_tpu_torch.core.mesh import spawn_world

    q, k, v = flash_inputs(torch, FLASH_PATH_SHAPE, torch.bfloat16, seed)
    sk.reset_launches()
    flash = fl.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = sk.launches()
    route = sk.variant_launches("flash_attention")
    if launches["flash_attention"] < 1:
        raise AssertionError(f"attention: flash_attention launched "
                             f"{launches['flash_attention']} times")
    if route != {"wgmma": launches["flash_attention"]}:
        raise AssertionError(f"attention: the path's bf16 call ran {route}, "
                             "not the wgmma design")
    # the kernel has no backward: inputs that require grad are refused
    try:
        fl.flash_attention(q.clone().requires_grad_(True), k, v, causal=True)
        raise AssertionError("attention: flash_attention took bf16 inputs "
                             "that require grad")
    except RuntimeError as e:
        if "full_attention" not in str(e):
            raise
        grad_refusal = str(e)
    root = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    try:
        t = time.perf_counter()
        spawn_world(ring_rank, RING_WORLD, "gloo", deadline_s=DP_DEADLINE_S,
                    args=(root, seed))
        ring_s = time.perf_counter() - t
        recs = [torch.load(os.path.join(root, f"ring{r}.pt"))
                for r in range(RING_WORLD)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r, rec in enumerate(recs):
        if not torch.equal(rec["out"], recs[0]["out"]):
            raise AssertionError(f"attention: ring rank {r}'s output differs "
                                 "from rank 0's")
        if rec["axis"] != "seq" or not rec["device"].startswith("cuda"):
            raise AssertionError(f"attention: ring rank {r}: {rec}")
    ring = recs[0]["out"].cuda()
    if ring.dtype != flash.dtype or ring.shape != flash.shape:
        raise AssertionError(f"attention: ring {ring.dtype} "
                             f"{tuple(ring.shape)} vs flash {flash.dtype} "
                             f"{tuple(flash.shape)}")
    err = (ring.float() - flash.float()).abs()
    emax, emean = float(err.max()), float(err.mean())
    if emax > FLASH_16_MAX or emean > FLASH_16_MEAN:
        raise AssertionError(f"attention: ring vs flash max {emax}, mean "
                             f"{emean}")
    # the ring's gradients on every rank against full attention's autograd
    from lightctr_tpu_torch.nn.ring_attention import full_attention
    leaves = [x.requires_grad_(True) for x in flash_inputs(
        torch, RING_GRAD_SHAPE, torch.float32, seed + 1)]
    (full_attention(*leaves, causal=True) ** 2).sum().backward()
    grad_err = 0.0
    for r, rec in enumerate(recs):
        for name, got, want in zip("qkv", rec["grads"], leaves):
            want = want.grad.cpu()
            if not torch.allclose(got, want, rtol=RING_GRAD_RTOL,
                                  atol=RING_GRAD_ATOL):
                raise AssertionError(
                    f"attention: ring rank {r}'s d{name} vs full attention: "
                    f"max {float((got - want).abs().max())}")
            grad_err = max(grad_err, float((got - want).abs().max()))
    return {"phase": "attention", "shape": list(FLASH_PATH_SHAPE),
            "dtype": "bfloat16", "causal": True, "launches": launches,
            "flash_route": route,
            "ring": {"world": RING_WORLD, "backend": recs[0]["backend"],
                     "devices": [rec["device"] for rec in recs],
                     "step_ms_rank0": recs[0]["step_ms"],
                     "profile_rank0": recs[0]["profile"],
                     "world_seconds": ring_s},
            "ring_vs_flash": {"max_abs_err": emax, "mean_abs_err": emean,
                              "tolerance": [FLASH_16_MAX, FLASH_16_MEAN]},
            "ring_grads_vs_full_attention": {
                "shape": list(RING_GRAD_SHAPE), "dtype": "float32",
                "causal": True, "max_abs_err": grad_err,
                "tolerance": [RING_GRAD_RTOL, RING_GRAD_ATOL]},
            "flash_grad_refusal": grad_refusal,
            "ranks_equal": True}


# -- phase: bench -------------------------------------------------------------


def phase_bench(torch, sk) -> dict:
    """The port's two kernel benches, on the card, writing no file: every
    cell's kernel launched, as its launch count says."""
    from lightctr_tpu_torch.tools import kernel_bench, sparse_kernel_bench

    sk.reset_launches()
    sparse = sparse_kernel_bench.run(device="cuda", out=None)
    kern = kernel_bench.run(device="cuda", out=None)
    launches = sk.launches()
    cells = sparse["cells"] + kern["adagrad"] + kern["flash"]
    for c in cells:
        name = c["kernel"]
        if c.get("impl_kernel", c.get("impl")) != "cuda" or \
                launches[name] < 1:
            raise AssertionError(f"bench: {name} did not launch ({c})")
    merge_variants = sk.variant_launches("merge_apply")
    if merge_variants.get("merge", 0) < 1:
        raise AssertionError(f"bench: merge_apply's cell ran {merge_variants}"
                             ", not its fused merge mode")
    return {"phase": "bench", "launches": launches,
            "merge_apply_variants": merge_variants,
            "sparse_kernel_bench": sparse, "kernel_bench": kern}


# -- phase: timing ------------------------------------------------------------


def graph_ms(torch, fn, reps: int = 100, repeats: int = 7) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in one
    CUDA graph (so host launch overhead does not hide the device time),
    replayed ``repeats`` times between CUDA events; median per call."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


#: bytes a cold timing reads between two calls: four times the H100's
#: 50 MB L2, so none of the last call's lines are left in it
L2_FLUSH_BYTES = 4 * 50 * (1 << 20)


def cold_ms(torch, fn, reps: int = 20, repeats: int = 7) -> float:
    """Device time of one ``fn()`` call on a cold L2.  ``graph_ms`` replays
    a call on the lines its last call left in the 50 MB L2, which holds a
    working set of up to that size; here each call follows a read of
    ``L2_FLUSH_BYTES``.  One CUDA graph holds ``reps`` (read, call) pairs,
    another the ``reps`` reads alone; both are replayed in turn
    ``repeats`` times between CUDA events, and the median difference per
    call is the call's time."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            flush.sum()
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graphs = []
    for with_call in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.sum()
                if with_call:
                    fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()

    def replay_ms(g):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    per = [(replay_ms(graphs[0]) - replay_ms(graphs[1])) / reps
           for _ in range(repeats)]
    return statistics.median(per)


def call_ms(torch, fn, reps: int = 200) -> float:
    """Time of one eager call, host included: ``reps`` calls back to
    back between CUDA events after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_row(sk, name, **fields) -> dict:
    kd = sk.KERNELS[name]
    return {"name": name, "route": "cuda",
            "source": os.path.join("lightctr_tpu_torch", "csrc", kd.source),
            "replaces": kd.replaces, **fields}


def bound_ms(nbytes) -> float:
    return 1e3 * nbytes / HBM_BYTES_PER_S


def bound_ms_ops(nbytes, flops):
    """(bound in ms, what bounds it): the larger of the bytes at 3.35 TB/s
    and the bf16 FLOPs at 989 TFLOP/s."""
    by_bytes, by_ops = bound_ms(nbytes), 1e3 * flops / BF16_FLOPS_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                               "bytes")


def gather_timing(torch, sk, serve_ns, launches, max_abs_err) -> dict:
    n = max(serve_ns)
    gen = torch.Generator(device="cuda").manual_seed(99)
    block = torch.randn((CACHE_ROWS, ROW_DIM), generator=gen, device="cuda")
    idx = torch.randint(0, CACHE_ROWS, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if not torch.equal(sk.gather_rows(block, idx),
                       sk.gather_rows_plain(block, idx)):
        raise AssertionError("gather_rows kernel != plain at the serve shape")
    # bytes this call needs: the distinct rows it reads, the indices, the
    # rows it writes
    n_read = int(torch.unique(idx).numel())
    nbytes = n_read * ROW_DIM * 4 + n * 4 + n * ROW_DIM * 4
    kernel_ms = graph_ms(torch, lambda: sk.gather_rows(block, idx))
    return kernel_row(
        sk, "gather_rows", launches=launches["gather_rows"],
        max_abs_err=max_abs_err,
        shape={"rows": CACHE_ROWS, "d": ROW_DIM, "n": n},
        ms=kernel_ms, kernel_ms=kernel_ms,
        plain_ms=graph_ms(torch, lambda: sk.gather_rows_plain(block, idx)),
        bound_ms=bound_ms(nbytes), bound_by="bytes",
        library_ms=graph_ms(torch, lambda: block.index_select(0, idx)),
        library_call="torch.index_select",
        call_ms=call_ms(torch, lambda: sk.gather_rows(block, idx)),
        bytes=nbytes)


def train_timing(np, torch, sk, fa, seed, launches, kern) -> list:
    """dedup_ids, merge_apply and fused_adagrad at the train path's shapes:
    one batch's K = 159,744 ids, its uids against the 2^20-row tables, and
    the flat w (2^20) and v (2^25) leaves."""
    rng = np.random.default_rng(seed + 5)
    ids = torch.from_numpy(criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)) \
        .cuda()
    k = ids.numel()
    uids, _, count = sk.dedup_ids(ids)
    real = int(count)  # non-pad slots: the distinct ids, id 0 included
    gen = torch.Generator(device="cuda").manual_seed(5)

    def unique_call():
        return torch.unique(ids, sorted=True, return_inverse=True)

    dedup_ms = graph_ms(torch, lambda: sk.dedup_ids(ids))
    rows = [kernel_row(
        sk, "dedup_ids", launches=launches["dedup_ids"],
        max_abs_err=kern["dedup_ids"]["max_abs_err"],
        shape={"k": k, "size": k, "distinct": int(count)},
        ms=dedup_ms, kernel_ms=dedup_ms,
        plain_ms=call_ms(torch, lambda: sk.dedup_ids_plain(ids, k), reps=50),
        plain_timing="eager between events: torch.unique syncs to size its "
                     "output, so it cannot be graph-captured",
        bound_ms=bound_ms(12 * k), bound_by="bytes",
        bound_note="12*K bytes (ids read, inv and uids written): a lower "
                   "bound that no sort reaches",
        library_ms=call_ms(torch, unique_call, reps=50),
        library_call="torch.unique(sorted=True, return_inverse=True), "
                     "eager between events (it syncs)",
        call_ms=call_ms(torch, lambda: sk.dedup_ids(ids)),
        bytes=12 * k)]

    per_shape = []
    for d in (1, DIM):
        shape = (VOCAB,) if d == 1 else (VOCAB, d)
        table = torch.randn(shape, generator=gen, device="cuda")
        accum = torch.rand(shape, generator=gen, device="cuda")
        grads = torch.randn((k,) + shape[1:], generator=gen, device="cuda")
        # touched rows' w and a read and written, their gradient rows and
        # all S uids read; a pad slot (uid 0 past slot 0) reads its uid and
        # skips its gradient row
        nbytes = real * d * 4 * 4 + real * d * 4 + k * 4
        per_shape.append({
            "d": d, "vocab": VOCAB, "s": k, "s_real": real,
            "ms": graph_ms(torch, lambda: sk.merge_apply(
                table, accum, uids, grads, lr=LR, eps=EPS)),
            "cold_ms": cold_ms(torch, lambda: sk.merge_apply(
                table, accum, uids, grads, lr=LR, eps=EPS)),
            "plain_ms": call_ms(torch, lambda: sk.merge_apply_plain(
                table, accum, uids, grads, None, LR, EPS, 1.0), reps=50),
            "call_ms": call_ms(torch, lambda: sk.merge_apply(
                table, accum, uids, grads, lr=LR, eps=EPS)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes})
    big = per_shape[-1]
    rows.append(kernel_row(
        sk, "merge_apply", launches=launches["merge_apply"],
        max_abs_err=kern["merge_apply"]["max_abs_err"],
        max_ulp=kern["merge_apply"]["max_ulp"],
        shape={"vocab": VOCAB, "d": DIM, "s": k, "s_real": real},
        ms=big["ms"], kernel_ms=big["ms"], cold_ms=big["cold_ms"],
        plain_ms=big["plain_ms"],
        plain_timing="eager between events: its dedup_grads runs "
                     "torch.unique, which syncs",
        bound_ms=big["bound_ms"], bound_by="bytes", library_ms=None,
        library_note="no single PyTorch call computes a touched-row "
                     "scatter Adagrad apply",
        call_ms=big["call_ms"], bytes=big["bytes"], per_shape=per_shape))

    per_shape = []
    for n in (VOCAB, VOCAB * DIM):
        w = torch.randn(n, generator=gen, device="cuda")
        a = torch.rand(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda")
        per_shape.append({
            "n": n,
            "ms": graph_ms(torch, lambda: fa.fused_adagrad_update(
                w, a, g, LR, EPS)),
            "plain_ms": graph_ms(torch, lambda: fa.fused_adagrad_plain(
                w, a, g, LR, EPS)),
            "call_ms": call_ms(torch, lambda: fa.fused_adagrad_update(
                w, a, g, LR, EPS)),
            "bound_ms": bound_ms(5 * n * 4), "bytes": 5 * n * 4})
    big = per_shape[-1]
    rows.append(kernel_row(
        sk, "fused_adagrad", launches=launches["fused_adagrad"],
        max_abs_err=kern["fused_adagrad"]["max_abs_err"],
        max_ulp=kern["fused_adagrad"]["max_ulp"],
        shape={"n": VOCAB * DIM},
        ms=big["ms"], kernel_ms=big["ms"], plain_ms=big["plain_ms"],
        bound_ms=big["bound_ms"], bound_by="bytes", library_ms=None,
        library_note="no single PyTorch call computes Adagrad with eps "
                     "inside the sqrt (torch.optim.Adagrad adds it outside)",
        call_ms=big["call_ms"], bytes=big["bytes"], per_shape=per_shape))
    return rows


def dp_timing(np, torch, sk, qz, seed, launches, kern):
    """merge_rows, merge_apply's merge mode, quantize_pack and
    quantize_pack_ef_update at the dp path's shapes (one rank's K = 79,872
    ids and [K, 32] payload, the W*K = 159,744 gathered rows, V = 2^20
    tables), and dedup_ids on the int64 form of one train batch's ids.
    Returns the new kernels' rows and the extra fields of the dedup_ids and
    merge_apply rows."""
    rng = np.random.default_rng(seed + 6)
    all_ids, uniq, inv, real, pad, per_rank = gathered_stream(
        np, torch, sk, rng)
    uids_l, _, count_l = per_rank[0]
    m, k = all_ids.numel(), uids_l.numel()
    gen = torch.Generator(device="cuda").manual_seed(31)
    # each rank's dedup padding (id 0 past its slot 0) carries zero rows in
    # the exact exchange, CODED_PAD in the coded ones
    rows = torch.randn((m, DIM), generator=gen, device="cuda") * 0.05 \
        * (1 - pad)
    rows_coded = rows + CODED_PAD * pad
    out = []

    # merge_rows and merge_apply's merge mode: the gathered rows merged
    # onto the union's slots, at d = 32 (the v table) and d = 1 (w); the
    # dp path launches each width once a step
    per_d, merge_mode = [], []
    for d in (DIM, 1):
        rows_d = rows if d == DIM else rows[:, 0].contiguous()
        flat = rows_d.reshape(m, d)
        nbytes = m * d * 4 + m * 4 + m * d * 4
        per_d.append({
            "d": d, "m": m, "nseg": m, "distinct": real,
            "ms": graph_ms(torch, lambda: sk.merge_rows(flat, inv, m)),
            "plain_ms": call_ms(torch, lambda: sk.merge_rows_plain(
                flat, inv, m), reps=3),
            "library_ms": graph_ms(torch, lambda: torch.zeros(
                (m, d), device="cuda").index_add_(0, inv, flat)),
            "call_ms": call_ms(torch, lambda: sk.merge_rows(flat, inv, m)),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "bytes": nbytes, "launches": launches["merge_rows"],
            "profile": launch_profile(
                torch, lambda: sk.merge_rows(flat, inv, m))})
        shape = (VOCAB, d) if d > 1 else (VOCAB,)
        table = torch.randn(shape, generator=gen, device="cuda")
        accum = torch.rand(shape, generator=gen, device="cuda")
        nbytes = (m * d * 4 + m * 4 + m * 4
                  + real * d * 4 * 4)
        # the exact exchange's zero padding rows, dropped by the key pass,
        # and the coded exchanges' CODED_PAD ones, one long run
        for pads, src in (("zero", rows), ("coded", rows_coded)):
            rows_d = src if d == DIM else src[:, 0].contiguous()
            merge_mode.append({
                "d": d, "pads": pads, "m": m, "s": m, "s_real": real,
                "ms": graph_ms(torch, lambda: sk.merge_apply(
                    table, accum, uniq, rows_d, inv, lr=LR, eps=EPS,
                    denom=float(DP_WORLD))),
                "plain_ms": call_ms(torch, lambda: sk.merge_apply_plain(
                    table, accum, uniq, rows_d, inv, LR, EPS,
                    float(DP_WORLD)), reps=3),
                "call_ms": call_ms(torch, lambda: sk.merge_apply(
                    table, accum, uniq, rows_d, inv, lr=LR, eps=EPS,
                    denom=float(DP_WORLD))),
                "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                "bytes": nbytes, "library_ms": None,
                "library_note": "no single PyTorch call merges and applies "
                                "a touched-row Adagrad",
                "profile": launch_profile(torch, lambda: sk.merge_apply(
                    table, accum, uniq, rows_d, inv, lr=LR, eps=EPS,
                    denom=float(DP_WORLD))),
                "max_ulp": kern["merge_apply_merge_mode"]["max_ulp"],
                "max_abs_err":
                    kern["merge_apply_merge_mode"]["max_abs_err"]})
        del table, accum
    head = per_d[0]
    out.append(kernel_row(
        sk, "merge_rows", launches=launches["merge_rows"],
        launches_note="0 on the dp path since merge_apply fuses the merge; "
                      "the bench phase and the collectives' sparse "
                      "all-reduce launch it",
        max_abs_err=kern["merge_rows"]["max_abs_err"],
        shape={"m": m, "d": DIM, "nseg": m, "distinct": real},
        ms=head["ms"], plain_ms=head["plain_ms"],
        plain_timing="eager between events: its rounds sync to count them",
        library_ms=head["library_ms"],
        library_call="torch.zeros(...).index_add_ (atomics: a sum order "
                     "that is not the slot order)",
        bound_ms=head["bound_ms"], bound_by="bytes", bytes=head["bytes"],
        call_ms=head["call_ms"], per_shape=per_d))
    # quantize_pack: one rank's [K, 32] payload, 8 bits normal (the
    # default table), a measured range; 16 bits uniform beside it
    x = torch.randn((k, DIM), generator=gen, device="cuda") * 0.05
    per_shape = []
    for bits, mode in ((8, "normal"), (16, "uniform")):
        lim = 1.05 * x.abs().max()
        table_q = qz.build_table(-lim, lim, bits=bits, mode=mode)
        nbytes = x.numel() * (4 + (1 if bits <= 8 else 2))
        per_shape.append({
            "bits": bits, "mode": mode, "n": x.numel(),
            "ms": graph_ms(torch, lambda: sk.quantize_pack(table_q, x)),
            "plain_ms": graph_ms(torch,
                                 lambda: sk.quantize_pack_plain(table_q, x)),
            "library_ms": graph_ms(torch, lambda: torch.searchsorted(
                table_q.boundaries, x)),
            "call_ms": call_ms(torch, lambda: sk.quantize_pack(table_q, x)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes})
    head = per_shape[0]
    out.append(kernel_row(
        sk, "quantize_pack", launches=launches["quantize_pack"],
        max_abs_err=kern["quantize_pack"]["max_abs_err"],
        shape={"n": x.numel(), "bits": 8, "mode": "normal"},
        ms=head["ms"], plain_ms=head["plain_ms"],
        library_ms=head["library_ms"],
        library_call="torch.searchsorted (int64 indices, no cast)",
        bound_ms=head["bound_ms"], bound_by="bytes", bytes=head["bytes"],
        call_ms=head["call_ms"], per_shape=per_shape))

    # quantize_pack_ef_update: one rank's deduped uids into a [V, 32]
    # carry (the v table's) and a [V] one (w's), fixed range 1.0, 8 bits
    # normal
    table_q = qz.build_table(-1.0, 1.0, bits=8, mode="normal", device="cuda")
    mask = (~((uids_l == 0) & (torch.arange(k, device="cuda") > 0))) \
        .to(torch.float32).reshape(-1, 1)
    real_l = int(count_l)
    per_shape = []
    for d in (1, DIM):
        shape = (VOCAB,) if d == 1 else (VOCAB, d)
        residual = torch.zeros(shape, device="cuda")
        mask_d = mask.reshape(-1) if d == 1 else mask
        g = torch.randn((k,) + shape[1:], generator=gen, device="cuda") \
            * mask_d
        # rows and uid/mask read, the real slots' carries read and
        # written, codes and dec written
        nbytes = (k * d * 4 + real_l * d * 4 + k * 8
                  + k * d * (1 + 4) + real_l * d * 4)
        per_shape.append({
            "d": d, "s": k, "s_real": real_l, "vocab": VOCAB, "bits": 8,
            "ms": graph_ms(torch, lambda: sk.quantize_pack_ef_update(
                table_q, g, uids_l, residual, mask_d)),
            "cold_ms": cold_ms(torch, lambda: sk.quantize_pack_ef_update(
                table_q, g, uids_l, residual, mask_d)),
            "plain_ms": call_ms(
                torch, lambda: sk.quantize_pack_ef_update_plain(
                    table_q, g, uids_l, residual, mask_d), reps=20),
            "call_ms": call_ms(torch, lambda: sk.quantize_pack_ef_update(
                table_q, g, uids_l, residual, mask_d)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes})
        del residual, g
    big = per_shape[-1]
    out.append(kernel_row(
        sk, "quantize_pack_ef_update",
        launches=launches["quantize_pack_ef_update"],
        max_abs_err=kern["quantize_pack_ef_update"]["max_abs_err"],
        shape={"s": k, "s_real": real_l, "d": DIM, "vocab": VOCAB,
               "bits": 8},
        ms=big["ms"], cold_ms=big["cold_ms"], plain_ms=big["plain_ms"],
        plain_timing="eager between events: its scatter selects the "
                     "in-table slots, which syncs",
        library_ms=None,
        library_note="no single PyTorch call computes an EF-compensated "
                     "quantile encode with the carry scattered back",
        bound_ms=big["bound_ms"], bound_by="bytes", bytes=big["bytes"],
        call_ms=big["call_ms"], per_shape=per_shape))

    # dedup_ids on int64 ids: one train batch's Criteo ids, widened
    ids64 = torch.from_numpy(criteo_fids(np, rng, TRAIN_BATCH).reshape(-1)
                             .astype(np.int64)).cuda()
    dedup64 = {"k": ids64.numel(),
               "ms": graph_ms(torch, lambda: sk.dedup_ids(ids64)),
               "library_ms": call_ms(torch, lambda: torch.unique(
                   ids64, sorted=True, return_inverse=True), reps=50),
               "bound_ms": bound_ms(20 * ids64.numel())}
    return out, {"int64": dedup64}, {"merge_mode": merge_mode}


def new_timing(torch, sk, fl, qz, seed, launches, kern, route) -> list:
    """quantize_pack_ef on the [79,872, 32] payload (8 bits, a [P, 1]
    mask: one dp rank's layout) and flash_attention at the attention
    path's shape, with the bench's other shapes beside it."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.randn((DP_LOCAL_K, DIM), generator=gen, device="cuda") * 0.05
    car = torch.randn((DP_LOCAL_K, DIM), generator=gen, device="cuda") * 0.01
    mask = torch.ones((DP_LOCAL_K, 1), device="cuda")
    table = qz.build_table(-1.0, 1.0, bits=8, mode="normal", device="cuda")
    n = x.numel()
    nbytes = n * (4 + 4 + 1 + 4) + DP_LOCAL_K * 4
    rows = [kernel_row(
        sk, "quantize_pack_ef", launches=launches["quantize_pack_ef"],
        launches_on="bench phase (its only caller, as in the JAX package)",
        max_abs_err=kern["quantize_pack_ef"]["max_abs_err"],
        shape={"p": DP_LOCAL_K, "d": DIM, "bits": 8, "mask": [DP_LOCAL_K, 1]},
        ms=graph_ms(torch, lambda: sk.quantize_pack_ef(table, x, car, mask)),
        plain_ms=graph_ms(torch, lambda: sk.quantize_pack_ef_plain(
            table, x, car, mask)),
        library_ms=None,
        library_note="no single PyTorch call computes an EF-compensated "
                     "quantile encode with its fresh error",
        bound_ms=bound_ms(nbytes), bound_by="bytes", bytes=nbytes,
        call_ms=call_ms(torch, lambda: sk.quantize_pack_ef(table, x, car,
                                                           mask)))]

    per_shape = []
    timed = [(shape, True) for shape in FLASH_BENCH_SHAPES]
    timed += list(FLASH_EXTRA_TIMED)
    for i, (shape, causal) in enumerate(timed):
        b, t, h, d = shape
        q, k, v = flash_inputs(torch, shape, torch.bfloat16, seed + 200 + i)
        qt, kt, vt = (y.transpose(1, 2).contiguous() for y in (q, k, v))
        # causal: the lower triangle's products (T^2/2 of them)
        flops = 4 * b * h * t * t * d / (2 if causal else 1)
        nbytes = 4 * q.numel() * 2
        bound, by = bound_ms_ops(nbytes, flops)
        kms = graph_ms(torch, lambda: fl.flash_attention(q, k, v,
                                                         causal=causal),
                       reps=20)
        per_shape.append({
            "shape": list(shape), "causal": causal,
            "design": fl.flash_route(q, k, v), "ms": kms,
            "plain_ms": call_ms(torch, lambda: fl.flash_attention_plain(
                q, k, v, causal), reps=5),
            "library_ms": graph_ms(
                torch, lambda: torch.nn.functional
                .scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                reps=20),
            "call_ms": call_ms(torch, lambda: fl.flash_attention(
                q, k, v, causal=causal), reps=20),
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes, "tflops": flops / (kms / 1e3) / 1e12})
        del q, k, v, qt, kt, vt
    main = per_shape[[(tuple(p["shape"]), p["causal"]) for p in per_shape]
                     .index((FLASH_PATH_SHAPE, True))]
    rows.append(kernel_row(
        sk, "flash_attention", launches=launches["flash_attention"],
        launches_on="attention phase",
        max_abs_err=kern["flash_attention"]["max_abs_err"],
        shape={"bthd": list(FLASH_PATH_SHAPE), "dtype": "bfloat16",
               "causal": True},
        design=main["design"], design_launches=route,
        ms=main["ms"], plain_ms=main["plain_ms"],
        plain_timing="eager between events (float32 full_attention)",
        library_ms=main["library_ms"],
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True) on [B, H, T, D] copies",
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        flops=main["flops"], bytes=main["bytes"], tflops=main["tflops"],
        call_ms=main["call_ms"], per_shape=per_shape))
    return rows


# -- main ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "lightctr_tpu_torch")):
        print("chip_smoke: lightctr_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from lightctr_tpu_torch.native import bindings
    from lightctr_tpu_torch.nn import flash_attention as fl
    from lightctr_tpu_torch.ops import sparse_kernels as sk
    from lightctr_tpu_torch.optim import fused_adagrad as fa

    from lightctr_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit(phase_build(sk, bindings) | {"nvidia_smi": smi})
    requests = make_requests(np, args.seed)
    serve_ns = serve_gather_ns(np, sk, requests)
    krng = np.random.default_rng(args.seed + 4)
    kern = phase_kernels(torch, sk, serve_ns)
    kern["dedup_ids"] = check_dedup(np, torch, sk, krng)
    kern["dedup_ids_int64"] = check_dedup64(np, torch, sk, krng)
    kern["merge_apply"] = check_merge_apply(np, torch, sk, krng)
    kern["merge_apply_merge_mode"] = check_merge_apply_merge_mode(
        np, torch, sk, krng)
    kern["merge_rows"] = check_merge_rows(np, torch, sk, krng)
    kern["quantize_pack"] = check_quantize_pack(np, torch, sk, qz)
    kern["quantize_pack_ef_update"] = check_quantize_pack_ef_update(
        np, torch, sk, qz, krng)
    kern["fused_adagrad"] = check_fused_adagrad(torch, fa)
    kern["quantize_pack_ef"] = check_quantize_pack_ef(np, torch, sk, qz)
    kern["flash_attention"] = check_flash(torch, sk, fl)
    emit(kern)
    serve_info = phase_serve(np, torch, sk, args.seed, requests)
    emit(serve_info | {"serve_gather_ns": serve_ns, "nvidia_smi": smi})
    train_info = phase_train(np, torch, sk, args.seed)
    emit(train_info | {"nvidia_smi": smi})
    dp_info = phase_dp(np, torch, sk, args.seed)
    emit(dp_info | {"nvidia_smi": smi})
    attn_info = phase_attention(torch, sk, fl, args.seed)
    emit(attn_info | {"nvidia_smi": smi})
    bench_info = phase_bench(torch, sk)
    emit(bench_info | {"nvidia_smi": smi})
    rows = [gather_timing(torch, sk, serve_ns, serve_info["launches"],
                          kern["gather_rows"]["max_abs_err"])]
    rows += train_timing(np, torch, sk, fa, args.seed,
                         train_info["train_launches"], kern)
    new_rows, dedup_extra, merge_extra = dp_timing(
        np, torch, sk, qz, args.seed, dp_info["dp_launches_rank0"], kern)
    for row in rows:
        if row["name"] == "dedup_ids":
            row.update(dedup_extra,
                       launches_dp=dp_info["dp_launches_rank0"]["dedup_ids"])
        if row["name"] == "merge_apply":
            # the dp phase checks that every one ran the merge design
            row.update(merge_extra,
                       launches_dp=dp_info["dp_launches_rank0"]["merge_apply"],
                       launches_dp_note="merge mode, both widths together "
                                        "(each table merged once a step)")
    rows += new_rows
    rows += new_timing(torch, sk, fl, qz, args.seed, {
        "quantize_pack_ef": bench_info["launches"]["quantize_pack_ef"],
        "flash_attention": attn_info["launches"]["flash_attention"]}, kern,
        attn_info["flash_route"])
    for row in rows:
        row["launches_bench"] = bench_info["launches"].get(row["name"], 0)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
