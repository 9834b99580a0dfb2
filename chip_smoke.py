#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lightctr_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``lightctr_tpu_torch/csrc``,
holds each against its plain PyTorch version, serves FM at Criteo width
through the PS-backed ``PredictionServer`` and checks the scores, then
trains FM at Criteo width with ``SparseTableCTRTrainer`` and
``CTRTrainer(fused_adagrad=True)`` and checks the training.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

  build    nvcc of every kernel source (all started together) beside the
           g++ build of the native host codecs; seconds and ptxas summary.
  kernels  every kernel against its plain version on the card:
           gather_rows bit-exact (``torch.equal``) over d in {1, 33, 128}
           x n in {1, 1000, 16384} and the serve path's own shape,
           R = 65536, with negative and >= R indices that exercise the
           clip; dedup_ids bit-exact (uids, inv, count) at K in {1, 1000,
           159744} on Criteo id streams, negative ids and int32's limits,
           all-equal and all-zero streams, and with size < count;
           merge_apply within 2 ulp (table, accum) and rtol 1e-5 (sumsq)
           at V = 2^20, d in {1, 32}, S = 159744, uids of a real dedup
           with and without id 0, denom in {1, 4}; fused_adagrad within
           2 ulp at N in {1, 1001, 2^20, 2^25} and at a misaligned start.
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

Then a ``{"kernels": [...]}`` line: each kernel at its main path's shape,
its launches on that path, its device time (``ms``, CUDA graph of
back-to-back calls), the plain version's, one PyTorch library call's where
one computes the same function (the yardstick; the port never calls it),
the eager per-call time with the host (``call_ms``) and the bound from
bytes at 3.35 TB/s.  Then the ``nvidia-smi`` name and power limit, and the
last line ``{"ok": true, "device": {...}}``.  Any failed phase raises and
exits non-zero; without CUDA, or without the ``lightctr_tpu_torch`` package
beside this file, it exits 2 and prints no result.
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
    int32's limits, all-equal and all-zero, at each K in DEDUP_KS."""
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
    V = 2^20, d in {1, 32}, S = 159744 uids of a real dedup (Criteo ids
    hold id 0 about 3 % of the time; the other stream has none)."""
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
        for d in (1, DIM):
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
    """Device time by kernel over a few sparse steps (torch.profiler).
    The device's idle share rests on it, so a profile that shows no
    device time fails the phase."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            tr.train_step(b)
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
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"steps": len(batches), "profiled_wall_ms": wall_ms,
            "device_ms_per_step": busy_ms / len(batches),
            "device_ops_per_step": sum(r[2] for r in rows) / len(batches),
            "top": [{"name": k[:60], "ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:14]]}


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
        ms=big["ms"], kernel_ms=big["ms"], plain_ms=big["plain_ms"],
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
    from lightctr_tpu_torch.ops import sparse_kernels as sk
    from lightctr_tpu_torch.optim import fused_adagrad as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit(phase_build(sk, bindings) | {"nvidia_smi": smi})
    requests = make_requests(np, args.seed)
    serve_ns = serve_gather_ns(np, sk, requests)
    krng = np.random.default_rng(args.seed + 4)
    kern = phase_kernels(torch, sk, serve_ns)
    kern["dedup_ids"] = check_dedup(np, torch, sk, krng)
    kern["merge_apply"] = check_merge_apply(np, torch, sk, krng)
    kern["fused_adagrad"] = check_fused_adagrad(torch, fa)
    emit(kern)
    serve_info = phase_serve(np, torch, sk, args.seed, requests)
    emit(serve_info | {"serve_gather_ns": serve_ns, "nvidia_smi": smi})
    train_info = phase_train(np, torch, sk, args.seed)
    emit(train_info | {"nvidia_smi": smi})
    rows = [gather_timing(torch, sk, serve_ns, serve_info["launches"],
                          kern["gather_rows"]["max_abs_err"])]
    rows += train_timing(np, torch, sk, fa, args.seed,
                         train_info["train_launches"], kern)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
