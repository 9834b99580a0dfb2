#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lightctr_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``lightctr_tpu_torch/csrc``,
holds each against its plain PyTorch version, then serves FM at Criteo
width through the PS-backed ``PredictionServer`` and checks the scores.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

  build    nvcc of every kernel source (all started together) beside the
           g++ build of the native host codecs; seconds and ptxas summary.
  kernels  every kernel against its plain version on the card, bit-exact
           (``torch.equal``) over d in {1, 33, 128} x n in {1, 1000, 16384}
           and the serve path's own shape, R = 65536, with negative and
           >= R indices that exercise the clip.
  serve    FM, 39 fields (26 categorical + 13 numeric), vocabulary 2^20,
           factor dim 32: a port ``AsyncParamServer`` (rows ``[w | v]`` of
           width 33) behind ``ParamServerService``, a ``PredictionServer``
           on the card with its default 65536-row cache, 8 requests of 256
           rows sent twice through ``PredictClient``.  Every reply must be
           OK, scores within 2e-3 of a float64 numpy FM forward (the wire
           carries rows, values and scores in fp16), the cache block a
           CUDA tensor, hits > 0 on the second pass, and ``gather_rows``
           launched at least once per scored micro-batch.

Then a ``{"kernels": [...]}`` line: each kernel at the serve path's shape,
its launches on the serve path, its device time (``ms``, CUDA graph of
back-to-back calls), the plain version's, ``torch.index_select``'s (the
yardstick; the port never calls it), the eager per-call time with the host
(``call_ms``) and the bound from bytes at 3.35 TB/s.  Then the
``nvidia-smi`` name and power limit, and the last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises and exits non-zero; without CUDA, or without the
``lightctr_tpu_torch`` package beside this file, it exits 2 and prints no
result.
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


def phase_timing(torch, sk, serve_ns, launches, max_abs_err) -> list:
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
    kd = sk.KERNELS["gather_rows"]
    kernel_ms = graph_ms(torch, lambda: sk.gather_rows(block, idx))
    return [{
        "name": "gather_rows", "route": "cuda",
        "source": os.path.join("lightctr_tpu_torch", "csrc", kd.source),
        "replaces": kd.replaces,
        "launches": launches["gather_rows"],
        "max_abs_err": max_abs_err,
        "shape": {"rows": CACHE_ROWS, "d": ROW_DIM, "n": n},
        "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": graph_ms(torch, lambda: sk.gather_rows_plain(block, idx)),
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "bound_by": "bytes",
        "library_ms": graph_ms(torch, lambda: block.index_select(0, idx)),
        "call_ms": call_ms(torch, lambda: sk.gather_rows(block, idx)),
        "bytes": nbytes,
    }]


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit(phase_build(sk, bindings) | {"nvidia_smi": smi})
    requests = make_requests(np, args.seed)
    serve_ns = serve_gather_ns(np, sk, requests)
    kern = phase_kernels(torch, sk, serve_ns)
    emit(kern)
    serve_info = phase_serve(np, torch, sk, args.seed, requests)
    emit(serve_info | {"serve_gather_ns": serve_ns, "nvidia_smi": smi})
    emit({"kernels": phase_timing(torch, sk, serve_ns,
                                  serve_info["launches"],
                                  kern["gather_rows"]["max_abs_err"])})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
