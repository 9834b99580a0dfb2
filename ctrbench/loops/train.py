"""Closed-loop training: the timed window drives the system's
``train_step`` back to back over host numpy batches, as ``fit`` does.

Set-up (``setup_s``: from the process's start to the first timed step)
makes the parameters on the device from the seed, the pool of rows, the
trainer, then runs the check's first steps and the warm-up through the
same ``train_step`` call the window makes.  The window enqueues steps as
the host can for ``seconds`` and ends in ``torch.cuda.synchronize()``;
after each step a CUDA event is recorded (no sync), and the intervals
between consecutive events give ``step_ms_p95``.

With ``trace`` the same window runs unprofiled first (the host clock
around each call, the step time), then a few steps under the profiler
with the program's spans on (``obs.trace`` rate 1); its summary feeds the
per-layer metrics.

Once the timed work is done, the peak memory read and the trainer freed,
the plain reference repeats the check's steps from the same parameters and
rows, and ``check.py`` compares.
"""

from __future__ import annotations

import gc
import math
import statistics
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ctrbench import check, devtrace, generate, roofline


def _host_copy(tree: Dict) -> Dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values: List[float]) -> float:
    """The 95th percentile of all values (linear between order
    statistics)."""
    if len(values) < 2:
        return float(values[0]) if values else math.nan
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def timed_window(trainer, batches, start: int, seconds: float,
                 device) -> Dict:
    """Steps back to back from batch ``start`` until ``seconds`` have
    passed on the host clock, then a synchronize."""
    cuda = device.type == "cuda"
    marks, host, losses = [], [], []
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    t0 = time.perf_counter()
    if not cuda:
        marks.append(t0)
    deadline = t0 + seconds
    i = start
    while True:
        th = time.perf_counter()
        losses.append(trainer.train_step(batches[i]))
        t = time.perf_counter()
        host.append(t - th)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(t)
        i += 1
        if t >= deadline:
            break
    _sync(device)
    wall = time.perf_counter() - t0
    if cuda:
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        intervals = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return {"steps": i - start, "wall_s": wall, "host_s": host,
            "intervals_ms": intervals, "losses": losses, "next": i}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _device_batch(batch: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def setup(cell, seed: int, device) -> Dict:
    """Everything before the window: the parameters and the pool from the
    seed, the trainer, and the check's first steps through the window's
    own call and feed, with the program's state read after the first step
    and after the last."""
    cfg, traffic = cell.config, cell.traffic
    system = cell.module("systems", cfg["model"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    params0 = cell.module("reference", cfg["name"]).init_params(
        generate.generator(seed, device), cfg)
    pool = system.prepare(generate.make_pool(traffic, cfg, seed, device),
                          cfg)
    batches = generate.Batches(pool, traffic["batch"])
    trainer = system.build(params0, cfg, traffic, device)
    prog = {"losses": [], "accum1": None, "params": None}
    for i in range(int(traffic["check_steps"])):
        prog["losses"].append(float(trainer.train_step(batches[i])))
        if i == 0:
            prog["accum1"] = _host_copy(system.accumulators(trainer))
    prog["params"] = _host_copy(system.parameters(trainer))
    return {"system": system, "params0": params0, "batches": batches,
            "trainer": trainer, "prog": prog}


def reference(cell, st: Dict, device, mode: str = "exact") -> Dict:
    """The plain reference's check steps from the same parameters and rows
    (the rows as made: the reference works out the rest itself)."""
    base = ("fids", "vals", "mask", "labels")
    ref_batches = [_device_batch({k: st["batches"][i][k] for k in base},
                                 device)
                   for i in range(int(cell.traffic["check_steps"]))]
    ref = cell.module("reference", cell.config["name"])
    return ref.steps(st["params0"], ref_batches, cell.config, mode)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    """One run of a training cell."""
    import lightctr_tpu_torch.obs as obs

    cfg, traffic = cell.config, cell.traffic
    st = setup(cell, seed, device)
    system, trainer, batches = st["system"], st["trainer"], st["batches"]
    nxt = int(traffic["check_steps"])
    for _ in range(int(traffic["warmup_steps"])):
        trainer.train_step(batches[nxt])
        nxt += 1
    _sync(device)
    setup_s = time.time() - t_start

    win = timed_window(trainer, batches, nxt, seconds, device)
    nxt = win["next"]
    step_s = win["wall_s"] / win["steps"]
    e2e = {"examples_per_s": win["steps"] * traffic["batch"] / win["wall_s"],
           "step_ms_p95": p95(win["intervals_ms"]),
           "setup_s": setup_s}

    summary = None
    breakdown = None
    dev_info: Dict = {}
    if trace:
        first = nxt
        prev = obs.trace.set_rate(1.0)
        try:
            prof = devtrace.profile_steps(
                lambda j: trainer.train_step(batches[first + j]),
                int(traffic["profiled_warmup_steps"]),
                int(traffic["profiled_steps"]), device)
        finally:
            obs.trace.set_rate(prev)
        measured = range(first + int(traffic["profiled_warmup_steps"]),
                         first + int(traffic["profiled_warmup_steps"])
                         + int(traffic["profiled_steps"]))
        works = [system.work(cfg, batches[j]) for j in measured]
        work = {k: statistics.fmean(w[k] for w in works) for k in works[0]}
        summary = {
            "batch": int(traffic["batch"]),
            "window": {"steps": win["steps"], "wall_s": win["wall_s"],
                       "step_s": step_s, "host_s": win["host_s"],
                       "intervals_ms": win["intervals_ms"]},
            "profiled": prof, "work": work, "peaks": dict(roofline.PEAKS),
        }
        breakdown = {"device_ops": devtrace.top(prof["device"]),
                     "idle_gaps": devtrace.top(prof["gaps"])}
        dev_info = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}

    # the window's steps: a loss that is not finite is a failed step
    stacked = torch.stack([x.detach().float() for x in win["losses"]])
    failed = int((~torch.isfinite(stacked)).sum())
    attempted = win["steps"]
    cuda = device.type == "cuda"
    device_out = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                              if cuda else 0),
        **dev_info,
    }
    if cuda:
        device_out["power_limit"] = power_limit()

    # the program's state is freed before the reference runs
    del trainer, win, stacked
    st["trainer"] = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = check.readings(st["prog"], reference(cell, st, device),
                            st["params0"])
    return {"end_to_end": e2e, "summary": summary, "breakdown": breakdown,
            "device": device_out, "attempted": attempted, "failed": failed,
            "checks": check.judge(values, cell.limits)}
