"""Timing for the port's benches: CUDA events on the card (around a CUDA
graph of back-to-back calls where the function can be captured), the
host clock on the CPU."""

from __future__ import annotations

import os
import statistics
import time
from typing import Callable

import torch

from lightctr_tpu_torch.ops import sparse_kernels as sk

#: the JAX package's bench artifacts, which the port's benches never write
JAX_ARTIFACTS = ("SPARSE_KERNEL_BENCH.json", "PALLAS_BENCH.json")


def time_ms(fn: Callable, steps: int, device: torch.device,
            graph: bool = False, repeats: int = 3) -> float:
    """Milliseconds per call of ``fn()`` after one warm-up call: on the
    card, ``steps`` calls between two CUDA events (captured in one CUDA
    graph when ``graph``, so the host's launch time does not hide the
    device time; a function that syncs cannot be captured), the median of
    ``repeats``; on the CPU, the host clock over ``steps`` calls."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / steps
    torch.cuda.synchronize(device)
    if graph:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(steps):
                fn()
        run = g.replay
        run()
    else:
        def run():
            for _ in range(steps):
                fn()
    torch.cuda.synchronize(device)
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / steps)
    return statistics.median(per)


def which_ran(name: str, fn: Callable) -> str:
    """Call ``fn()`` once and say from kernel ``name``'s launch count what
    ran: ``"cuda"`` if it launched, else ``"plain"``."""
    before = sk.launches(name)
    fn()
    return "cuda" if sk.launches(name) > before else "plain"


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"device": str(device),
                "device_name": torch.cuda.get_device_name(device)}
    return {"device": "cpu", "device_name": "cpu"}


def check_out(out: str) -> None:
    """Refuse to overwrite one of the JAX package's artifacts."""
    if os.path.basename(out) in JAX_ARTIFACTS:
        raise ValueError(f"{out}: that name is the JAX package's artifact; "
                         "pick another")
