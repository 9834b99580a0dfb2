"""A ``torch.profiler`` session over a few steps, reduced to what the
per-layer metrics read: device busy time, device time by kernel name, the
program's spans (its ``record_function`` annotations) and the device's
idle gaps by what the host was doing.

The session records the host and the card.  Its first steps are a warm-up
(the profiler loses the first device records of a session); the measured
steps run inside the benchmark's own annotation ``WINDOW``, which ends in
a ``synchronize()``, and only events inside it count.  The Chrome trace
goes to a temporary file under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List

import torch

WINDOW = "ctrbench/profiled"
STEP = "ctrbench/train_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def profile_steps(step: Callable[[int], None], warmup: int, steps: int,
                  device: torch.device) -> Dict:
    """Run ``step(j)`` for ``warmup`` then ``steps`` steps under the
    profiler; returns the reduced trace and the host clock around each
    measured call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    host: List[float] = []
    with profile(activities=acts) as prof:
        for j in range(warmup):
            step(j)
        if cuda:
            torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for j in range(warmup, warmup + steps):
                th = time.perf_counter()
                with record_function(STEP):
                    step(j)
                host.append(time.perf_counter() - th)
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="ctrbench_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = reduce_events(events)
    out.update(steps=steps, host_s=host, wall_s=window_s)
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events: List[Dict]) -> Dict:
    """The trace inside the ``WINDOW`` annotation: ``busy_s`` (the union
    of the device's operations), ``window_s`` (the annotation's length),
    ``device`` ({name: [seconds, count]}), ``spans`` ({annotation:
    [seconds, count]}) and ``gaps`` ({what the host was doing: idle
    seconds})."""
    win = [e for e in events
           if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    tid = win[0].get("tid")
    device: Dict[str, List] = {}
    spans: Dict[str, List] = {}
    busy = []
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        cat = e.get("cat")
        name = e.get("name", "")
        if cat in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            busy.append((a, b))
            d = device.setdefault(name, [0.0, 0])
            d[0] += (b - a) * 1e-6
            d[1] += 1
        elif cat in HOST_CATS and e.get("tid") == tid and name != WINDOW:
            host.append((a, b, name))
            if cat == "user_annotation":
                s = spans.setdefault(name, [0.0, 0])
                s[0] += (b - a) * 1e-6
                s[1] += 1
    merged = _merge(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    return {"busy_s": busy_s, "window_s": (hi - lo) * 1e-6,
            "device": device, "spans": spans,
            "gaps": _gaps(merged, lo, hi, host)}


def _gaps(merged, lo, hi, host) -> Dict[str, float]:
    """Idle seconds of the device, summed by the innermost host event
    under each gap's middle (the host thread that ran the window)."""
    host.sort()
    starts = [h[0] for h in host]
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    out: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "host: no recorded operation"
        i = bisect.bisect_right(starts, mid) - 1
        # events nest: the latest-starting one that still covers the middle
        # is the innermost
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def top(d: Dict, n: int = 10) -> List:
    """The ``n`` largest entries of ``{name: seconds}`` (or ``{name:
    [seconds, count]}``) as ``[[name, seconds], ...]``."""
    items = [(k, v[0] if isinstance(v, list) else v) for k, v in d.items()]
    items.sort(key=lambda kv: -kv[1])
    return [[k, s] for k, s in items[:n]]
