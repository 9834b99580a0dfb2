"""The benchmark's one command: run a cell of ``BENCHMARK.json`` on the
card and print its result as one JSON line.

    python3 -m ctrbench.run --workload fm-criteo.b65536 --seed 7 \\
        --seconds 10 --trace 0

The harness is driven by data.  A cell names a configuration
(``configs/<config>.json``, its plain reference ``reference/<config>.py``,
the adapter that builds the system under test ``systems/<model>.py``) and
a traffic mix (``traffic/<mix>.json``, whose ``loop`` names the driver in
``loops/<loop>.py``); each per-layer metric is a reader of its own
(``metrics/<metric>.py``); each cell's limits for ``correct`` are
``limits/<workload>.json``.  Adding any of them is adding files.

The run fails, and prints no result, without a card (or with fewer cards
than the cell asks for), and when the process holds JAX or the JAX package
once the window has closed.  It holds itself to two fixed CPUs.  Build and kernel caches stay inside the
checkout (``lightctr_tpu_torch/build/`` for the port's kernels,
``.ctrbench_cache/`` for the toolchains' own).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
#: top-level modules the process may not hold: JAX and the JAX package
#: (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lightctr_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One ``workloads`` entry with everything it names, found by name
    under ``root`` (this package's folder, or a copy of it)."""

    def __init__(self, manifest: Dict, name: str, root: str = HERE):
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in the manifest")
        w = by_name[name]
        self.root, self.name = root, name
        self.chips = int(w["chips"])
        self.config = self._json("configs", w["config"])
        self.traffic = self._json("traffic", w["traffic"])
        self.limits = self._json("limits", name)
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    def _json(self, kind: str, name: str) -> Dict:
        with open(os.path.join(self.root, kind, f"{name}.json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        return load_module(os.path.join(self.root, kind, f"{name}.py"),
                           f"ctrbench_{kind}_{name.replace('-', '_')}")

    def metric_values(self, summary: Dict) -> Dict:
        """Each per-layer metric of the cell read from the traced run's
        summary by its own reader; a reader that finds nothing to read
        returns None and the metric is left out."""
        out = {}
        for m in self.per_layer:
            reader = self.module("metrics", m["name"])
            v = reader.read(summary)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out


def pin_cpus(n: int = 2) -> List[int]:
    """Hold every thread of this process, and those it starts later, to
    ``n`` fixed CPUs of those it may use (from the third on, where there
    are enough): one process with few threads, placed alike in every
    run."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) <= n:
        return allowed
    start = min(2, len(allowed) - n)
    cpus = allowed[start:start + n]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:
            pass
    return cpus


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> Dict:
    """The cell's run on ``device`` (a card; the CPU only for the tests'
    rehearsal): its result line, ``checks`` last."""
    loop = cell.module("loops", cell.traffic["loop"])
    res = loop.run(cell, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start)
    metrics = ({m["name"]: {"value": float(res["end_to_end"][m["name"]]),
                            "unit": m["unit"]}
                for m in cell.end_to_end}
               if not trace else cell.metric_values(res["summary"]))
    checks = res["checks"]
    out = {"correct": bool(res["failed"] == 0
                           and all(c["ok"] for c in checks.values())),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": res["device"]}
    if trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    t_start = time.time() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the toolchains' caches at fixed paths inside the checkout
    cache = os.path.join(CHECKOUT, ".ctrbench_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = Cell(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"ctrbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this process sees {seen}", file=sys.stderr)
        return 2
    torch.set_num_threads(len(pin_cpus()))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), t_start)
    held = forbidden_modules()
    if held:
        print(f"ctrbench: the process holds {held} after the window",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
