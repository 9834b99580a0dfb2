"""Per-phase bench of the sparse hot path's kernels: plain version against
the hand-written CUDA kernel.

The port's counterpart of ``tools/sparse_kernel_bench.py``, at its cells
and shapes: id dedup (K 16,384 ids of a 2^20 vocabulary), the row gather
(8,192 rows of a [65,536, 16] block), the segment merge alone (M 32,768
gradient rows onto S 8,192 segments, as the collectives' sparse
all-reduce merges) and fused into the Adagrad apply (onto S 8,192
touched rows of a [2^18, 16] table, denom 8),
and the quantize pack, plain and EF-folded ([16,384, 16] payload, the
8-bit uniform table over +-1, a [P, 1] mask).

Each cell times the plain version against the dispatched kernel after a
warm-up: CUDA events around a CUDA graph of back-to-back calls, or around
eager calls for a plain version that syncs (``torch.unique``, the
merge's rounds).  Which version ran is measured, not assumed: a cell's
``impl_kernel`` comes from the kernel's launch count over one call, and
``kernel_launches`` counts every launch the cell made.

The segment merge alone is the port's own cell: the JAX tool times the
merge only inside the apply.  It is here because the data-parallel path
no longer launches ``merge_rows`` (the merge mode fuses it into the
apply), and the collectives' sparse all-reduce is its other caller.

The JAX tool's "apply row-blocking A/B" cell has no counterpart: it times
one Pallas grid knob (rows per grid step, set through an environment
variable) that exists only on the TPU's sequential grid; the CUDA apply
has no such knob.

``--device cuda`` (the default) runs the kernels at the shapes above and
raises without CUDA; ``--device cpu`` runs the plain versions at small
shapes (the tests).  The report goes to stdout, and to a file only with
``--out`` (``TORCH_SPARSE_KERNEL_BENCH.json`` by convention; never the
JAX package's ``SPARSE_KERNEL_BENCH.json``).

    python -m lightctr_tpu_torch.tools.sparse_kernel_bench [--device cuda]
        [--steps 20] [--out TORCH_SPARSE_KERNEL_BENCH.json]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.ops import quantize
from lightctr_tpu_torch.ops import sparse_kernels as sk
from lightctr_tpu_torch.tools import timing

#: device type -> shapes: the JAX tool's on the card, small on the CPU
SHAPES = {
    "cuda": {"k": 16384, "gather_rows": 1 << 16, "gather_n": 8192,
             "s": 8192, "table_rows": 1 << 18, "payload": 16384},
    "cpu": {"k": 1024, "gather_rows": 1 << 12, "gather_n": 512,
            "s": 256, "table_rows": 1 << 12, "payload": 512},
}
DIM = 16
VOCAB = 1 << 20


def _cell(phase, kernel, shape, plain, fused, steps, dev,
          plain_graph) -> dict:
    before = sk.launches(kernel)
    impl = timing.which_ran(kernel, fused)
    on_card = dev.type == "cuda"
    t_plain = timing.time_ms(plain, steps, dev, graph=on_card and plain_graph)
    t_kernel = timing.time_ms(fused, steps, dev, graph=on_card)
    return {
        "phase": phase, "kernel": kernel, "shape": shape,
        "impl_plain": "plain", "impl_kernel": impl,
        "kernel_is_plain": impl == "plain",
        "kernel_launches": sk.launches(kernel) - before,
        "t_plain_ms": t_plain, "t_kernel_ms": t_kernel,
        "speedup_x": t_plain / max(t_kernel, 1e-12),
        "timing": ("host clock" if not on_card else
                   "cuda events, graph" if plain_graph else
                   "cuda events; plain eager (it syncs), kernel graph"),
    }


def run(device="cuda", steps: int = 20, out: Optional[str] = None,
        seed: int = 0) -> dict:
    """Run every cell on ``device``; returns the report (written to
    ``out`` only when it is given)."""
    if out:
        timing.check_out(out)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sh = SHAPES[dev.type]
    r = np.random.default_rng(seed)
    cells = []

    # dedup: one batch's id stream
    k = sh["k"]
    ids = torch.from_numpy(r.integers(1, VOCAB, size=k).astype(np.int32)) \
        .to(dev)
    cells.append(_cell("dedup", "dedup_ids", f"K={k} ids, vocab=2^20",
                       lambda: sk.dedup_ids_plain(ids, k),
                       lambda: sk.dedup_ids(ids), steps, dev, False))

    # gather: the device-resident row path's read half
    gb, gn = sh["gather_rows"], sh["gather_n"]
    block = torch.from_numpy(r.normal(size=(gb, DIM)).astype(np.float32)) \
        .to(dev)
    gidx = torch.from_numpy(r.integers(0, gb, size=gn).astype(np.int32)) \
        .to(dev)
    cells.append(_cell("gather", "gather_rows",
                       f"{gn} rows of [{gb}, {DIM}] block",
                       lambda: sk.gather_rows_plain(block, gidx),
                       lambda: sk.gather_rows(block, gidx), steps, dev,
                       True))

    # merge + apply: touched-row Adagrad over a big table (merge mode)
    s, tv = sh["s"], sh["table_rows"]
    m = 4 * s
    u = np.unique(r.integers(1, tv, size=s))
    uids_np = np.zeros(s, np.int32)
    uids_np[:u.size] = u
    uids = torch.from_numpy(uids_np).to(dev)
    inv = torch.from_numpy(r.integers(0, u.size, size=m).astype(np.int32)) \
        .to(dev)
    rows = torch.from_numpy(r.normal(size=(m, DIM)).astype(np.float32)) \
        .to(dev)
    table = torch.from_numpy(r.normal(size=(tv, DIM)).astype(np.float32)) \
        .to(dev)
    accum = torch.from_numpy(
        np.abs(r.normal(size=(tv, DIM))).astype(np.float32)).to(dev)
    tp, ap = table.clone(), accum.clone()
    cells.append(_cell("merge", "merge_rows",
                       f"M={m} grad rows -> S={s} segments",
                       lambda: sk.merge_rows_plain(rows, inv, s),
                       lambda: sk.merge_rows(rows, inv, s), steps, dev,
                       False))
    cells.append(_cell(
        "merge_apply", "merge_apply",
        f"M={m} grad rows -> S={s} touched of [{tv}, {DIM}] table",
        lambda: sk.merge_apply_plain(tp, ap, uids, rows, inv, 0.05, 1e-7,
                                     8.0),
        lambda: sk.merge_apply(table, accum, uids, rows, inv, lr=0.05,
                               eps=1e-7, denom=8.0), steps, dev, False))

    # quantize pack, plain and EF-folded: the coded payload's encode
    p = sh["payload"]
    payload = torch.from_numpy(
        (0.1 * r.normal(size=(p, DIM))).astype(np.float32)).to(dev)
    qt = quantize.build_table(-1.0, 1.0, bits=8, device=dev)
    cells.append(_cell("pack", "quantize_pack",
                       f"{p}x{DIM} fp32 -> uint8 codes",
                       lambda: sk.quantize_pack_plain(qt, payload),
                       lambda: sk.quantize_pack(qt, payload), steps, dev,
                       True))
    carried = torch.from_numpy(
        (0.01 * r.normal(size=(p, DIM))).astype(np.float32)).to(dev)
    mask = torch.ones((p, 1), dtype=torch.float32, device=dev)
    cells.append(_cell("pack", "quantize_pack_ef",
                       f"{p}x{DIM} EF-folded encode, [P, 1] mask",
                       lambda: sk.quantize_pack_ef_plain(qt, payload,
                                                         carried, mask),
                       lambda: sk.quantize_pack_ef(qt, payload, carried,
                                                   mask), steps, dev, True))

    report = {
        "metric": "sparse_hot_path_kernel_phase_times",
        **timing.device_info(dev),
        "steps": steps,
        "note": ("plain version vs the dispatched kernel, per phase; "
                 "impl_kernel is read from the kernel's launch count "
                 "(cuda on a CUDA device, plain on the CPU)"),
        "cells": cells,
    }
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also write the report here "
                         "(e.g. TORCH_SPARSE_KERNEL_BENCH.json)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.steps, args.out), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
