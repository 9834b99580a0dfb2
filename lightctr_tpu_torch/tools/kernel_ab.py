"""A/B of two checkouts' row, touched-row and quantize kernels on one
card: gather_rows, merge_apply in both modes, merge_rows,
quantize_pack_ef_update, quantize_pack and quantize_pack_ef, at
``chip_smoke.py``'s shapes, each
warm and cold: ``ms`` is chip_smoke's ``graph_ms`` (a CUDA
graph of back-to-back calls, which find their working set in the 50 MB
L2 where it fits), ``cold_ms`` its ``cold_ms`` (each call after a read
that empties the L2).

Each root named on the command line is a checkout of the repo (the tree
under test, or a parent unpacked with ``git archive``).  For each, in the
order given, a fresh process imports that checkout's ``chip_smoke.py`` and
``sparse_kernels``, builds the seven kernels from its ``csrc/`` and
times them on inputs made from chip_smoke's seeds, so both roots see the
same data; the timing functions and the gather's shapes are this
checkout's, so both roots are timed alike:

  ``gather``      gather_rows at the serve shape (65,536 rows of 33, n =
                  the largest padded micro-batch, 8,192) and the hot-row
                  shape (2^20 rows of 32, n = 159,744 uniform ids), each
                  with ``library_ms`` / ``library_cold_ms`` (one
                  ``torch.index_select``); then warm only at d 1, 33, 128
                  x n 1, 1000, 8192, 16384, 159,744 out of 65,536 rows;
  ``apply``       merge_apply's apply mode on one train batch's uids
                  (S = 159,744) into 2^20-row tables, d 1 and 32;
  ``merge_mode``  merge_apply's merge mode on the dp path's gathered rows
                  (M = 159,744, zero padding), d 32 and 1;
  ``merge_rows``  merge_rows on the same rows, d 32 and 1;
  ``long_runs``   the long-run walk, warm only, with the root's
                  ``long_run_stats`` where it has them: the merge mode on
                  those rows with the coded padding (CODED_PAD, one run of
                  about half the rows), d 32; merge_rows at GBM's root
                  histogram (the zoo's shape) and as the lookup's backward
                  of a 65,536-row Criteo batch (13 numeric ids in every
                  row) into the 2^20-row table, d 1, 10 and 32; the merge
                  mode on that batch's dedup, d 32;
  ``ef_update``   quantize_pack_ef_update, one dp rank's uids (S = 79,872),
                  range 1.0, 8 bits normal and 16 bits uniform, d 1 and 32;
  ``pack``        quantize_pack on one dp rank's [79,872, 32] payload, a
                  measured range, 8 bits normal and 16 bits uniform (with
                  ``library_ms``: one ``torch.searchsorted``);
  ``pack_ef``     quantize_pack_ef on that payload with a carry and a
                  [P, 1] mask, 8 bits normal, range 1.0.

Compare roots only within one run, in an order such as parent, change,
change, parent.  One JSON line a root on stdout (each kernel's ``ms``,
``cold_ms`` and ``bound_ms`` by width), then a summary line with each
root's medians.

    python -m lightctr_tpu_torch.tools.kernel_ab ROOT [ROOT ...]
"""

from __future__ import annotations

import os
import statistics
import sys

from lightctr_tpu_torch.tools import ab_roots

#: the chip_smoke.py whose timing functions time every root
TIMER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chip_smoke.py")

#: what runs in each root's process (argv: root, TIMER), at chip_smoke's
#: seed 0
_CHILD = r"""
import importlib.util, json, statistics, sys
from concurrent.futures import ThreadPoolExecutor
root, seed = sys.argv[1], 0
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("ab_timer", sys.argv[2])
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
import numpy as np
import torch
import chip_smoke as cs
from lightctr_tpu_torch.ops import quantize as qz
from lightctr_tpu_torch.ops import sparse_kernels as sk
if not torch.cuda.is_available():
    sys.exit("kernel_ab: CUDA is not available")
names = ("gather_rows", "dedup_ids", "merge_apply", "merge_rows",
         "quantize_pack_ef_update", "quantize_pack", "quantize_pack_ef")
with ThreadPoolExecutor(len(names)) as ex:
    list(ex.map(lambda n: sk.compile_source(sk.KERNELS[n].source), names))
gen = torch.Generator(device="cuda").manual_seed(5)
out = {"root": root, "gather": {}, "apply": {}, "merge_mode": {},
       "merge_rows": {}, "long_runs": {}, "ef_update": {}, "pack": {},
       "pack_ef": {}}

def timed(fn, nbytes):
    return {"ms": timer.graph_ms(torch, fn),
            "cold_ms": timer.cold_ms(torch, fn),
            "bound_ms": timer.bound_ms(nbytes)}

n_serve = max(timer.serve_gather_ns(np, sk, timer.make_requests(np, seed)))
for what, rows, d, n, gseed in (
        ("serve", timer.CACHE_ROWS, timer.ROW_DIM, n_serve, 99),
        ("hot_row", timer.HOT_ROWS, timer.DIM, timer.HOT_N, 98)):
    block, idx, nbytes = timer.gather_shape(torch, rows, d, n, gseed)
    out["gather"][what] = timed(lambda: sk.gather_rows(block, idx), nbytes)
    out["gather"][what]["library_ms"] = timer.graph_ms(
        torch, lambda: block.index_select(0, idx))
    out["gather"][what]["library_cold_ms"] = timer.cold_ms(
        torch, lambda: block.index_select(0, idx))
for d in (1, 33, 128):
    for n in (1, 1000, 8192, 16384, timer.HOT_N):
        block, idx, _ = timer.gather_shape(torch, timer.CACHE_ROWS, d, n, 97)
        out["gather"][f"d{d}_n{n}"] = {
            "ms": timer.graph_ms(torch, lambda: sk.gather_rows(block, idx))}
del block, idx

rng = np.random.default_rng(seed + 5)
ids = torch.from_numpy(cs.criteo_fids(np, rng, cs.TRAIN_BATCH)
                       .reshape(-1)).cuda()
uids, _, count = sk.dedup_ids(ids)
k, real = uids.numel(), int(count)
for d in (1, cs.DIM):
    shape = (cs.VOCAB,) if d == 1 else (cs.VOCAB, d)
    table = torch.randn(shape, generator=gen, device="cuda")
    accum = torch.rand(shape, generator=gen, device="cuda")
    grads = torch.randn((k,) + shape[1:], generator=gen, device="cuda")
    out["apply"][d] = timed(
        lambda: sk.merge_apply(table, accum, uids, grads, lr=cs.LR,
                               eps=cs.EPS),
        real * d * 4 * 4 + real * d * 4 + k * 4)
    del table, accum, grads

rng = np.random.default_rng(seed + 6)
_, uniq, inv, real, pad, per_rank = cs.gathered_stream(np, torch, sk, rng)
m = inv.numel()
rows = torch.randn((m, cs.DIM), generator=gen, device="cuda") * 0.05 \
    * (1 - pad)
for d in (cs.DIM, 1):
    rows_d = rows if d == cs.DIM else rows[:, 0].contiguous()
    flat = rows_d.reshape(m, d)
    out["merge_rows"][d] = timed(lambda: sk.merge_rows(flat, inv, m),
                                 m * d * 4 + m * 4 + m * d * 4)
    shape = (cs.VOCAB, d) if d > 1 else (cs.VOCAB,)
    table = torch.randn(shape, generator=gen, device="cuda")
    accum = torch.rand(shape, generator=gen, device="cuda")
    out["merge_mode"][d] = timed(
        lambda: sk.merge_apply(table, accum, uniq, rows_d, inv, lr=cs.LR,
                               eps=cs.EPS, denom=float(cs.DP_WORLD)),
        m * d * 4 + m * 4 + m * 4 + real * d * 4 * 4)
    del table, accum

# the long-run walk, 10 calls a graph (a walk takes ms), with the counters
# where the root has them
watch = getattr(sk, "watch_long_runs", None)

def walked(fn, name):
    rec = {"ms": statistics.median(timer.graph_times(torch, fn, reps=10,
                                                     repeats=5))}
    if watch is not None:
        with watch():
            fn()
            rec["long_runs"] = sk.long_run_stats(name)
    return rec

table = torch.randn((cs.VOCAB, cs.DIM), generator=gen, device="cuda")
accum = torch.rand((cs.VOCAB, cs.DIM), generator=gen, device="cuda")
coded = rows + cs.CODED_PAD * pad
out["long_runs"]["coded_pad_merge_mode_d32"] = walked(
    lambda: sk.merge_apply(table, accum, uniq, coded, inv, lr=cs.LR,
                           eps=cs.EPS, denom=float(cs.DP_WORLD)),
    "merge_apply")
del coded
_, gbm_rows, gbm_seg, gbm_nseg = timer.zoo_merge_inputs(np, torch, seed)[0]
out["long_runs"]["gbm_root"] = walked(
    lambda: sk.merge_rows(gbm_rows, gbm_seg, gbm_nseg), "merge_rows")
del gbm_rows, gbm_seg
batch = torch.from_numpy(cs.criteo_fids(
    np, np.random.default_rng(seed + 7), 65536).reshape(-1)).cuda()
for d in (1, 10, cs.DIM):
    grad = torch.randn((batch.numel(), d), generator=gen, device="cuda")
    out["long_runs"][f"criteo_d{d}"] = walked(
        lambda: sk.merge_rows(grad, batch, cs.VOCAB), "merge_rows")
b_uids, b_inv, _ = sk.dedup_ids(batch)
out["long_runs"]["criteo_merge_mode_d32"] = walked(
    lambda: sk.merge_apply(table, accum, b_uids, grad, b_inv, lr=cs.LR,
                           eps=cs.EPS), "merge_apply")
del grad, table, accum

uids_l, _, count_l = per_rank[0]
k, real_l = uids_l.numel(), int(count_l)
mask = (~((uids_l == 0) & (torch.arange(k, device="cuda") > 0))) \
    .to(torch.float32)
for bits, mode in ((8, "normal"), (16, "uniform")):
    table_q = qz.build_table(-1.0, 1.0, bits=bits, mode=mode, device="cuda")
    for d in (1, cs.DIM):
        shape = (cs.VOCAB,) if d == 1 else (cs.VOCAB, d)
        mask_d = mask if d == 1 else mask.reshape(-1, 1)
        residual = torch.zeros(shape, device="cuda")
        g = torch.randn((k,) + shape[1:], generator=gen, device="cuda") \
            * mask_d
        out["ef_update"][f"{bits}b_d{d}"] = timed(
            lambda: sk.quantize_pack_ef_update(table_q, g, uids_l, residual,
                                               mask_d),
            k * d * 4 + real_l * d * 4 + k * 8 + k * d * (bits // 8 + 4)
            + real_l * d * 4)
        del residual, g

p = cs.DP_LOCAL_K
x = torch.randn((p, cs.DIM), generator=gen, device="cuda") * 0.05
lim = 1.05 * x.abs().max()
for bits, mode in ((8, "normal"), (16, "uniform")):
    table = qz.build_table(-lim, lim, bits=bits, mode=mode)
    out["pack"][bits] = timed(lambda: sk.quantize_pack(table, x),
                              x.numel() * (4 + (1 if bits <= 8 else 2)))
    out["pack"][bits]["library_ms"] = timer.graph_ms(
        torch, lambda: torch.searchsorted(table.boundaries, x))
car = torch.randn((p, cs.DIM), generator=gen, device="cuda") * 0.01
mask = torch.ones((p, 1), device="cuda")
table = qz.build_table(-1.0, 1.0, bits=8, mode="normal", device="cuda")
out["pack_ef"][8] = timed(lambda: sk.quantize_pack_ef(table, x, car, mask),
                          x.numel() * 13 + p * 4)
out["nvidia_smi"] = timer.nvidia_smi()
print(json.dumps(out), flush=True)
"""

KERNELS = ("gather", "apply", "merge_mode", "merge_rows", "long_runs",
           "ef_update", "pack", "pack_ef")


def run_root(root: str) -> dict:
    """Time ``root``'s kernels in a process of its own."""
    return ab_roots.run_root("kernel_ab", _CHILD, root, TIMER)


def summarize(recs: list) -> dict:
    """One root's medians of ``ms``, ``cold_ms`` and the library's times
    where a cell has them, by kernel and cell (width; bits for ``pack``
    and ``pack_ef``; shape for ``gather``)."""
    return {kern: {d: {t: statistics.median(r[kern][d][t] for r in recs)
                       for t in ("ms", "cold_ms", "library_ms",
                                 "library_cold_ms")
                       if t in recs[0][kern][d]}
                   for d in recs[0][kern]}
            for kern in KERNELS}


def main(argv=None) -> int:
    return ab_roots.main(__doc__, run_root, summarize, argv)


if __name__ == "__main__":
    sys.exit(main())
