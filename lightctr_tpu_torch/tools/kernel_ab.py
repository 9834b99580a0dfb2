"""A/B of two checkouts' touched-row kernels on one card: merge_apply in
both modes, merge_rows and quantize_pack_ef_update, at ``chip_smoke.py``'s
shapes, each warm and cold: ``ms`` is chip_smoke's ``graph_ms`` (a CUDA
graph of back-to-back calls, which find their working set in the 50 MB
L2 where it fits), ``cold_ms`` its ``cold_ms`` (each call after a read
that empties the L2).

Each root named on the command line is a checkout of the repo (the tree
under test, or a parent unpacked with ``git archive``).  For each, in the
order given, a fresh process imports that checkout's ``chip_smoke.py`` and
``sparse_kernels``, builds the four kernels from its ``csrc/`` and times
them on inputs made from chip_smoke's seeds, so both roots see the same
data; the timing functions are this checkout's, so both roots are timed
alike:

  ``apply``       merge_apply's apply mode on one train batch's uids
                  (S = 159,744) into 2^20-row tables, d 1 and 32;
  ``merge_mode``  merge_apply's merge mode on the dp path's gathered rows
                  (M = 159,744, zero padding), d 32 and 1;
  ``merge_rows``  merge_rows on the same rows, d 32 and 1;
  ``ef_update``   quantize_pack_ef_update, one dp rank's uids (S = 79,872),
                  8 bits normal, range 1.0, d 1 and 32.

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
import importlib.util, json, sys
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
names = ("dedup_ids", "merge_apply", "merge_rows", "quantize_pack_ef_update")
with ThreadPoolExecutor(len(names)) as ex:
    list(ex.map(lambda n: sk.compile_source(sk.KERNELS[n].source), names))
gen = torch.Generator(device="cuda").manual_seed(5)
out = {"root": root, "apply": {}, "merge_mode": {}, "merge_rows": {},
       "ef_update": {}}

def timed(fn, nbytes):
    return {"ms": timer.graph_ms(torch, fn),
            "cold_ms": timer.cold_ms(torch, fn),
            "bound_ms": timer.bound_ms(nbytes)}

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

uids_l, _, count_l = per_rank[0]
k, real_l = uids_l.numel(), int(count_l)
table_q = qz.build_table(-1.0, 1.0, bits=8, mode="normal", device="cuda")
mask = (~((uids_l == 0) & (torch.arange(k, device="cuda") > 0))) \
    .to(torch.float32)
for d in (1, cs.DIM):
    shape = (cs.VOCAB,) if d == 1 else (cs.VOCAB, d)
    mask_d = mask if d == 1 else mask.reshape(-1, 1)
    residual = torch.zeros(shape, device="cuda")
    g = torch.randn((k,) + shape[1:], generator=gen, device="cuda") * mask_d
    out["ef_update"][d] = timed(
        lambda: sk.quantize_pack_ef_update(table_q, g, uids_l, residual,
                                           mask_d),
        k * d * 4 + real_l * d * 4 + k * 8 + k * d * 5 + real_l * d * 4)
    del residual, g
out["nvidia_smi"] = timer.nvidia_smi()
print(json.dumps(out), flush=True)
"""

KERNELS = ("apply", "merge_mode", "merge_rows", "ef_update")


def run_root(root: str) -> dict:
    """Time ``root``'s kernels in a process of its own."""
    return ab_roots.run_root("kernel_ab", _CHILD, root, TIMER)


def summarize(recs: list) -> dict:
    """One root's medians of ``ms`` and ``cold_ms``, by kernel and width."""
    return {kern: {d: {t: statistics.median(r[kern][d][t] for r in recs)
                       for t in ("ms", "cold_ms")}
                   for d in recs[0][kern]}
            for kern in KERNELS}


def main(argv=None) -> int:
    return ab_roots.main(__doc__, run_root, summarize, argv)


if __name__ == "__main__":
    sys.exit(main())
