"""The yardstick's peaks and the work a training step needs, counted from
shapes: the arithmetic the per-layer rooflines and ``mfu`` divide by.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at the full
700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the
tensor cores (the configurations' precision, TF32 off), 989 TFLOP/s in
bfloat16.  A share is taken against the published peak, and the card's
power limit is reported beside it.

Every count is a lower bound of what the step must do, so no share can
pass 100 %: each input byte is read once and each output byte written
once, intermediates that a fused program would keep on chip are not
counted, and where the work depends on the data (how many distinct rows a
batch touches) the count is of these inputs.  The sparse path's bytes are
``PERF.md`` §6's kernel-table arithmetic: each id stream's ids read once,
each table's gradient rows read once, its touched rows and their Adagrad
accumulators read and written once.
"""

from __future__ import annotations

from typing import Dict, Iterable

F32 = 4
INT32 = 4

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "bf16_flops_per_s": 989e12,
}

#: Adagrad's operations an updated element: g*g, +, +eps, rsqrt, lr*g*r, -
ADAGRAD_OPS = 6


def least_time(flops: float, nbytes: float,
               flops_per_s: float = PEAKS["fp32_flops_per_s"]) -> Dict:
    """The least time of ``flops`` operations and ``nbytes`` bytes on the
    peaks, and which of the two binds."""
    t_ops = flops / flops_per_s
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return {"seconds": max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes",
            "ops_s": t_ops, "bytes_s": t_bytes}


def gemm_flops(m: int, k: int, n: int) -> int:
    """One [m, k] @ [k, n] product."""
    return 2 * m * k * n


def dense_layer_flops(rows: int, n_in: int, n_out: int,
                      input_grad: bool) -> int:
    """A dense layer's forward and backward: y = x W^T + b, then the
    weight's and the bias's gradients and, where its input trains, the
    input's."""
    fwd = gemm_flops(rows, n_in, n_out) + rows * n_out
    bwd = gemm_flops(n_in, rows, n_out) + rows * n_out
    if input_grad:
        bwd += gemm_flops(rows, n_out, n_in)
    return fwd + bwd


def adagrad_flops(elements: int) -> int:
    return ADAGRAD_OPS * elements


def adagrad_bytes(elements: int) -> int:
    """The parameter and its accumulator, each read and written once."""
    return 4 * F32 * elements


def batch_bytes(shapes: Iterable) -> int:
    """The batch's arrays on the device, each read once: ``(numel,
    itemsize)`` pairs."""
    return sum(int(n) * int(size) for n, size in shapes)


def sparse_path_bytes(streams: Dict[str, Dict]) -> int:
    """The bytes the sparse path (dedup, the lookups' backward, the
    touched-row apply) must move a step.  ``streams`` maps an id stream to
    ``{"ids": K, "unique": U, "dims": [d of each table it keys]}``."""
    total = 0
    for s in streams.values():
        total += INT32 * s["ids"]
        for d in s["dims"]:
            total += F32 * s["ids"] * d + adagrad_bytes(s["unique"] * d)
    return total


def sparse_path_flops(streams: Dict[str, Dict]) -> int:
    """The gradient rows summed into their touched rows, then Adagrad on
    those rows."""
    total = 0
    for s in streams.values():
        for d in s["dims"]:
            total += s["ids"] * d + adagrad_flops(s["unique"] * d)
    return total


def fm_flops(rows: int, slots: int, k: int) -> int:
    """FM's forward and backward a step, counted as the batched sumVX form
    needs them (``train_fm_algo.cpp:63-88``): a slot's value times its
    mask, ``w x`` and its sum, ``v x``, its sum over slots and its square,
    the squares' sum; the L2 terms; the backward twice the forward."""
    per_row = (slots * 3                 # x = vals * mask, w x, its sum
               + slots * k * 4           # v x, sum over slots, (v x)^2, sum
               + k * 2                   # |sum v x|^2
               + slots * (k + 1) * 3)    # the L2 terms: squares, mask, sum
    return 3 * rows * per_row


def widedeep_flops(rows: int, slots: int, fields: int, k: int,
                   dense_layers) -> int:
    """Wide&Deep's forward and backward a step: the wide sum, the
    embeddings masked, each dense layer (the first one's input trains:
    the embeddings), tanh and the sigmoid head."""
    wide = 3 * rows * slots * 3
    embed = 3 * rows * fields * k
    dense = sum(dense_layer_flops(rows, n_in, n_out, input_grad=True)
                for n_in, n_out in dense_layers)
    acts = 3 * rows * sum(n_out for _, n_out in dense_layers)
    return wide + embed + dense + acts
