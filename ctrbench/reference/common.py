"""Pieces the plain references share: the logistic loss, Adagrad with its
epsilon inside the square root, the steps the check compares, and the
lower precisions the control computes in.

Plain PyTorch only: nothing here imports the program under test.  Every
table is an autograd leaf whole (its gradient dense, zero on the rows a
batch does not touch); the update is applied to the touched rows only, as
LightCTR's parameter server applies a push (``paramserver.h:287-295``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

#: the modes the reference runs in: the reference itself, the control (the
#: configuration's lower precision), and the planted faults of a step
MODES = ("exact", "control", "half", "frozen")


def logistic_loss(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed binary cross-entropy on logits, ``softplus(z) - y z``."""
    return (torch.nn.functional.softplus(z) - labels * z).sum()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even),
    as the tensor cores round a float32 product's inputs."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with its inputs rounded to TF32, forward and backward,
    summed in float32: what cuBLAS does with TF32 allowed, on any device."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """A float32 matrix product in ``precision`` ("float32" or "tf32"): on
    a card TF32 is cuBLAS's own, switched by :func:`matmul_precision`; on
    the CPU the inputs are rounded as the tensor cores round them."""
    if precision == "tf32" and not a.is_cuda:
        return _TF32MatMul.apply(a, b)
    return a @ b


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """cuBLAS's TF32 switch for the reference's products (off but for the
    control), put back as the caller had it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def run_steps(params0: Dict[str, torch.Tensor], batches: List[Dict],
              loss_fn: Callable, tables: Dict[str, List[str]],
              lr: float, eps: float, mode: str = "exact",
              tf32: bool = False) -> Dict:
    """``len(batches)`` Adagrad steps from ``params0`` (flat leaf names).

    ``loss_fn(params, batch, mode)`` gives the step's mean loss.  Returns
    the losses, the accumulators after the first step (each the first
    gradient squared) and the parameters after the last step.  ``mode``
    "half" steps on the first half of each batch, "frozen" returns the
    state unchanged; "control" is the loss function's to honour, with
    cuBLAS's TF32 switched on where ``tf32`` says so."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    params = {k: v.detach().clone() for k, v in params0.items()}
    accum = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "accum1": None, "params": None}
    for i, batch in enumerate(batches):
        if mode == "half":
            n = len(batch["labels"]) // 2
            batch = {k: v[:n] for k, v in batch.items()}
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        with matmul_precision(tf32 and mode == "control"):
            loss = loss_fn(leaves, batch, mode)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                p.requires_grad_(False)
                if mode == "frozen":
                    continue
                if k in tables:
                    # the rows this batch touched, as the PS applies a push
                    ids = torch.cat([batch[f].reshape(-1) for f in tables[k]])
                    rows = torch.unique(ids.to(torch.int64))
                    a = accum[k].index_select(0, rows) + g.index_select(
                        0, rows) ** 2
                    accum[k].index_copy_(0, rows, a)
                    p.index_copy_(0, rows, p.index_select(0, rows)
                                  - lr * g.index_select(0, rows)
                                  * torch.rsqrt(a + eps))
                else:
                    accum[k] += g * g
                    p -= lr * g * torch.rsqrt(accum[k] + eps)
        if i == 0:
            out["accum1"] = {k: v.clone() for k, v in accum.items()}
        del grads, loss
    out["params"] = params
    return out
