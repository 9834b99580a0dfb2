"""Fused Adagrad table update — the hand-written CUDA kernel and its plain
version.

The port's counterpart of ``lightctr_tpu/optim/fused_adagrad.py``.  The
dense Adagrad update reads (w, accum, grad) and writes (w', accum'); the
kernel (``csrc/fused_adagrad.cu``) does it in one pass, in place — the
counterpart of the reference's single AVX loop over the parameter arrays
(AdagradUpdater_Num, gradientUpdater.h:138-150).

Math (identical to ``optim.adagrad``): accum' = accum + g^2 ;
w' = w - lr * g / sqrt(accum' + eps).

Dispatch follows the tensor's device (``ops.sparse_kernels``, phase
``adagrad``): the plain version on a CPU tensor, the kernel on a CUDA
tensor.  Both update ``w`` and ``accum`` in place and return them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lightctr_tpu_torch.ops import sparse_kernels as sk


def fused_adagrad_plain(w: torch.Tensor, accum: torch.Tensor,
                        grad: torch.Tensor, lr: float, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the JAX package's XLA twin (``_adagrad_reference``),
    written back into ``w`` and ``accum``."""
    a_new = accum + grad * grad
    w_new = w - lr * grad * torch.rsqrt(a_new + eps)
    accum.copy_(a_new)
    w.copy_(w_new)
    return w, accum


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    sk.bind_entry(lib, "fused_adagrad_f32", [p, p, p, ll, f, f, p])


def _fused_adagrad_cuda(w: torch.Tensor, accum: torch.Tensor,
                        grad: torch.Tensor, lr: float, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream, in place; no
    synchronise."""
    if not (w.dtype == accum.dtype == grad.dtype == torch.float32):
        raise TypeError("fused_adagrad kernel takes float32 w, accum and "
                        f"grad, got {w.dtype}, {accum.dtype}, {grad.dtype}")
    if not (w.numel() == accum.numel() == grad.numel()):
        raise ValueError(f"fused_adagrad: sizes differ, w {w.numel()}, "
                         f"accum {accum.numel()}, grad {grad.numel()}")
    dev = sk.check_cuda_tensors("fused_adagrad", w=w, accum=accum, grad=grad)
    lib = sk.load("fused_adagrad")
    sk.run_kernel("fused_adagrad", dev, lib.fused_adagrad_f32, w.data_ptr(),
                  accum.data_ptr(), grad.data_ptr(), w.numel(), lr, eps)
    return w, accum


sk.register_kernel(
    "fused_adagrad", phase="adagrad", plain=fused_adagrad_plain,
    cuda=_fused_adagrad_cuda, source="fused_adagrad.cu", bind=_bind,
    replaces="lightctr_tpu/optim/fused_adagrad.py:55",
)


def fused_adagrad_update(
    w: torch.Tensor,
    accum: torch.Tensor,
    grad: torch.Tensor,
    lr: float,
    eps: float = 1e-7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass Adagrad on a (flattenable) fp32 tensor, in place on ``w``
    and ``accum``; returns them."""
    if not (w.device == accum.device == grad.device):
        raise ValueError(f"fused_adagrad: w on {w.device}, accum on "
                         f"{accum.device}, grad on {grad.device}")
    return sk.dispatch("fused_adagrad", w.device)(w, accum, grad, lr, eps)
