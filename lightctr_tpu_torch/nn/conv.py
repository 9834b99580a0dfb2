"""2-D convolution layer on tensors.

The port's counterpart of ``lightctr_tpu/nn/conv.py`` (a redesign of
``train/layer/convLayer.h`` + ``Matrix::convolution``, matrix.h:290-319).
The params keep the JAX package's layout — filters ``w`` [kh, kw, in,
out] (HWIO), bias [out] — and activations are [N, H, W, C], so weights
carry across as a plain copy; :func:`apply` permutes to cuDNN's OIHW /
NCHW inside.

The LeNet sparse input->output map (``bConnect``, convLayer.h:18-25)
multiplies ``w``, so masked links get zero weight and zero gradient.

Precision and order: a fresh process lets cuDNN run convolutions in TF32
(``torch.backends.cudnn.allow_tf32`` is True by default) and pick
nondeterministic backward algorithms.  The convolution here runs forward
and backward under ``cudnn.flags(allow_tf32=False, deterministic=True,
benchmark=False)`` whatever the global settings, so a CNN trained on the
card computes in float32 and repeats bit for bit.

Init: filters ~ U(-0.5, 0.5)/sqrt(fan_in), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# 6 x 16 LeNet sparse link matrix (convLayer.h:18-25)
LENET_CONNECTION_6x16 = np.asarray(
    [
        [1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1],
        [1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1],
        [1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1, 1],
        [0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 1, 1],
        [0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
        [0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 1],
    ],
    dtype=np.float32,
)


def _exact_cudnn():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW / OIHW, no bias) whose forward and backward both
    run under :func:`_exact_cudnn` (autograd runs a backward after the
    forward's context has closed, so the flags are set again there)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _exact_cudnn():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        with _exact_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad.contiguous(), x, w, None, [ctx.stride] * 2,
                [ctx.padding] * 2, [1, 1], False, [0, 0], 1,
                [need_x, need_w, False])
        return gx, gw, None, None


def init(generator: torch.Generator, filter_size: int, in_ch: int,
         out_ch: int, device="cpu") -> Dict[str, torch.Tensor]:
    """HWIO filters ~ U(-0.5, 0.5)/sqrt(fan_in), zero bias, drawn from
    ``generator`` on its device and moved to ``device``."""
    fan_in = filter_size * filter_size * in_ch
    w = (torch.rand((filter_size, filter_size, in_ch, out_ch),
                    generator=generator, dtype=torch.float32,
                    device=generator.device) - 0.5) / math.sqrt(float(fan_in))
    return {"w": w.to(device),
            "b": torch.zeros((out_ch,), dtype=torch.float32, device=device)}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
          padding: int = 0, connection_mask: Optional[torch.Tensor] = None,
          activation: Optional[Callable] = None) -> torch.Tensor:
    """[N, H, W, C_in] -> [N, H', W', C_out] (``lax.conv_general_dilated``
    with NHWC/HWIO), optionally masked per (in, out) link and activated."""
    w = params["w"]
    if connection_mask is not None:
        w = w * connection_mask[None, None, :, :]
    y = _Conv2d.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                      stride, padding)
    y = y.permute(0, 2, 3, 1) + params["b"]
    if activation is not None:
        y = activation(y)
    return y
