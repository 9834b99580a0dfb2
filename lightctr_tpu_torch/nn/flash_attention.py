"""Flash attention — the hand-written CUDA kernel and its plain version.

The port's counterpart of ``lightctr_tpu/nn/flash_attention.py``: exact
attention over [B, T, H, D] computed tile by tile with an online softmax,
never holding the [T, T] score matrix; optionally causal, skipping the key
tiles above the diagonal.  ``csrc/flash_attention.cu`` holds three kernels
that together take float32, bfloat16 and float16 at any D and any B*H; its
design note says how each differs from the TPU's grid, and
:func:`flash_route` is the one rule that picks among them.  Forward only,
as in the JAX package, where only the ``xla`` route is differentiable: the
plain version (a CPU tensor) is differentiable, and the CUDA route refuses
inputs that require grad rather than hand autograd a constant.

Dispatch follows the tensor's device (``ops.sparse_kernels``, phase
``attention``): the plain version on a CPU tensor, the kernel on a CUDA
tensor.  ``block_q``/``block_k`` are the JAX function's tuning caps: they
go through :func:`validate_blocks`, so a caller's error surfaces as it
does there, and the CUDA kernel then uses its own tiles.
"""

from __future__ import annotations

import ctypes

import torch

from lightctr_tpu_torch.nn.ring_attention import full_attention
from lightctr_tpu_torch.ops import sparse_kernels as sk

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernel's designs, by the code its C entry takes
ROUTES = {"fma": 0, "mma_sync": 1, "wgmma": 2}
#: the widest head the wgmma kernel and the mma.sync kernel take
WGMMA_MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 128


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which of the kernel's three designs a call takes: the one shape and
    dtype rule, decided before the launch (never by a failed one).

    - ``"wgmma"``: bfloat16 or float16 whose TMA tensor maps the card
      accepts — D % 8 == 0 (so every row stride, D*2 and H*D*2 bytes, is a
      multiple of 16) and q, k and v start 16-byte aligned — at D <= 256;
    - ``"mma_sync"``: other bfloat16/float16 at D <= 128;
    - ``"fma"``: float32 at any D (no TF32: the JAX reference is full
      float32), and the 16-bit shapes the other two cannot take (wider
      heads in 128-column output slices).
    """
    if q.dtype == torch.float32:
        return "fma"
    d = q.shape[-1]
    tma_ok = d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if tma_ok and d <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    if d <= MMA_MAX_HEAD_DIM:
        return "mma_sync"
    return "fma"


def validate_blocks(t: int, block_q: int, block_k: int):
    """Shrink requested blocks to divisors of T (callers pick tuning caps);
    raise when none fits.  A copy of the JAX package's check."""
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    while block_q > 8 and t % block_q:
        block_q //= 2
    while block_k > 8 and t % block_k:
        block_k //= 2
    if t % block_q or t % block_k:
        raise ValueError(
            f"block sizes ({block_q}, {block_k}) must divide T={t}"
        )
    return block_q, block_k


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = False
                          ) -> torch.Tensor:
    """Plain version: :func:`full_attention` on float32 copies of ``q``,
    ``k``, ``v``, cast to ``q``'s dtype (the JAX twin ``_flash_reference``,
    upcast so that on the card a comparison measures the kernel, not
    16-bit scores).  On the card it runs in full float32 only with TF32
    off (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    return full_attention(q.float(), k.float(), v.float(),
                          causal=causal).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sk.bind_entry(lib, "flash_attention_fwd",
                  [p, p, p, p, i, ll, ll, ll, ll, i, i, p])


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel of :func:`flash_route`'s design on the
    current stream; no synchronise.  Counts the launch under the kernel
    and under its design (``sk.variant_launches("flash_attention")``).
    The kernel is forward only, as the TPU kernel is: with grad mode on it
    refuses q, k or v that require grad (its output would be a constant
    to autograd), before any other check."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention's CUDA kernel has no backward (nor has the "
            "JAX package's Pallas kernel): for gradients call "
            "nn.ring_attention.full_attention, which autograd "
            "differentiates, or run the kernel under torch.no_grad() on "
            "inputs that need none")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention kernel takes q, k, v of one dtype "
                        "among float32, bfloat16, float16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError("flash_attention kernel takes q, k, v of one "
                         f"[B, T, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    dev = sk.check_cuda_tensors("flash_attention", q=q, k=k, v=v)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    route = flash_route(q, k, v)
    lib = sk.load("flash_attention")
    sk.run_kernel("flash_attention", dev, lib.flash_attention_fwd,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  _DTYPE_CODES[q.dtype], b, t, h, d, int(bool(causal)),
                  ROUTES[route], variant=route)
    return o


def _cost(q, k, v, causal):
    """q, k and v read and the output written; the two products' 4·T²·D
    operations a (batch, head), half of them under the causal mask."""
    b, t, h, d = q.shape
    flops = 4.0 * b * h * t * t * d / (2 if causal else 1)
    return 4 * q.numel() * q.element_size(), flops


sk.register_kernel(
    "flash_attention", phase="attention", plain=flash_attention_plain,
    cuda=_flash_attention_cuda, source="flash_attention.cu", bind=_bind,
    replaces="lightctr_tpu/nn/flash_attention.py:164", cost=_cost,
)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = 256,
                    block_k: int = 512) -> torch.Tensor:
    """Dispatch: exact attention over [B, T, H, D] -> [B, T, H, D] in
    ``q``'s dtype.  The plain version on CPU tensors, the CUDA kernel on
    CUDA tensors (float32, bfloat16 or float16, any D; the design by
    :func:`flash_route`)."""
    validate_blocks(q.shape[1], block_q, block_k)
    if not (k.device == v.device == q.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    return sk.dispatch("flash_attention", q.device)(q, k, v, causal)
