"""Ring attention — sequence parallelism over a ``seq`` mesh.

The port's counterpart of ``lightctr_tpu/nn/ring_attention.py``.  Each rank
of a ``seq`` mesh (``core.mesh.make_mesh(MeshSpec(seq=n))``) holds one
sequence block of Q, K and V.  The K/V blocks rotate around the ring, rank
r sending to rank (r + 1) mod n, while every rank accumulates its queries'
attention with an online softmax (running max ``m``, denominator ``l`` and
numerator ``o``, all float32).  After n hops every query block has seen
every key block: exact attention that never holds the [T, T] matrix.
Causal masking uses global positions, so the sharded result equals
single-device causal attention.

The JAX function runs under ``shard_map``; here each rank runs
:func:`ring_attention_local` in its own process over ``torch.distributed``
(the hops are ``dist/collectives.ring_shift_all``, which stages CUDA tensors
through host memory on a gloo group and ships 16-bit floats as bytes), and
:func:`ring_self_attention` all-gathers the blocks at the end, which is
what ``shard_map``'s ``out_specs`` hands the JAX caller.  The per-hop
products are ``torch.einsum``: XLA ran them outside any kernel.

Differentiable, as the JAX function is (``lax.ppermute`` has a transpose):
each hop is a ``torch.autograd.Function`` whose backward is the reverse
hop, so dK and dV travel home one hop at a time; autograd keeps one score
block a hop, as the JAX ``fori_loop`` keeps its residuals.  In
:func:`ring_self_attention` every rank passes the same global tensors and
gets the gradient of the global q, k and v, as ``jax.grad`` of the JAX
function gives: the output gather's backward keeps the rank's own block of
the cotangent, and the block slice's backward all-gathers the blocks'
gradients in sequence order.

:func:`full_attention` is the single-device oracle at the same [B, T, H, D]
layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from lightctr_tpu_torch.dist import collectives

NEG_INF = -1e30


class _RingHop(torch.autograd.Function):
    """One K/V hop round the ring (both in one batch); the backward sends
    their gradients the other way round, to the rank they came from."""

    @staticmethod
    def forward(ctx, mesh, k, v):
        ctx.mesh = mesh
        return tuple(collectives.ring_shift_all(mesh, (k, v)))

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = collectives.ring_shift_all(ctx.mesh, (dk, dv), reverse=True)
        return None, dk, dv


class _SeqBlocks(torch.autograd.Function):
    """This rank's sequence block of each of the global q, k and v; the
    backward all-gathers the blocks' gradients in sequence order, so every
    rank gets the global gradient."""

    @staticmethod
    def forward(ctx, mesh, tb, *xs):
        ctx.mesh = mesh
        r = mesh.rank
        return tuple(x[:, r * tb:(r + 1) * tb].contiguous() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(
            collectives.all_gather(ctx.mesh, g.transpose(0, 1).contiguous())
            .transpose(0, 1).contiguous() for g in grads)


class _GatherSeq(torch.autograd.Function):
    """The blocks of every rank along the sequence dim; each rank computes
    the same loss over the result, so the backward keeps the rank's own
    block of the cotangent (a sum over ranks would scale it by n)."""

    @staticmethod
    def forward(ctx, mesh, local):
        ctx.mesh, ctx.tb = mesh, local.shape[1]
        # rank order is sequence order
        return collectives.all_gather(
            mesh, local.transpose(0, 1).contiguous()).transpose(0, 1) \
            .contiguous()

    @staticmethod
    def backward(ctx, grad):
        r, tb = ctx.mesh.rank, ctx.tb
        return None, grad[:, r * tb:(r + 1) * tb].contiguous()


def ring_attention_local(mesh, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool = False
                         ) -> torch.Tensor:
    """One rank's ring attention: ``q``, ``k``, ``v`` [B, Tb, H, D] are
    this rank's sequence block; returns its queries' attention over the
    whole ring's keys, [B, Tb, H, D] in ``q``'s dtype."""
    b, tb, h, d = q.shape
    n, my = mesh.size, mesh.rank
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                          device=dev))
    q_pos = my * tb + torch.arange(tb, device=dev)
    qf = q.float()
    m = torch.full((b, h, tb), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tb), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, tb, d), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(n):
        # the block held now arrived from rank (my - i) mod n
        src = (my - i) % n
        k_pos = src * tb + torch.arange(tb, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s,
                            torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v_cur.dtype).float(), v_cur.float())
        m = m_new
        # the last hop's rotation would be discarded: skip it
        if i < n - 1:
            k_cur, v_cur = _RingHop.apply(mesh, k_cur, v_cur)
    # fully masked rows have l == 0
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


def ring_self_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, axis: str = "seq",
                        causal: bool = False) -> torch.Tensor:
    """Exact multi-head attention with the sequence dim sharded over the
    mesh's ``axis`` ring.  Every rank passes the same global ``q``, ``k``,
    ``v`` [B, T, H, D], keeps block ``[r*T/n, (r+1)*T/n)``, and gets the
    full [B, T, H, D] result back, differentiable in q, k and v."""
    mesh.require_axis(axis, "ring_self_attention")
    n = mesh.size
    t = q.shape[1]
    if t % n != 0:
        raise ValueError(f"sequence length {t} not divisible by ring size {n}")
    blocks = _SeqBlocks.apply(mesh, t // n, q, k, v)
    return _GatherSeq.apply(mesh, ring_attention_local(mesh, *blocks,
                                                       causal=causal))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device exact attention (the test oracle and the
    short-sequence core).  ``key_mask`` [B, T] zeroes attention TO padded
    keys.  Scores are divided by ``sqrt(D)`` in the input's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        t = q.shape[1]
        pos = torch.arange(t, device=q.device)
        s = torch.where((pos[:, None] >= pos[None, :])[None, None], s, neg)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] > 0, s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
