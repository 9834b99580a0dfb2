"""Self-attention sequence CTR model on tensors.

The port's counterpart of ``lightctr_tpu/models/attention_ctr.py``: a
user's behavior sequence of item ids is embedded (plus learned position
embeddings), encoded by pre-norm self-attention blocks (RMSNorm, residual,
a GELU FFN), masked-mean pooled and scored.

Attention is :func:`lightctr_tpu_torch.nn.ring_attention.full_attention`
with key-padding masks, as in the JAX model, which calls no kernel:
behavior sequences are short, so the [T, T] scores are cheap, and the
flash kernel takes no key-padding mask.  Two details follow the JAX
package's defaults: ``jax.nn.gelu`` is the tanh approximation
(``F.gelu(x, approximate="tanh")``), and RMSNorm's eps of 1e-6 sits inside
the rsqrt.  The embedding gather goes through ``embed.table.lookup``.

Trains through CTRTrainer: ``batch = {"seq_ids": [B, T] int, "seq_mask":
[B, T] float, "labels": [B]}``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.nn import dense
from lightctr_tpu_torch.nn.ring_attention import full_attention


def init(generator: torch.Generator, vocab: int, dim: int = 32,
         n_heads: int = 4, n_layers: int = 2, max_len: int = 128,
         ffn_mult: int = 2, device="cpu") -> Dict:
    """embed ~ N(0, 1/dim), pos ~ N(0, 0.02^2), per block qkv / out / ffn1
    / ffn2 as ``dense.init(scale="fan_in")`` and unit RMSNorm scales, the
    head ``dense.init(dim, 1, "fan_in")``; drawn in that order from
    ``generator`` on its device, moved to ``device``."""
    if dim % n_heads:
        raise ValueError(f"dim {dim} not divisible by n_heads {n_heads}")
    gdev = generator.device
    embed = torch.randn((vocab, dim), generator=generator,
                        dtype=torch.float32, device=gdev)
    pos = torch.randn((max_len, dim), generator=generator,
                      dtype=torch.float32, device=gdev)
    blocks = []
    for _ in range(n_layers):
        blocks.append({
            "qkv": dense.init(generator, dim, 3 * dim, scale="fan_in",
                              device=device),
            "out": dense.init(generator, dim, dim, scale="fan_in",
                              device=device),
            "ffn1": dense.init(generator, dim, ffn_mult * dim,
                               scale="fan_in", device=device),
            "ffn2": dense.init(generator, ffn_mult * dim, dim,
                               scale="fan_in", device=device),
            "ln1": torch.ones((dim,), dtype=torch.float32, device=device),
            "ln2": torch.ones((dim,), dtype=torch.float32, device=device),
        })
    return {
        "embed": (embed / math.sqrt(float(dim))).to(device),
        "pos": (pos * 0.02).to(device),
        "blocks": blocks,
        "head": dense.init(generator, dim, 1, scale="fan_in", device=device),
    }


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + 1e-6) * scale


def _mha(block: Dict, x: torch.Tensor, key_mask: torch.Tensor,
         n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // n_heads
    qkv = dense.apply(block["qkv"], x)                           # [B, T, 3D]
    q, k, v = torch.split(qkv, d, dim=-1)

    def to_heads(z):
        return z.reshape(b, t, n_heads, hd)

    ctx = full_attention(to_heads(q), to_heads(k), to_heads(v),
                         key_mask=key_mask).reshape(b, t, d)
    return dense.apply(block["out"], ctx)


def make_logits(n_heads: int):
    """A ``logits(params, batch)`` closure over the static head count
    (kept out of the params tree so optimizers never see it)."""

    def logits(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = batch["seq_ids"]                                   # [B, T]
        mask = batch["seq_mask"]                                 # [B, T]
        t = ids.shape[1]
        max_len = params["pos"].shape[0]
        if t > max_len:
            raise ValueError(f"sequence length {t} exceeds the model's "
                             f"max_len {max_len}")
        x = lookup(params["embed"], ids) + params["pos"][None, :t]
        x = x * mask[..., None]
        for block in params["blocks"]:
            x = x + _mha(block, _rms_norm(x, block["ln1"]), mask, n_heads)
            h = _rms_norm(x, block["ln2"])
            x = x + dense.apply(block["ffn2"], F.gelu(
                dense.apply(block["ffn1"], h), approximate="tanh"))
        # masked mean pool over real positions
        denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
        pooled = torch.sum(x * mask[..., None], dim=1) / denom   # [B, D]
        return dense.apply(params["head"], pooled)[:, 0]

    return logits


def build(generator: torch.Generator, vocab: int, dim: int = 32,
          n_heads: int = 4, n_layers: int = 2, max_len: int = 128,
          ffn_mult: int = 2, device="cpu"):
    """(params, logits_fn) pair ready for CTRTrainer."""
    params = init(generator, vocab, dim, n_heads, n_layers, max_len,
                  ffn_mult, device=device)
    return params, make_logits(n_heads)
