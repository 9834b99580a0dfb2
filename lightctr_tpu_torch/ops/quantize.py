"""Quantization codecs: quantile compression and low-bit helpers.

The port's counterpart of ``lightctr_tpu/ops/quantize.py`` (which
re-designs ``util/quantile_compress.h``): floats are encoded to
``bits``-wide codes through a quantile table built from a distribution
assumption — UNIFORM / LOG / NORMAL / CUSTOM CDF (quantile_compress.h:71-107);
encode is a binary search into the table (compress, quantile_compress.h:
38-47), decode a table lookup (extract, quantile_compress.h:49-57).  The
coded collectives of ``dist/collectives.py`` build their tables here; the
encode on the card is the ``quantize_pack`` kernel (``ops/sparse_kernels``).

Tables are float32 and built with the JAX package's own float32 arithmetic,
so the two packages agree on them: uniform tables bit for bit (see
:func:`_linspace`), normal and log tables within a few ulp (``ndtri`` and
``pow`` differ by ulps between the two libraries).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lightctr_tpu_torch.ops.significance import inverse_normal_cdf


class QuantTable(NamedTuple):
    boundaries: torch.Tensor  # [2^bits - 1] upper boundaries for bucketing
    values: torch.Tensor      # [2^bits] reconstruction values
    bits: int


def _f32(x, device) -> torch.Tensor:
    """A Python float or a 0-d tensor as a float32 0-d tensor on ``device``
    (a tensor keeps its own device: the measured range of a dynamic
    codec lives where its payload lives)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``fma(a, b, c)`` of float32 tensors, rounded once, as XLA's CPU
    code computes a contracted multiply-add.  The product is exact in
    float64; the float64 sum is rounded to odd (its exact error from
    TwoSum decides), which makes the final rounding to float32 the single
    correct rounding of ``a*b + c``."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int
              ) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` bit for bit, in float32.

    ``torch.linspace`` rounds differently (it fills the top half of the
    range back from ``stop``).  JAX computes ``start * (1 - i/div) +
    stop * (i/div)`` for ``i < div = num - 1`` and appends ``stop``; XLA on
    the CPU turns ``i/div`` into ``i * (1/div)`` and contracts the final
    add into a fused multiply-add.  For the power-of-two ``div`` of every
    quantile table (2^bits intervals) ``1/div`` is exact, so the result is
    ``fma(stop, step, start * (1 - step))`` — except, for ``div <= 32``,
    at ``i == 1``, where XLA's code fuses the other product:
    ``fma(start, 1 - step, stop * step)``.  (Held to ``jnp.linspace`` bit
    for bit over random ranges and every table size in the tests.)"""
    div = num - 1
    dev = start.device
    step = (torch.arange(div, dtype=torch.float32, device=dev)
            / torch.tensor(float(div), dtype=torch.float32, device=dev))
    head = start * (1 - step)
    fused = fma_f32(stop.expand_as(step), step, head)
    if 2 <= div <= 32:
        fused[1] = fma_f32(start, 1 - step[1], stop * step[1])
    return torch.cat([fused, stop.reshape(1)])


def build_table(
    min_val,
    max_val,
    bits: int = 8,
    mode: str = "uniform",
    custom_cdf_values: Optional[torch.Tensor] = None,
    device=None,
) -> QuantTable:
    """Quantile tables (quantile_compress.h:71-107).  ``min_val`` /
    ``max_val`` are Python floats or 0-d tensors (a measured range); the
    table lives on the range's device, or on ``device`` (default CPU) for
    Python floats."""
    dev = torch.device(device) if device is not None else None
    for v in (min_val, max_val):
        if isinstance(v, torch.Tensor):
            dev = v.device
    dev = dev if dev is not None else torch.device("cpu")
    n = 1 << bits
    lo, hi = _f32(min_val, dev), _f32(max_val, dev)
    if mode == "uniform":
        edges = _linspace(lo, hi, n + 1)
    elif mode == "log":
        # log-spaced quantiles, sign-symmetric around 0 like the reference's
        # LOG mode for gradient-ish distributions (jnp.geomspace: 10 **
        # linspace(log10(start), log10(stop)))
        top = torch.maximum(lo.abs(), hi.abs())
        start = _f32(1e-8, dev)
        mags = torch.pow(_f32(10.0, dev), _linspace(
            torch.log10(start), torch.log10(top), n // 2 + 1))
        edges = torch.cat([-mags.flip(0), mags[1:]])
    elif mode == "normal":
        p = _linspace(_f32(1e-6, dev), _f32(1 - 1e-6, dev), n + 1)
        if isinstance(min_val, torch.Tensor) or isinstance(max_val,
                                                           torch.Tensor):
            span = (hi - lo) / 2.0
            center = (hi + lo) / 2.0
        else:
            # Python floats: the JAX package does this arithmetic in
            # float64 and meets the float32 array afterwards
            span = (float(max_val) - float(min_val)) / 2.0
            center = (float(max_val) + float(min_val)) / 2.0
        edges = center + inverse_normal_cdf(p) * span / 3.0
    elif mode == "custom":
        if custom_cdf_values is None:
            raise ValueError("custom mode needs custom_cdf_values")
        edges = torch.as_tensor(custom_cdf_values, dtype=torch.float32,
                                device=dev)
        if edges.shape[0] != n + 1:
            raise ValueError(f"custom table needs {n + 1} edges, "
                             f"got {edges.shape[0]}")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    edges = edges.to(torch.float32)
    values = 0.5 * (edges[:-1] + edges[1:])
    return QuantTable(boundaries=edges[1:-1].contiguous(),
                      values=values.contiguous(), bits=bits)


def code_dtype(bits: int) -> torch.dtype:
    """uint8 codes up to 8 bits, uint16 above (``compress``'s dtype)."""
    return torch.uint8 if bits <= 8 else torch.uint16


def compress(table: QuantTable, x: torch.Tensor) -> torch.Tensor:
    """float -> code (binary search, quantile_compress.h:38-47):
    ``searchsorted(boundaries, x, side='left')``, NaN to the top code as in
    the JAX package."""
    codes = torch.searchsorted(table.boundaries, x.contiguous(), side="left")
    return codes.to(code_dtype(table.bits))


def extract(table: QuantTable, codes: torch.Tensor) -> torch.Tensor:
    """code -> float (table lookup, quantile_compress.h:49-57)."""
    return table.values[codes.to(torch.int64)]


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """4-bit codes (values 0..15) -> bit-packed bytes, two codes per byte
    — the sub-byte wire form behind ``wire_bits=4``.  Low nibble is the
    EVEN element; an odd count pads one zero code that
    :func:`unpack_nibbles` slices back off.  Flattens."""
    c = codes.to(torch.uint8).reshape(-1)
    if c.shape[0] % 2:
        c = torch.cat([c, c.new_zeros(1)])
    pairs = c.reshape(-1, 2)
    return pairs[:, 0] | (pairs[:, 1] << 4)


def unpack_nibbles(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: ``n`` 4-bit codes back out of the
    byte stream (uint8 values 0..15)."""
    p = packed.to(torch.uint8).reshape(-1)
    lo = p & 0x0F
    hi = (p >> 4) & 0x0F
    return torch.stack([lo, hi], dim=1).reshape(-1)[:n]
