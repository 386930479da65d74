"""Packed int-mantissa storage (beyond paper): ``mantissa * 2**exp``.

The serve-side KV pool keeps K/V as int8/int16 mantissas plus a
power-of-two step, and packed training storage keeps parameters and
momentum so; :func:`pack` and :func:`pack_rows` quantize into those
containers, :func:`unpack` reads them back, and :func:`_overflow_counts`
gives the §5 controller its pair of statistics.  Rounding is to nearest
even, or stochastic (``floor(m + u)``) with ``u`` drawn from threefry keys
(:mod:`repro_torch.core.prng`) as the reference draws it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .quant import exact_pow2, round_mantissa

Tensor = torch.Tensor


def container_dtype(width: int) -> torch.dtype:
    if width <= 8:
        return torch.int8
    if width <= 16:
        return torch.int16
    return torch.int32


@dataclasses.dataclass
class PackedArray:
    """int mantissa + log2-step; represents ``mantissa * 2**exp``."""

    mantissa: Tensor                    # int8/int16/int32
    exp: Tensor                         # f32 (integer-valued)
    width: int = 16

    @property
    def shape(self):
        return self.mantissa.shape

    @property
    def size(self) -> int:
        return self.mantissa.numel()


def qrange(width: int):
    """(qmax, qmin) of a two's-complement ``width``-bit mantissa."""
    return float(2 ** (width - 1) - 1), -float(2 ** (width - 1))


def _overflow_counts(m: Tensor, width: int, axes=None, mask=None):
    """(n_ovf, n_ovf_at_half_scale) over ``axes`` — the §5 controller pair.

    ``qmin = -(qmax + 1)`` is representable and does not count as
    overflow (the two's-complement range of ``quant.fixed_round``).
    ``mask`` (bool, broadcastable to ``m``) restricts the count to the
    selected elements.  Counts are taken in int64 and returned float32.
    """
    qmax, qmin = qrange(width)
    over = (m > qmax) | (m < qmin)
    overh = (m > qmax / 2) | (m < qmin / 2)
    if mask is not None:
        over = over & mask
        overh = overh & mask
    if axes is None:
        return (torch.count_nonzero(over).to(torch.float32),
                torch.count_nonzero(overh).to(torch.float32))
    return (over.sum(dim=axes).to(torch.float32),
            overh.sum(dim=axes).to(torch.float32))


def pack_overflow_stats(x: Tensor, width: int, e) -> Tensor:
    """Same ``(ovf, ovf_half, total)`` triple as ``quant.fixed_round``, for
    packing: ``x / 2**e`` rounded half-even, counted against the
    ``width``-bit range."""
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    m = torch.round(x.to(torch.float32) / exact_pow2(e))
    ovf, ovfh = _overflow_counts(m, width)
    return torch.stack([ovf, ovfh, torch.tensor(float(x.numel()),
                                                dtype=torch.float32,
                                                device=x.device)])


def pack(x: Tensor, width: int, e, *, stochastic_key=None) -> PackedArray:
    """``x / 2**e`` rounded half-even, or stochastically with
    ``stochastic_key``, clipped into a ``width``-bit container."""
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    qmax, qmin = qrange(width)
    m = round_mantissa(x.to(torch.float32) / exact_pow2(e), stochastic_key)
    m = m.clamp_(qmin, qmax)
    return PackedArray(m.to(container_dtype(width)), e, width)


def unpack(p: PackedArray, dtype=torch.float32) -> Tensor:
    """``mantissa * 2**exp`` in ``dtype``."""
    return (p.mantissa.to(torch.float32) * exact_pow2(p.exp)).to(dtype)


def pack_rows(x: Tensor, width: int, e: Tensor, *, stochastic_keys=None):
    """Per-row pack with per-row overflow statistics.

    ``x``: [B, ...]; ``e``: [B] log2-steps; ``stochastic_keys``: optional
    [B, 2] keys giving every row its own rounding stream (the reference's
    ``vmap`` of ``uniform`` over them).  Returns ``(mantissa int[B, ...],
    stats f32[B, 3])`` with the ``(n_overflow, n_overflow_at_half_scale,
    n_total)`` triple per row.
    """
    qmax, qmin = qrange(width)
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    step = exact_pow2(e).reshape(e.shape + (1,) * (x.ndim - 1))
    m = round_mantissa(x.to(torch.float32) / step, stochastic_keys)
    axes = tuple(range(1, x.ndim))
    ovf, ovfh = _overflow_counts(m, width, axes=axes)
    total = torch.full(ovf.shape, float(math.prod(x.shape[1:])),
                       dtype=torch.float32, device=x.device)
    stats = torch.stack([ovf, ovfh, total], dim=-1)
    m = m.clamp_(qmin, qmax).to(container_dtype(width))
    return m, stats
