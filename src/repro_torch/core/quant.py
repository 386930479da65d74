"""Quantizers for low-precision arithmetic (paper §4-§7), forward only.

Values are held in wide float containers but are *representable* in the
target format every time they cross a group boundary (paper §7).  This
package serves and does not train, so the sites here are the forward
values of ``repro.core.quant``: :func:`qbound` returns the activation
rounding and :func:`ste_quant` the weight rounding; neither has a
backward.

Scale exponents are float32 tensors holding integer values; the grid step
is ``2**e``, built exactly by :func:`exact_pow2`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .formats import DynamicFixedPoint, FixedPoint, FloatFormat, Format, Observe

Tensor = torch.Tensor

_TINY = 1e-38


def exact_pow2(e) -> Tensor:
    """Bit-exact ``2**e`` for integer-valued float ``e`` (``torch.ldexp``).

    The quantization grid must be an exact power of two or round, clip and
    overflow counting all drift, so it is never built through ``exp2``.
    """
    e = torch.as_tensor(e)
    one = torch.ones(e.shape, dtype=torch.float32, device=e.device)
    return torch.ldexp(one, e.to(torch.int32))


def log2(x: Tensor) -> Tensor:
    """``log(x) / log(2)`` in float32, the formula ``jnp.log2`` lowers to.

    Used where the result is ceiled (calibration, float emulation): at
    ratios that are exact powers of two the rounding of this quotient
    decides the integer, and computing it as the reference does keeps the
    two packages on the same side.
    """
    ln2 = torch.log(torch.tensor(2.0, dtype=torch.float32, device=x.device))
    return torch.log(x) / ln2


def _count(b: Tensor) -> Tensor:
    """Number of true elements as a float32 scalar (counted in int64)."""
    return torch.count_nonzero(b).to(torch.float32)


def fixed_round(x: Tensor, width: int, e, *,
                stochastic: bool = False) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Round ``x`` onto the grid ``k * 2**e``, ``k`` two's-complement ``width``-bit.

    Deterministic round-half-to-even.  Returns ``(y, (n_overflow,
    n_overflow_half))``: ``n_overflow`` counts pre-clip values outside the
    representable range, ``n_overflow_half`` those that would overflow at
    ``e - 1`` — the two statistics of the paper's controller (§5), as
    float32 scalars.
    """
    if stochastic:
        raise NotImplementedError(
            "stochastic rounding needs the threefry PRNG port "
            "(ROADMAP module item 14)")
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    step = exact_pow2(e)
    qmax = float(2 ** (width - 1) - 1)
    qmin = -float(2 ** (width - 1))
    m = torch.round(x.to(torch.float32) / step)     # round-half-to-even
    ovf = _count((m > qmax) | (m < qmin))
    ovf_half = _count((m > qmax / 2) | (m < qmin / 2))
    y = m.clamp_(qmin, qmax).mul_(step)
    return y.to(x.dtype), (ovf, ovf_half)


def float_round(x: Tensor, fmt: FloatFormat) -> Tensor:
    """Round ``x`` to an ``fmt``-representable value (round-to-nearest-even)."""
    if fmt.name == "float32":
        return x
    if fmt.name == "float16":
        return x.to(torch.float16).to(x.dtype)
    if fmt.name == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    # Generic (exp_bits, man_bits) emulation, with subnormals at emin.
    xf = x.to(torch.float32)
    exp = torch.floor(log2(torch.clamp(xf.abs(), min=_TINY)))
    exp = torch.clamp(exp, fmt.emin, fmt.emax)
    step = exact_pow2(exp - fmt.man_bits)
    y = torch.round(xf / step) * step
    y = torch.clamp(y, -fmt.maxval, fmt.maxval)
    return y.to(x.dtype)


def q_value(x: Tensor, fmt: Format, e) -> Tensor:
    """Quantize values only (no stats). ``e`` ignored for float formats."""
    if fmt is None or isinstance(fmt, Observe) or (
            isinstance(fmt, FloatFormat) and fmt.name == "float32"):
        return x
    if isinstance(fmt, FloatFormat):
        return float_round(x, fmt)
    if isinstance(fmt, FixedPoint):
        return fixed_round(x, fmt.width, float(fmt.exp))[0]
    if isinstance(fmt, DynamicFixedPoint):
        return fixed_round(x, fmt.width, e)[0]
    raise TypeError(f"unknown format {fmt!r}")


def q_stats(x: Tensor, fmt: Format, e) -> Tensor:
    """Overflow statistics ``(n_ovf, n_ovf_half, n_total)`` for ``x``.

    For :class:`Observe` (calibration) the first slot carries ``max|x|``
    instead of an overflow count."""
    dev = x.device
    n_total = torch.tensor(float(x.numel()), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if isinstance(fmt, Observe):
        return torch.stack([x.to(torch.float32).abs().max(), zero, n_total])
    if isinstance(fmt, FixedPoint):
        _, (ovf, ovfh) = fixed_round(x, fmt.width, float(fmt.exp))
        return torch.stack([ovf, ovfh, n_total])
    if isinstance(fmt, DynamicFixedPoint):
        _, (ovf, ovfh) = fixed_round(x, fmt.width, e)
        return torch.stack([ovf, ovfh, n_total])
    return torch.stack([zero, zero, n_total])


def qbound(x: Tensor, act_fmt: Format, act_e) -> Tensor:
    """Forward value of the reference's ``qbound``: ``x`` in ``act_fmt``."""
    return q_value(x, act_fmt, act_e)


def ste_quant(x: Tensor, fmt: Format, e) -> Tensor:
    """Forward value of the reference's ``ste_quant``: the stored weight
    re-quantized to the computation width when it enters a product."""
    return q_value(x, fmt, e)
