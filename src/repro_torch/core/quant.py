"""Quantizers and autodiff plumbing for low-precision training (paper §4-§7).

Simulation contract (paper §7): values are held in wide float containers
but are *representable* in the target format every time they cross a
group boundary — activations and weights on the forward pass, cotangents
on the backward pass, parameters at update time.  Accumulations stay wide
(float32).

Autodiff design, as in ``repro.core.quant``:
  * :func:`qbound` rounds the forward value with the *activation* format
    and the backward cotangent with the *gradient* format (a
    ``torch.autograd.Function``).
  * Backward-pass overflow statistics leave the backward as the
    **gradient of a zero-valued sink**: a ``(3,)`` tensor that requires
    grad, passed to the site and differentiated with the parameters
    (``torch.autograd.grad(loss, [*params, *sinks])``).  Its gradient is
    the site's ``(n_overflow, n_overflow_at_half_scale, n_total)``, and
    two uses of one sink add, exactly as ``jax.grad(..., argnums=sinks)``
    gives them.  Under :class:`Observe` the first slot carries ``max|ct|``.
  * :func:`ste_quant` rounds the forward value and passes the cotangent
    straight through.
  * :func:`qbound_site` and :func:`ste_site` also return the forward
    statistics from the same rounding pass (the tape's one-pass site).

Scale exponents are float32 tensors holding integer values; the grid step
is ``2**e``, built exactly by :func:`exact_pow2`.  :func:`fixed_round`
routes to the hand-written quantize kernel K1 under
:func:`enable_pallas_quantize`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import prng
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


# The name is the reference's (``repro.core.quant._PALLAS``), so a reader
# finds the switch; here it routes to the CUDA kernel K1.
_PALLAS = {"enabled": False, "min_size": 1 << 14}


def enable_pallas_quantize(enable: bool = True, *,
                           min_size: int = 1 << 14) -> None:
    """Route :func:`fixed_round` to the fused quantize kernel K1
    (:func:`repro_torch.kernels.dfxp.ops.dfxp_quantize`) for calls with a
    scalar ``e``, deterministic rounding and ``x.numel() >= min_size``, as
    the reference routes them to its Pallas kernel (``quant.py:90-95``).
    Identical numbers (K1 is bit-exact with the composite); one pass over
    ``x`` instead of several.  Off by default, as in the reference.  On
    the CPU the wrapper computes K1's plain version."""
    _PALLAS.update(enabled=bool(enable), min_size=int(min_size))


def round_mantissa(m: Tensor, key=None, det: Optional[Tensor] = None
                   ) -> Tensor:
    """``m`` rounded to integers: half-to-even, or with ``key`` stochastically,
    ``floor(m + u)`` with ``u`` uniform from threefry (the reference's draw,
    bit for bit).  One key draws over all of ``m``; a batch ``[B, 2]`` draws
    one stream per row of ``m`` [B, ...] (the reference's ``vmap``), and
    ``det`` [B] then rounds its rows to nearest instead."""
    if key is None:
        return torch.round(m)
    key = prng.as_key(key, m.device)
    s = torch.floor(m + prng.uniform(key, tuple(m.shape[key.ndim - 1:])))
    if det is None:
        return s
    return torch.where(det.reshape((-1,) + (1,) * (m.ndim - 1)),
                       torch.round(m), s)


def fixed_round(x: Tensor, width: int, e, *, stochastic: bool = False,
                key: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Round ``x`` onto the grid ``k * 2**e``, ``k`` two's-complement ``width``-bit.

    Round-half-to-even, or with ``stochastic=True`` ``floor(x / 2**e + u)``
    with ``u`` uniform from the threefry ``key`` (the reference's draw,
    bit for bit).  Returns ``(y, (n_overflow, n_overflow_half))``:
    ``n_overflow`` counts pre-clip values outside the representable range,
    ``n_overflow_half`` those that would overflow at ``e - 1`` — the two
    statistics of the paper's controller (§5), as float32 scalars.
    Stochastic rounding never takes K1, as the reference's never takes its
    kernel.
    """
    if (_PALLAS["enabled"] and not stochastic
            and x.numel() >= _PALLAS["min_size"]
            and (e.ndim == 0 if isinstance(e, Tensor)
                 else isinstance(e, (int, float)))):
        # K1 takes a number by value and a tensor where it lies, so a
        # number is not first copied to the card
        from repro_torch.kernels.dfxp.ops import dfxp_quantize
        y, stats = dfxp_quantize(x.contiguous(), e, width=width)
        return y, (stats[0], stats[1])
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    step = exact_pow2(e)
    qmax = float(2 ** (width - 1) - 1)
    qmin = -float(2 ** (width - 1))
    if stochastic and key is None:
        raise ValueError("stochastic rounding requires a PRNG key")
    m = round_mantissa(x.to(torch.float32) / step,
                       key if stochastic else None)
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


def _site_stats(x: Tensor, fmt: Format, e) -> Tuple[Tensor, Tensor]:
    """``(q_value(x), q_stats(x))`` from one rounding pass where the
    format rounds onto a fixed-point grid."""
    if isinstance(fmt, (FixedPoint, DynamicFixedPoint)):
        ee = float(fmt.exp) if isinstance(fmt, FixedPoint) else e
        y, (ovf, ovfh) = fixed_round(x, fmt.width, ee)
        n = torch.tensor(float(x.numel()), dtype=torch.float32,
                         device=x.device)
        return y, torch.stack([ovf, ovfh, n])
    return q_value(x, fmt, e), q_stats(x, fmt, e)


def _forward(x: Tensor, fmt: Format, e,
             want_stats: bool) -> Tuple[Tensor, Optional[Tensor]]:
    if want_stats:
        return _site_stats(x, fmt, e)
    return q_value(x, fmt, e), None


def _no_grad_flows(*ts) -> bool:
    return not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad for t in ts)


class _QBound(torch.autograd.Function):
    """Forward value in ``act_fmt``; cotangent in ``grad_fmt``; the
    cotangent's statistics as the gradient of ``sink``."""

    @staticmethod
    def forward(ctx, x, act_e, grad_e, sink, act_fmt, grad_fmt, want_stats):
        ctx.grad_fmt = grad_fmt
        ctx.grad_e = grad_e
        y, stats = _forward(x, act_fmt, act_e, want_stats)
        if stats is not None:
            ctx.mark_non_differentiable(stats)
        return (x.view_as(x) if y is x else y), stats

    @staticmethod
    def backward(ctx, ct, _):
        fmt = ctx.grad_fmt
        n = float(ct.numel())
        dev = ct.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        total = torch.tensor(n, dtype=torch.float32, device=dev)
        if isinstance(fmt, Observe):
            stats = torch.stack([ct.to(torch.float32).abs().max(), zero, total])
            return ct, None, None, stats, None, None, None
        if isinstance(fmt, (FixedPoint, DynamicFixedPoint)):
            qct, stats = _site_stats(ct, fmt, ctx.grad_e)
        elif isinstance(fmt, FloatFormat):
            qct = float_round(ct, fmt)
            stats = torch.stack([zero, zero, total])
        else:                                   # None: pass-through
            qct = ct
            stats = torch.zeros((3,), dtype=torch.float32, device=dev)
        return qct, None, None, stats, None, None, None


class _STE(torch.autograd.Function):
    """Forward value in ``fmt``; identity backward."""

    @staticmethod
    def forward(ctx, x, e, fmt, want_stats):
        y, stats = _forward(x, fmt, e, want_stats)
        if stats is not None:
            ctx.mark_non_differentiable(stats)
        return (x.view_as(x) if y is x else y), stats

    @staticmethod
    def backward(ctx, ct, _):
        return ct, None, None, None


def new_sink(device=None) -> Tensor:
    """A fresh statistics sink for one quantization site: a zero ``(3,)``
    tensor whose gradient will hold the site's backward statistics."""
    return torch.zeros((3,), dtype=torch.float32, device=device,
                       requires_grad=True)


def qbound_site(x: Tensor, act_fmt: Format, grad_fmt: Format, act_e, grad_e,
                sink: Optional[Tensor], *,
                want_stats: bool) -> Tuple[Tensor, Optional[Tensor]]:
    """:func:`qbound`, plus the forward statistics of ``x`` in ``act_fmt``
    (``q_stats``) from the same rounding pass when ``want_stats``.  Where
    no gradient can flow (serving, evaluation) it is the forward alone."""
    if _no_grad_flows(x, sink):
        return _forward(x, act_fmt, act_e, want_stats)
    if sink is None:
        sink = torch.zeros((3,), dtype=torch.float32, device=x.device)
    return _QBound.apply(x, act_e, grad_e, sink, act_fmt, grad_fmt,
                         want_stats)


def qbound(x: Tensor, act_fmt: Format, grad_fmt: Format, act_e, grad_e,
           sink: Optional[Tensor] = None) -> Tensor:
    """Quantize the forward value with ``act_fmt`` and the cotangent with
    ``grad_fmt``.  ``sink`` is a zero ``(3,)`` tensor (:func:`new_sink`);
    its gradient receives the backward-pass overflow statistics."""
    if act_fmt is None and grad_fmt is None:
        return x
    return qbound_site(x, act_fmt, grad_fmt, act_e, grad_e, sink,
                       want_stats=False)[0]


def ste_site(x: Tensor, fmt: Format, e, *,
             want_stats: bool) -> Tuple[Tensor, Optional[Tensor]]:
    """:func:`ste_quant`, plus the forward statistics of ``x`` from the
    same rounding pass when ``want_stats``."""
    if _no_grad_flows(x):
        return _forward(x, fmt, e, want_stats)
    return _STE.apply(x, e, fmt, want_stats)


def ste_quant(x: Tensor, fmt: Format, e) -> Tensor:
    """Forward quantization with a straight-through (identity) backward.

    Used for *weight use-time* quantization: the stored (update-width)
    parameter is re-quantized to the computation width when it enters a
    multiplication; its gradient is quantized once, in the train step."""
    if fmt is None:
        return x
    return ste_site(x, fmt, e, want_stats=False)[0]
