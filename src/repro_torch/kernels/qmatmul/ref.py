"""Plain PyTorch version of the quantized matmul kernel K2.

Rounds each operand that has a width onto its DFXP grid (the reference's
``qmatmul/ref.py::_q`` and the kernel's ``_load``), then runs one float32
``torch.matmul`` in the requested layout.  Used by the CPU path of
:func:`repro_torch.kernels.qmatmul.ops.qmm` and by the tests that hold K2
against it on the card.

:func:`tf32_round`, :func:`split_tf32` and :func:`qmatmul_tf32_emulated`
emulate the card kernel's arithmetic (TF32 operands, hi + lo splits of the
operands that are not exact in TF32) bit by bit on the operands, for the
CPU tests of that arithmetic; nothing else uses them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packed import qrange
from repro_torch.core.quant import exact_pow2

Tensor = torch.Tensor


def round_operand(x: Tensor, e, width: Optional[int]) -> Tensor:
    """``x`` rounded half-to-even onto the ``width``-bit grid of step
    ``2**e`` and clipped, in float32; ``x`` itself for ``width=None``."""
    if width is None:
        return x
    qmax, qmin = qrange(width)
    step = exact_pow2(torch.as_tensor(e, dtype=torch.float32, device=x.device))
    return torch.round(x.to(torch.float32) / step).clamp_(qmin, qmax).mul_(step)


LO_SCALE = 4096.0      # the kernel keeps lo parts times 2^12
EXACT_WIDTH = 12       # m·2^e with |m| <= 2^11 has <= 11 significant bits


def is_split(width: Optional[int]) -> bool:
    """Whether an operand of this width goes to the tensor cores as hi + lo
    (raw, or rounded at more than :data:`EXACT_WIDTH` bits): a rounding at
    ``width <= 12`` leaves at most 11 significant bits, exact in TF32."""
    return width is None or width > EXACT_WIDTH


def tf32_round(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to TF32 — 10 explicit mantissa bits, f32's
    exponent range — to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does: add half of the dropped 13 low bits to the
    magnitude, then clear them.  Finite inputs only."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: Tensor):
    """``(hi, lo)`` with ``hi = tf32(x)`` and ``lo = tf32((x - hi)·2^12)``:
    ``hi + lo·2^-12`` is ``x`` to about 2^-23 relative."""
    hi = tf32_round(x)
    return hi, tf32_round((x - hi) * LO_SCALE)


def qmatmul_tf32_emulated(a: Tensor, b: Tensor, e_a, e_b, *, kind: str,
                          width_a: Optional[int],
                          width_b: Optional[int]) -> Tensor:
    """The card kernel's route on the CPU: each operand rounded as in
    :func:`qmatmul_ref`; one rounded at ``width <= 12`` used as is (exact
    in TF32), any other split by :func:`split_tf32`; the product
    ``hi_a·hi_b + (lo_a·hi_b + hi_a·lo_b)·2^-12`` (the terms of the parts
    that exist), each term a float32 matmul of TF32 values."""
    aq = round_operand(a, e_a, width_a)
    bq = round_operand(b, e_b, width_b)
    if kind == "nt":
        bq = bq.t()
    elif kind == "tn":
        aq = aq.t()
    elif kind != "nn":
        raise ValueError(f"unknown layout {kind!r}")
    ah, al = split_tf32(aq) if is_split(width_a) else (aq, None)
    bh, bl = split_tf32(bq) if is_split(width_b) else (bq, None)
    out = torch.matmul(ah, bh)
    lo = None
    if al is not None:
        lo = torch.matmul(al, bh)
    if bl is not None:
        lo = torch.matmul(ah, bl) if lo is None else lo + torch.matmul(ah, bl)
    return out if lo is None else out + lo / LO_SCALE


def qmatmul_ref(a: Tensor, b: Tensor, e_a, e_b, *, kind: str,
                width_a: Optional[int], width_b: Optional[int]) -> Tensor:
    """``nn``: q(a)[R,D] @ q(b)[D,C] · ``nt``: q(a)[R,D] @ q(b)[C,D]^T ·
    ``tn``: q(a)[D,R]^T @ q(b)[D,C]; float32 result [R, C]."""
    aq = round_operand(a, e_a, width_a)
    bq = round_operand(b, e_b, width_b)
    if kind == "nn":
        return torch.matmul(aq, bq)
    if kind == "nt":
        return torch.matmul(aq, bq.t())
    if kind == "tn":
        return torch.matmul(aq.t(), bq)
    raise ValueError(f"unknown layout {kind!r}")
