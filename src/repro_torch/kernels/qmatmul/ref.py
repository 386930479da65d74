"""Plain PyTorch version of the quantized matmul kernel K2.

Rounds each operand that has a width onto its DFXP grid (the reference's
``qmatmul/ref.py::_q`` and the kernel's ``_load``), then runs one float32
``torch.matmul`` in the requested layout.  Used by the CPU path of
:func:`repro_torch.kernels.qmatmul.ops.qmm` and by the tests that hold K2
against it on the card.
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
