"""Plain PyTorch version of the fused quantize kernel K1.

The same function as ``repro.kernels.dfxp.ref.dfxp_quantize_ref`` and as
``core.quant.fixed_round``'s composite: used by the CPU path of
:func:`repro_torch.kernels.dfxp.ops.dfxp_quantize` and by the tests that
hold K1 against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.packed import qrange
from repro_torch.core.quant import exact_pow2


def dfxp_quantize_ref(x: torch.Tensor, e, *, width: int):
    """Returns ``(y, stats[2])``: ``y`` = ``x`` rounded half-to-even onto
    the ``width``-bit grid of step ``2**e`` and clipped, in ``x``'s dtype;
    ``stats`` = (n_overflow, n_overflow_half) as float32."""
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    qmax, qmin = qrange(width)
    step = exact_pow2(e)
    m = torch.round(x.to(torch.float32) / step)
    ovf = torch.count_nonzero((m > qmax) | (m < qmin))
    ovfh = torch.count_nonzero((m > qmax / 2) | (m < qmin / 2))
    y = m.clamp_(qmin, qmax).mul_(step).to(x.dtype)
    return y, torch.stack([ovf, ovfh]).to(torch.float32)
