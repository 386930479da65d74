"""Seeded inputs and cost model of the fused quantize kernel K1.

Shared by the card tests and ``chip_smoke.py``: :func:`quantize_case`
returns the arguments of one :func:`~repro_torch.kernels.dfxp.ops.dfxp_quantize`
call drawn on ``device`` from ``seed``; :func:`quantize_cost` the bytes
the call must move (``x`` read once, ``y`` written once) and its
floating-point operations (two multiplies per element), from which
:func:`repro_torch.kernels.attn.cases.bound_ms` gives the least time an
H100 could take.
"""
from __future__ import annotations

import torch


def quantize_case(shape, *, dtype=torch.float32, e: float = -6.0,
                  width: int = 10, scale: float = 4.0, seed: int = 0,
                  device="cuda", specials: bool = False) -> dict:
    """``x`` ~ N(0, scale²) in ``dtype``; ``specials`` plants NaN, ±inf,
    exact grid ties and values at the range's edges."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float32) * scale
    if specials:
        flat = x.view(-1)
        step = 2.0 ** e
        qmax = 2 ** (width - 1) - 1
        vals = [float("nan"), float("inf"), float("-inf"), 0.5 * step,
                1.5 * step, -2.5 * step, (qmax + 0.5) * step,
                -(qmax + 1.5) * step, (qmax / 2 + 0.25) * step, -0.0]
        idx = torch.randperm(flat.numel(), generator=g)[:len(vals)]
        flat[idx] = torch.tensor(vals)
    return {"x": x.to(dtype).to(device), "e": e, "width": width}


def quantize_cost(a: dict):
    """(bytes, flops) one call needs."""
    x = a["x"]
    return 2 * x.numel() * x.element_size() + 8 + 16, 2 * x.numel()
