"""Seeded inputs and cost model of the quantized matmul kernel K2.

Shared by the card tests and ``chip_smoke.py``: :func:`qmm_case` returns
the arguments of one :func:`~repro_torch.kernels.qmatmul.ops.qmm` call
drawn on ``device`` from ``seed`` (unit-scale operands); :func:`qmm_cost`
the bytes the call must move (each operand read once, the product written
once) and its ``2·R·C·D`` float32 operations, from which
:func:`repro_torch.kernels.attn.cases.bound_ms` gives the least time an
H100 could take.  :func:`tolerance` is the stated agreement of K2 with its
plain version.
"""
from __future__ import annotations

import math

import torch

from .ops import shapes

RTOL = 1e-5


def tolerance(D: int) -> dict:
    """``rtol=1e-5``, ``atol=1e-5·sqrt(D)`` on unit-scale operands: both
    sides accumulate D float32 products, in different orders."""
    return {"rtol": RTOL, "atol": 1e-5 * math.sqrt(max(D, 1))}


def qmm_case(kind: str, R: int, C: int, D: int, *, width_a=None, width_b=10,
             e_a: float = -7.0, e_b: float = -7.0, seed: int = 0,
             device="cuda") -> dict:
    g = torch.Generator().manual_seed(seed)
    a_shape = (D, R) if kind == "tn" else (R, D)
    b_shape = (C, D) if kind == "nt" else (D, C)
    a = torch.randn(a_shape, generator=g)
    b = torch.randn(b_shape, generator=g)
    return {"a": a.to(device), "b": b.to(device), "e_a": e_a, "e_b": e_b,
            "kind": kind, "width_a": width_a, "width_b": width_b}


def qmm_cost(a: dict):
    """(bytes, flops) one call needs."""
    R, C, D = shapes(a["kind"], a["a"].shape, a["b"].shape)
    return 4 * (R * D + D * C + R * C) + 16, 2 * R * C * D
