"""Seeded inputs and cost model of the quantized matmul kernel K2.

Shared by the card tests and ``chip_smoke.py``: :func:`qmm_case` returns
the arguments of one :func:`~repro_torch.kernels.qmatmul.ops.qmm` call
drawn on ``device`` from ``seed`` (unit-scale operands); :func:`qmm_cost`
the bytes the call must move (each operand read once, the product written
once) and the TF32 tensor-core operations of the kernel's route,
``products · 2·R·C·D``; :func:`qmm_bounds` the least time an H100 could
take on that route (bytes at 3.35 TB/s against those operations at the
dense TF32 rate) beside the float32 bound of ``2·R·C·D`` operations
outside the tensor cores.  :func:`tolerance` is the stated agreement of
K2 with its plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attn.cases import (H100_F32_FLOPS,
                                            H100_TF32_FLOPS, bound_ms)

from .ops import products, shapes

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
    """(bytes, TF32 flops) one call needs on the kernel's route."""
    R, C, D = shapes(a["kind"], a["a"].shape, a["b"].shape)
    n = products(a["width_a"], a["width_b"])
    return 4 * (R * D + D * C + R * C) + 16, n * 2 * R * C * D


def qmm_bounds(a: dict) -> dict:
    """The route's bound and the float32 (SIMT) bound of one call, ms."""
    nbytes, flops = qmm_cost(a)
    R, C, D = shapes(a["kind"], a["a"].shape, a["b"].shape)
    tc, tc_by = bound_ms(nbytes, flops, H100_TF32_FLOPS)
    f32, f32_by = bound_ms(nbytes, 2 * R * C * D, H100_F32_FLOPS)
    return {"products": products(a["width_a"], a["width_b"]),
            "bound_ms": tc, "bound_by": tc_by, "f32_bound_ms": f32,
            "f32_bound_by": f32_by}
