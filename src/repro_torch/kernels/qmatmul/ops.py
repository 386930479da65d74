"""Wrapper of the hand-written quantized matmul kernel K2.

``qmm(a, b, e_a, e_b, kind=, width_a=, width_b=)`` keeps the signature of
``repro.kernels.qmatmul.ops.qmm`` minus the TPU's ``blocks``, ``cast``,
``out_dtype`` and ``interpret``: the CUDA kernel picks its own 64x64
tiles, computes in float32 and has no interpret mode.  Layouts ``nn``
(forward), ``nt`` (dgrad) and ``tn`` (wgrad) as in
``qmatmul_kernel.py:27-35``; each operand has its own optional width
(``None`` = raw).  For tensors on the CPU it computes the plain version in
:mod:`.ref`; for tensors on the card it checks them, launches K2 on the
current stream and raises if the launch fails.  There is no fallback from
one to the other.

``LAUNCHES`` counts kernel launches per layout, incremented where the
kernel launches and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.quant import exact_pow2

from .. import build
from . import ref as R

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"qmm_nn": 0, "qmm_nt": 0, "qmm_tn": 0}
_KIND = {"nn": 0, "nt": 1, "tn": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> int:
    """K2 launches over all three layouts."""
    return sum(LAUNCHES.values())


def shapes(kind: str, a_shape, b_shape):
    """``(R, C, D)`` of a ``kind`` product; raises if the operands'
    contraction dims disagree."""
    if kind == "nn":
        (R, D), (D2, C) = a_shape, b_shape
    elif kind == "nt":
        (R, D), (C, D2) = a_shape, b_shape
    elif kind == "tn":
        (D, R), (D2, C) = a_shape, b_shape
    else:
        raise ValueError(f"unknown layout {kind!r}")
    if D != D2:
        raise ValueError(f"contraction dims disagree: {tuple(a_shape)} x "
                         f"{tuple(b_shape)} ({kind})")
    return R, C, D


def _steps(e, width: Optional[int], device):
    if width is None:
        one = torch.ones((), dtype=torch.float32, device=device)
        return one, one
    e = torch.as_tensor(e, dtype=torch.float32, device=device)
    return exact_pow2(e), exact_pow2(-e)


def qmm(a: Tensor, b: Tensor, e_a, e_b, *, kind: str,
        width_a: Optional[int], width_b: Optional[int]) -> Tensor:
    """Quantized matmul on 2-D operands — K2.  Returns float32 [R, C];
    numerics are :func:`repro_torch.kernels.qmatmul.ref.qmatmul_ref`
    (to f32 summation order)."""
    R_, C_, D_ = shapes(kind, a.shape, b.shape)
    if a.device.type == "cpu":
        return R.qmatmul_ref(a, b, e_a, e_b, kind=kind, width_a=width_a,
                             width_b=width_b)
    if a.device.type != "cuda":
        raise ValueError(f"qmm runs on cpu or cuda, not {a.device}")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"qmm takes float32 operands, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"qmm needs contiguous operands; {name} is not")
    for w in (width_a, width_b):
        if w is not None and not 2 <= w <= 24:
            raise ValueError(f"qmm takes widths in [2, 24] or None, got {w}")
    dev = a.device
    steps = torch.stack([*_steps(e_a, width_a, dev), *_steps(e_b, width_b, dev)])
    c = torch.empty((R_, C_), dtype=torch.float32, device=dev)
    if R_ == 0 or C_ == 0:
        return c
    fn = build.library("qmatmul").qmatmul_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(steps.data_ptr()), ctypes.c_void_p(c.data_ptr()),
            R_, C_, D_, _KIND[kind], int(width_a or 0), int(width_b or 0),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"qmm kernel launch failed: CUDA error {rc}")
    LAUNCHES[f"qmm_{kind}"] += 1
    return c
