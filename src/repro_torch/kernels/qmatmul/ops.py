"""Wrapper of the hand-written quantized matmul kernel K2.

``qmm(a, b, e_a, e_b, kind=, width_a=, width_b=)`` keeps the signature of
``repro.kernels.qmatmul.ops.qmm`` minus the TPU's ``blocks``, ``cast``,
``out_dtype`` and ``interpret``: the CUDA kernel's tiles and split of the
reduction come from :func:`plan`, it computes to float32 accuracy and has
no interpret mode.  Layouts ``nn`` (forward), ``nt`` (dgrad) and ``tn``
(wgrad) as in ``qmatmul_kernel.py:27-35``; each operand has its own
optional width (``None`` = raw).  For tensors on the CPU it computes the plain version in
:mod:`.ref`; for tensors on the card it checks them, launches K2 on the
current stream and raises if either of its launches fails.  There is no
fallback from one to the other.

Arithmetic on the card: TF32 tensor cores with float32 accumulation.  An
operand rounded at a width of at most 12 bits is exact in TF32
(``ref.EXACT_WIDTH``); any other operand (raw, or a width of 13..32) goes
as the sum of two TF32 parts, ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(kept times 2^12, clear of f32's subnormals), and the product as
``hi·hi`` plus the cross terms (:func:`products` of them).
Each product term is then within about 2^-22 of its float32 value
relative to ``|a·b|``, far inside :func:`.cases.tolerance`; a product of
two exact operands is exact (:mod:`.ref` emulates all of this).

``LAUNCHES`` counts calls per layout, incremented where a call launches
its kernel (and, after a split of the reduction, the kernel that sums the
splits) and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.quant import exact_pow2

from .. import build
from . import ref as R

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"qmm_nn": 0, "qmm_nt": 0, "qmm_tn": 0}
_KIND = {"nn": 0, "nt": 1, "tn": 2}

SMS = 132            # streaming multiprocessors of an H100 SXM
BM, BK = 64, 32      # output-tile rows; depth of one reduction slice
MIN_PER = 2          # slices of the shallowest split


def plan(R: int, C: int, D: int) -> Tuple[int, int, int]:
    """``(bn, splits, per)`` of a product ``[R, D] x [D, C]``: output tiles
    of 64 x ``bn``, and the reduction cut into ``splits`` contiguous ranges
    of ``per`` 32-deep slices (the last range may be shorter).  A product
    with a wave of 64 x 64 tiles (:data:`SMS` of them) is not split.  A
    skinny one takes 64 x 32 tiles and as many splits as bring the blocks
    to about two waves, each split at least :data:`MIN_PER` slices deep:
    a block of four warps hides little latency on its own, and every split
    adds a partial tile for the reduction to read (the H100 sweep behind
    this rule is in PERF.md)."""
    n_slices = max(1, -(-D // BK))
    rows = -(-R // BM)
    if rows * -(-C // 64) >= SMS:
        return 64, 1, n_slices
    want = -(-2 * SMS // (rows * -(-C // 32)))
    per = max(MIN_PER, n_slices // want)
    return 32, -(-n_slices // per), per


def products(width_a: Optional[int], width_b: Optional[int]) -> int:
    """TF32 products per multiply-add: ``hi·hi``, plus ``lo·hi`` when A is
    split and ``hi·lo`` when B is."""
    return 1 + R.is_split(width_a) + R.is_split(width_b)


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
    numerics are :func:`repro_torch.kernels.qmatmul.ref.qmatmul_ref` to
    :func:`.cases.tolerance` (bit for bit where both operands are rounded
    at widths <= 12 and the sums are exact), the same bits from run to
    run."""
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
        if w is not None and not 2 <= w <= 32:
            raise ValueError(f"qmm takes widths in [2, 32] or None, got {w}")
    dev = a.device
    steps = torch.stack([*_steps(e_a, width_a, dev), *_steps(e_b, width_b, dev)])
    c = torch.empty((R_, C_), dtype=torch.float32, device=dev)
    if R_ == 0 or C_ == 0:
        return c
    bn, splits, per = plan(R_, C_, D_)
    ws = torch.empty((splits, R_, C_), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    fn = build.library("qmatmul").qmatmul_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(steps.data_ptr()), ctypes.c_void_p(c.data_ptr()),
            ctypes.c_void_p(None if ws is None else ws.data_ptr()),
            R_, C_, D_, _KIND[kind], int(width_a or 0), int(width_b or 0),
            bn, splits, per, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"qmm kernel launch failed (plan bn={bn}, "
                           f"splits={splits}): CUDA error {rc}")
    LAUNCHES[f"qmm_{kind}"] += 1
    return c
