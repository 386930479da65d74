"""Wrapper of the hand-written fused quantize kernel K1.

``dfxp_quantize(x, e, width=)`` keeps the signature of
``repro.kernels.dfxp.ops.dfxp_quantize`` (minus ``interpret``: the CUDA
kernel has no interpret mode).  It takes any shape in float32, float16
or bfloat16.  For a tensor on the CPU it computes the plain version in
:mod:`.ref`; for a tensor on the card it launches K1 on the current
stream over the flat tensor — the ragged tail is masked by index, there
is no padding copy — and raises if the launch fails.  There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches, incremented where the kernel
launches and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.quant import exact_pow2

from .. import build
from . import ref as R

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"dfxp_quantize": 0}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dfxp_quantize(x: Tensor, e, *, width: int):
    """Fused quantize + overflow counts — K1.  Returns ``(y, stats[2])``:
    ``y`` like ``x``, ``stats`` = float32 (n_overflow, n_overflow_half);
    numerics are :func:`repro_torch.kernels.dfxp.ref.dfxp_quantize_ref`."""
    if x.device.type == "cpu":
        return R.dfxp_quantize_ref(x, e, width=width)
    if x.device.type != "cuda":
        raise ValueError(f"dfxp_quantize runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dfxp_quantize takes float32/float16/bfloat16, not "
                        f"{x.dtype}")
    if not 2 <= width <= 32:
        raise ValueError(f"width must be in [2, 32], got {width}")
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    if e.ndim != 0:
        raise ValueError("dfxp_quantize takes one scalar exponent")
    if not x.is_contiguous():
        raise ValueError("dfxp_quantize needs a contiguous tensor")
    steps = torch.stack([exact_pow2(e), exact_pow2(-e)])
    y = torch.empty_like(x)
    counts = torch.zeros(2, dtype=torch.int64, device=x.device)
    if x.numel() == 0:
        return y, counts.to(torch.float32)
    fn = build.library("dfxp_quantize").dfxp_quantize_launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(steps.data_ptr()),
            ctypes.c_void_p(counts.data_ptr()), x.numel(), _DTYPE_CODE[x.dtype],
            int(width), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"dfxp_quantize kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["dfxp_quantize"] += 1
    return y, counts.to(torch.float32)
