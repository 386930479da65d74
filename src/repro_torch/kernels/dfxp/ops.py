"""Wrapper of the hand-written fused quantize kernel K1.

``dfxp_quantize(x, e, width=)`` keeps the signature of
``repro.kernels.dfxp.ops.dfxp_quantize`` (minus ``interpret``: the CUDA
kernel has no interpret mode).  It takes any shape in float32, float16
or bfloat16.  For a tensor on the CPU it computes the plain version in
:mod:`.ref`; for a tensor on the card it launches K1 on the current
stream over the flat tensor — the ragged tail is masked by index, there
is no padding copy — and raises if the launch fails.  There is no
fallback from one to the other.  A call on the card puts one operation
on the stream, K1 itself: the kernel builds the step from the exponent
(a scalar tensor on the card, read there, or a number, passed by value)
and writes the f32 counts; the two 64-bit words in which the blocks
add their counts live in a scratch kept per stream.

``LAUNCHES`` counts kernel launches, incremented where the kernel
launches and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import build
from . import ref as R

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"dfxp_quantize": 0}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# (device, stream) -> int64 [2]: the words in which K1's blocks add their
# counts (0 between calls)
_SCRATCH: Dict[Tuple[int, int], Tensor] = {}


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
    e_dev, e_val = _exponent(e, x.device)
    if not x.is_contiguous():
        raise ValueError("dfxp_quantize needs a contiguous tensor")
    y = torch.empty_like(x)
    stats = torch.empty(2, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, stats.zero_()
    stream = torch.cuda.current_stream(x.device)
    fn = build.library("dfxp_quantize").dfxp_quantize_launch
    rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(None if e_dev is None else e_dev.data_ptr()),
            e_val,
            ctypes.c_void_p(_scratch(x.device, stream).data_ptr()),
            ctypes.c_void_p(stats.data_ptr()), x.numel(),
            _DTYPE_CODE[x.dtype], int(width),
            ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"dfxp_quantize kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["dfxp_quantize"] += 1
    return y, stats


def _exponent(e, device):
    """``(tensor, value)`` of the scalar exponent for the kernel: a tensor
    on ``device``, as float32, read there (no copy to or from the host);
    anything else — a number, a CPU scalar tensor — by value."""
    if isinstance(e, torch.Tensor):
        if e.ndim != 0:
            raise ValueError("dfxp_quantize takes one scalar exponent")
        if e.device == device:
            return e.to(torch.float32), 0.0
        if e.device.type != "cpu":
            raise ValueError(f"the exponent is on {e.device}, x on {device}")
    return None, float(e)


def _scratch(device, stream) -> Tensor:
    """The count words of K1 calls on ``stream``: zeroed once and left at
    0 by every call, so calls on one stream (which run one after another)
    can share them and calls on two streams never do."""
    key = (device.index, stream.cuda_stream)
    t = _SCRATCH.get(key)
    if t is None:
        t = torch.zeros(2, dtype=torch.int64, device=device)
        _SCRATCH[key] = t
    return t
