"""Dynamic fixed point scale state + the paper's overflow-rate controller (§5).

Each tensor *group* owns one power-of-two scaling factor, stored as a
float32 log2-step ``e`` (integer-valued); groups of a stacked layer stage
are ``[L]`` vectors.

Controller rule (paper §5):
  * accumulate ``(n_overflow, n_overflow_half, n_total)`` per group;
  * where ``apply`` holds:
      - if ``overflow_rate > max_overflow_rate``        → scale ×2 (``e+1``)
      - elif ``overflow_rate_at_half <= max_overflow``  → scale ÷2 (``e-1``)
  * reset the applied accumulators.

The update is branch-free (``torch.where``), so a per-slot ``apply``
vector needs no host round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .quant import log2

Tensor = torch.Tensor

E_MIN, E_MAX = -40.0, 40.0


@dataclasses.dataclass
class ScaleState:
    """Per-group log2 steps + accumulated overflow statistics."""

    exps: Dict[str, Tensor]   # group -> f32 (integer-valued), shape [] or [L]
    acc: Dict[str, Tensor]    # group -> f32 stats, shape exps.shape + (3,)

    @staticmethod
    def create(group_shapes: Dict[str, tuple], init_exp=-8.0, *,
               device="cpu") -> "ScaleState":
        """``group_shapes``: group -> () or (L,). ``init_exp``: scalar, or a
        per-group dict of scalars/arrays (e.g. from calibration)."""
        exps, acc = {}, {}
        for name, shape in group_shapes.items():
            e0 = init_exp[name] if isinstance(init_exp, dict) else init_exp
            e0 = torch.as_tensor(e0, dtype=torch.float32, device=device)
            exps[name] = torch.broadcast_to(e0, shape).clone()
            acc[name] = torch.zeros(shape + (3,), dtype=torch.float32,
                                    device=device)
        return ScaleState(exps=exps, acc=acc)


def accumulate(state: ScaleState, stats: Dict[str, Tensor]) -> ScaleState:
    """Add this step's statistics. Missing groups are left untouched."""
    acc = dict(state.acc)
    for name, s in stats.items():
        if name in acc:
            acc[name] = acc[name] + s.to(torch.float32)
    return ScaleState(exps=state.exps, acc=acc)


def controller_step(state: ScaleState, *, max_overflow_rate: float,
                    apply) -> ScaleState:
    """Apply the paper's rule where ``apply`` is true; reset acc there.

    ``apply`` is a bool scalar (the training cadence) or a tensor
    broadcastable to each group's exponent shape (e.g. per-slot ``[B]``
    for the serve-time KV-cache groups).
    """
    new_exps, new_acc = {}, {}
    for name, e in state.exps.items():
        a = state.acc[name]
        app = torch.as_tensor(apply, device=e.device)
        # acc carries a trailing stats axis the exponents don't have
        app_acc = app if app.ndim == 0 else app[..., None]
        total = torch.clamp(a[..., 2], min=1.0)
        rate = a[..., 0] / total
        rate_half = a[..., 1] / total
        up = rate > max_overflow_rate
        down = (~up) & (rate_half <= max_overflow_rate)
        delta = up.to(torch.float32) - down.to(torch.float32)
        # Groups that saw no data keep their scale.
        delta = torch.where(a[..., 2] > 0, delta, torch.zeros_like(delta))
        e_new = torch.clamp(e + delta, E_MIN, E_MAX)
        new_exps[name] = torch.where(app, e_new, e)
        new_acc[name] = torch.where(app_acc, torch.zeros_like(a), a)
    return ScaleState(exps=new_exps, acc=new_acc)


def calibrate_exp(maxabs: Tensor, width: int, margin_bits: int = 1) -> Tensor:
    """log2-step so that ``maxabs`` fits with ``margin_bits`` of headroom."""
    qmax = float(2 ** (width - 1) - 1)
    maxabs = torch.as_tensor(maxabs, dtype=torch.float32)
    need = torch.ceil(log2(torch.clamp(maxabs, min=1e-20) / qmax))
    return torch.clamp(need + margin_bits, E_MIN, E_MAX).to(torch.float32)
