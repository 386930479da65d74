"""Dynamic fixed point as the paper defines it, for the plain references.

A value is held as ``k * 2**e`` with ``k`` a ``width``-bit two's-complement
integer, rounded half to even and clipped.  One exponent per group (per
layer for a stacked group).  Calibration (paper §9.3) trains a few steps
in float32, takes each group's largest magnitude and gives it one bit of
headroom: ``e = ceil(log2(max / qmax)) + 1``.

This module is the benchmark's own: it imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch

E_MIN, E_MAX = -40.0, 40.0


def pow2(e, device) -> torch.Tensor:
    """``2**e`` exactly, for integer-valued ``e``."""
    e = torch.as_tensor(e, dtype=torch.float32, device=device)
    return torch.ldexp(torch.ones_like(e), e.to(torch.int32))


def rnd(x: torch.Tensor, width: int, e) -> torch.Tensor:
    """``x`` on the ``width``-bit grid of step ``2**e`` (``e`` broadcasts
    against ``x``'s leading axes when it is a vector)."""
    step = pow2(e, x.device)
    if step.ndim:
        step = step.reshape(step.shape + (1,) * (x.ndim - step.ndim))
    hi = float(2 ** (width - 1) - 1)
    lo = -float(2 ** (width - 1))
    return torch.round(x.to(torch.float32) / step).clamp_(lo, hi).mul_(step)


def calibrated_exp(maxabs: torch.Tensor, width: int) -> torch.Tensor:
    """The exponent that holds ``maxabs`` with one bit of headroom."""
    qmax = float(2 ** (width - 1) - 1)
    m = torch.clamp(maxabs.to(torch.float32), min=1e-20) / qmax
    ln2 = torch.log(torch.tensor(2.0, dtype=torch.float32, device=m.device))
    need = torch.ceil(torch.log(m) / ln2)
    return torch.clamp(need + 1.0, E_MIN, E_MAX)


class _Site(torch.autograd.Function):
    """Forward value and backward cotangent each rounded on their grid."""

    @staticmethod
    def forward(ctx, x, width, e_fwd, e_bwd):
        ctx.width, ctx.e_bwd = width, e_bwd
        return rnd(x, width, e_fwd)

    @staticmethod
    def backward(ctx, g):
        return rnd(g, ctx.width, ctx.e_bwd), None, None, None


class _Straight(torch.autograd.Function):
    """Forward rounded, gradient passed straight through."""

    @staticmethod
    def forward(ctx, w, width, e):
        return rnd(w, width, e)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Watch(torch.autograd.Function):
    """Identity that records the largest magnitude of the value under
    ``fwd`` and of its cotangent under ``bwd``."""

    @staticmethod
    def forward(ctx, x, book, fwd, bwd):
        ctx.book, ctx.bwd = book, bwd
        book.see(fwd, x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.book.see(ctx.bwd, g)
        return g, None, None, None


class MaxBook:
    """Largest magnitude seen per (group, layer)."""

    def __init__(self):
        self.max: Dict[tuple, torch.Tensor] = {}

    def see(self, key: tuple, x: torch.Tensor) -> None:
        m = x.detach().to(torch.float32).abs().max()
        self.max[key] = torch.maximum(self.max[key], m) if key in self.max \
            else m


class Arith:
    """Where a model's plain forward rounds: ``site`` (an activation and
    its cotangent) and ``weight`` (a parameter entering a product).

    ``mode="observe"`` rounds nothing and books maxima (calibration);
    ``"dfxp"`` rounds at ``width`` with the exponents ``exps`` (group →
    scalar or per-layer vector); ``"float32"`` does neither."""

    def __init__(self, mode: str, width: int = 10, exps=None, book=None,
                 state_width: int = 12):
        self.mode, self.width, self.exps = mode, width, exps or {}
        self.state_width = state_width
        self.book = book

    def _e(self, group: str, layer):
        e = self.exps[group]
        return e if layer is None else e[layer]

    def site(self, x, name: str, layer=None):
        if self.mode == "float32":
            return x
        if self.mode == "observe":
            if not x.requires_grad:
                self.book.see((f"a:{name}", layer), x)
                return x
            return _Watch.apply(x, self.book, (f"a:{name}", layer),
                                (f"g:{name}", layer))
        ea = self._e(f"a:{name}", layer)
        if not x.requires_grad:
            return rnd(x, self.width, ea)
        return _Site.apply(x, self.width, ea, self._e(f"g:{name}", layer))

    def state(self, x, name: str, layer=None):
        """A recurrent state, rounded at the update width."""
        if self.mode != "dfxp":
            return x
        return rnd(x, self.state_width, self._e(f"a:{name}", layer))

    def weight(self, w, name: str, layer=None):
        if self.mode == "float32":
            return w
        if self.mode == "observe":
            self.book.see((f"w:{name}", layer), w)
            return w
        e = self._e(f"w:{name}", layer)
        if not w.requires_grad:
            return rnd(w, self.width, e)
        return _Straight.apply(w, self.width, e)


def stacked_exps(book: MaxBook, width_of, layers: Dict[str, int]):
    """Calibrated exponents from booked maxima: a ``[L]`` vector for a
    group booked per layer, a scalar otherwise.  ``width_of(group)`` is
    the group's width; ``layers`` the layer count of each stacked group."""
    by: Dict[str, dict] = {}
    for (group, layer), m in book.max.items():
        by.setdefault(group, {})[layer] = m
    out = {}
    for group, per in by.items():
        if None in per:
            out[group] = calibrated_exp(per[None], width_of(group))
        else:
            L = layers[group]
            v = torch.stack([per[i] for i in range(L)])
            out[group] = calibrated_exp(v, width_of(group))
    return out
