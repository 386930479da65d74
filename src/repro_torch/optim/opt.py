"""Optimizers, faithful to the paper's recipe (§8.1), + AdamW — ``repro.optim.opt``.

Paper recipe: minibatch SGD with a *linearly decaying learning rate*, a
*linearly saturating momentum*, dropout, and a max-norm constraint on
each weight column (Srebro & Shraibman 2005).  Pure functions over
(nested) dicts of tensors; nothing is updated in place.  The schedules
take the step as an int32 tensor and compute in float32, as the
reference does.  Where the reference's jitted step computes ``a * b + c``
XLA fuses it into one rounding (a fused multiply-add); :func:`fma` does
the same here, so the two packages' updates agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "sgd"              # sgd|adamw
    lr: float = 0.05
    # paper schedules
    lr_decay_steps: int = 10_000   # linear decay horizon
    lr_min_factor: float = 0.01
    momentum_init: float = 0.5
    momentum_final: float = 0.7
    momentum_sat_steps: int = 2_000
    # adamw
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    # constraints
    max_col_norm: float = 0.0      # 0 = off (paper maxout: 1.9365)
    grad_clip: float = 0.0         # global-norm clip, 0 = off


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``jax.tree.map`` for dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _f32(step) -> Tensor:
    return torch.as_tensor(step).to(torch.float32)


def fma(a, b, c) -> Tensor:
    """``a * b + c`` in float32 with one rounding, as XLA compiles the
    reference's jitted multiply-adds (a fused multiply-add).  The product
    of two float32 values is exact in float64, so the only roundings are
    the float64 sum's and the final one to float32 (which agree with a
    true FMA except at a vanishingly rare double-rounding tie)."""
    a, b, c = (torch.as_tensor(t) for t in (a, b, c))
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def lr_at(cfg: OptConfig, step) -> Tensor:
    frac = 1.0 - _f32(step) / cfg.lr_decay_steps
    return cfg.lr * torch.clamp(frac, cfg.lr_min_factor, 1.0)


def momentum_at(cfg: OptConfig, step) -> Tensor:
    t = torch.clamp(_f32(step) / cfg.momentum_sat_steps, 0.0, 1.0)
    slope = torch.tensor(cfg.momentum_final - cfg.momentum_init,
                         dtype=torch.float32, device=t.device)
    return fma(slope, t, torch.tensor(cfg.momentum_init, dtype=torch.float32,
                                      device=t.device))


SGDState = Dict[str, Any]     # {"momentum": tree}
AdamWState = Dict[str, Any]   # {"m": tree, "v": tree}


def sgd_init(params) -> SGDState:
    return {"momentum": tree_map(torch.zeros_like, params)}


def sgd_update(cfg: OptConfig, grads, state: SGDState, step):
    """Returns (updates, new_state); updates are *deltas* to add to params,
    exact in float64 (``-lr * m`` of two float32 values), so that adding
    one to a parameter rounds once, as the reference's fused step does."""
    lr = lr_at(cfg, step)
    mom = momentum_at(cfg, step)
    new_m = tree_map(lambda m, g: fma(mom, m, g), state["momentum"], grads)
    # -lr * m is exact in float64: adding it to a parameter in float64 and
    # rounding once is the reference's fused p + (-lr * m)
    updates = tree_map(lambda m: -lr.to(torch.float64) * m.to(torch.float64),
                       new_m)
    return updates, {"momentum": new_m}


def adamw_init(params) -> AdamWState:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


def adamw_update(cfg: OptConfig, grads, state: AdamWState, step,
                 params=None):
    lr = lr_at(cfg, step)
    t = _f32(step) + 1.0
    b1, b2 = cfg.beta1, cfg.beta2
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(mi, vi, pi=None):
        u = -(lr * (mi / c1) / (torch.sqrt(vi / c2) + cfg.eps))
        if cfg.weight_decay and pi is not None:
            u = u - lr * cfg.weight_decay * pi
        return u

    if params is None:
        updates = tree_map(upd, m, v)
    else:
        updates = tree_map(upd, m, v, params)
    return updates, {"m": m, "v": v}


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale, tree), n


def apply_max_norm(params, max_col_norm: float):
    """Paper's max-norm constraint: clip each weight column's L2 norm.

    Applied to every rank-2+ leaf, over all axes but the last, as the
    reference does (``opt.py:102-119``).  On a dense ``[d_in, d_out]``
    weight that is each output column; on a conv OIHW weight it is each
    kernel column ``[:, :, :, w]``, not each output channel — the
    reference's behaviour, mirrored here (ROADMAP, found against the
    reference).
    """
    if not max_col_norm:
        return params

    def clip(x):
        if x.ndim < 2:
            return x
        axes = tuple(range(x.ndim - 1))
        norms = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True))
        scale = torch.clamp(max_col_norm / torch.clamp(norms, min=1e-9),
                            max=1.0)
        return x * scale

    return tree_map(clip, params)
