"""Token samplers with per-request PRNG streams — ``repro.serve.sampler``.

Each request owns an independent key chain derived from ``(engine seed,
request uid)``; the key for a sampled token is ``fold_in(request_key,
absolute_position)``.  A request therefore draws the same stream whether
it runs alone, batched, or admitted mid-decode into a freed slot.  Keys
and draws are the reference's threefry ones (:mod:`repro_torch.core.prng`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng

Tensor = torch.Tensor

KINDS = ("greedy", "temperature", "top_k")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "greedy"       # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown sampler {self.kind!r} (of {KINDS})")
        if self.kind == "top_k" and self.top_k <= 0:
            raise ValueError("top_k sampler needs top_k > 0")


def request_key(seed: int, uid: int, device=None) -> Tensor:
    """The root of one request's PRNG stream."""
    return prng.fold_in(prng.PRNGKey(seed, device), uid)


def position_keys(req_keys: Tensor, pos: Tensor) -> Tensor:
    """Per-request keys [B, 2] for the tokens generated at ``pos`` [B]."""
    return prng.fold_in(req_keys, pos)


def guard_logits(logits: Tensor):
    """Device-side numeric sentinel: split non-finite rows out of a batch.

    Returns ``(safe_logits, bad)``: ``bad`` is a bool [B] flag, True for
    any row holding a NaN/Inf, and ``safe_logits`` has those rows zeroed
    so :func:`sample` stays well-defined.
    """
    bad = ~torch.all(torch.isfinite(logits), dim=-1)
    safe = torch.where(bad[..., None], 0.0, logits)
    return safe, bad


def sample(logits: Tensor, keys: Optional[Tensor],
           cfg: SamplerConfig) -> Tensor:
    """One token per row of ``logits`` [B, V]; ``keys`` [B, 2] (unused,
    and may be ``None``, for greedy).  Greedy takes the first maximum;
    temperature and top-k draw ``categorical`` from the scaled logits,
    top-k with every logit below the k-th largest set to ``-1e30``.  The
    scaling is the reference's ``logits / temperature`` as its compiled
    step computes it: a product with the float32 reciprocal."""
    if cfg.kind == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    inv = float(np.float32(1.0) / np.float32(max(cfg.temperature, 1e-6)))
    scaled = logits.to(torch.float32) * inv
    if cfg.kind == "top_k":
        kth = torch.topk(scaled, cfg.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, -1e30, scaled)
    return prng.categorical(keys, scaled).to(torch.int32)
