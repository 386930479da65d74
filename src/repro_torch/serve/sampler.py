"""Token sampling of the port: the numeric guard and greedy decoding.

The reference draws temperature/top-k tokens from per-request
``jax.random`` streams keyed ``(seed, uid, position)``; those need the
threefry PRNG port (ROADMAP module item 14), so here they raise and
greedy decoding is the one sampler.
"""
from __future__ import annotations

import dataclasses

import torch

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
        if self.kind != "greedy":
            raise NotImplementedError(
                f"the {self.kind!r} sampler draws from per-request threefry "
                f"streams; it waits for the PRNG port (ROADMAP module item "
                f"14)")


def guard_logits(logits: Tensor):
    """Device-side numeric sentinel: split non-finite rows out of a batch.

    Returns ``(safe_logits, bad)``: ``bad`` is a bool [B] flag, True for
    any row holding a NaN/Inf, and ``safe_logits`` has those rows zeroed
    so :func:`sample` stays well-defined.
    """
    bad = ~torch.all(torch.isfinite(logits), dim=-1)
    safe = torch.where(bad[..., None], 0.0, logits)
    return safe, bad


def sample(logits: Tensor, cfg: SamplerConfig) -> Tensor:
    """One token per row of ``logits`` [B, V]: the first maximum (greedy)."""
    if cfg.kind != "greedy":
        raise NotImplementedError("only greedy sampling is ported")
    return torch.argmax(logits, dim=-1).to(torch.int32)
