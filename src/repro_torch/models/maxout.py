"""Paper-faithful maxout networks (paper §2, §8; Goodfellow et al. 2013a) —
``repro.models.maxout``.

Two model shapes, as in the paper:
  * permutation-invariant MLP — maxout hidden layers on flat inputs (the
    paper's PI-MNIST model: 2 maxout layers + softmax);
  * convolutional maxout — conv layers whose channels are maxed over k
    pieces, with spatial max pooling, + a dense softmax.

Every weighted sum and output is a DFXP quantization site — exactly the
paper's per-layer groups.  The max-norm constraint on weight columns is
applied in the optimizer (:func:`repro_torch.optim.apply_max_norm`).

Layouts are the reference's: dense weights ``[d_in, pieces*h]``, conv
weights OIHW with ``O = pieces*channels``, activations NCHW; a maxout
unit's pieces are the *leading* split (``(B, pieces, h)``, max over axis
1).  Dropout draws from ``jax.random`` in the reference and waits for the
PRNG port (ROADMAP item 14): a dropout rate with a generator given raises
rather than training without it; ``rng=None`` is the reference's own
dropout-off path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.tape import QTape

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MaxoutConfig:
    name: str = "maxout_pi"
    input_dim: int = 784             # flat input (PI) or C*H*W (conv)
    image_shape: Tuple[int, int, int] = (1, 28, 28)   # (C, H, W), conv only
    num_classes: int = 10
    hidden: Tuple[int, ...] = (240, 240)
    pieces: int = 5                  # k linear pieces per maxout unit
    conv: bool = False
    conv_channels: Tuple[int, ...] = (48, 48, 24)
    conv_kernel: int = 5
    pool: int = 2
    dropout_input: float = 0.2
    dropout_hidden: float = 0.5
    max_col_norm: float = 1.9365     # pylearn2 default used by the paper


def _normal(gen: torch.Generator, shape, fan_in: int, device) -> Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w / math.sqrt(fan_in)).to(device)


def init_params(cfg: MaxoutConfig, generator, device="cuda") -> dict:
    """Random weights (normal / sqrt(fan_in), zero biases), drawn on the
    CPU from ``generator`` (a ``torch.Generator`` or an int seed) and
    moved to ``device``, so every device starts from the same numbers."""
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(generator))
    params = {}
    if cfg.conv:
        C = cfg.image_shape[0]
        k = cfg.conv_kernel
        for i, ch in enumerate(cfg.conv_channels):
            fan_in = C * k ** 2
            params[f"conv{i}"] = {
                "w": _normal(gen, (cfg.pieces * ch, C, k, k), fan_in, device),
                "b": torch.zeros((cfg.pieces * ch,), device=device),
            }
            C = ch
        feat = conv_out_dim(cfg)
        params["out"] = {
            "w": _normal(gen, (feat, cfg.num_classes), feat, device),
            "b": torch.zeros((cfg.num_classes,), device=device),
        }
    else:
        d = cfg.input_dim
        for i, h in enumerate(cfg.hidden):
            params[f"fc{i}"] = {
                "w": _normal(gen, (d, cfg.pieces * h), d, device),
                "b": torch.zeros((cfg.pieces * h,), device=device),
            }
            d = h
        params["out"] = {
            "w": _normal(gen, (d, cfg.num_classes), d, device),
            "b": torch.zeros((cfg.num_classes,), device=device),
        }
    return params


def conv_out_dim(cfg: MaxoutConfig) -> int:
    _, H, W = cfg.image_shape
    for _ in cfg.conv_channels:
        H, W = H // cfg.pool, W // cfg.pool
    return cfg.conv_channels[-1] * H * W


def group_shapes(cfg: MaxoutConfig) -> dict:
    groups = {}
    names = ([f"conv{i}" for i in range(len(cfg.conv_channels))]
             if cfg.conv else [f"fc{i}" for i in range(len(cfg.hidden))])
    for n in names + ["out"]:
        groups[f"w:{n}/w"] = ()
        for s in ("pre", "act"):
            groups[f"a:{n}/{s}"] = ()
            groups[f"g:{n}/{s}"] = ()
    return groups


def _check_dropout(cfg: MaxoutConfig, rng) -> None:
    if rng is not None and (cfg.dropout_input or cfg.dropout_hidden):
        raise NotImplementedError(
            "dropout draws from jax.random in the reference and needs the "
            "threefry PRNG port (ROADMAP module item 14); pass rng=None to "
            "train without dropout, as the reference's rng=None path does")


def _conv_same(x: Tensor, w: Tensor) -> Tensor:
    """Stride-1 ``SAME`` convolution, NCHW x OIHW (XLA's SAME padding:
    the extra row/column of an even kernel goes to the high side)."""
    k = w.shape[-1]
    lo, hi = (k - 1) // 2, k // 2
    if lo == hi:
        return F.conv2d(x, w, padding=lo)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w)


def forward(cfg: MaxoutConfig, policy: PrecisionPolicy, params, x: Tensor,
            scales, sinks, *, rng: Optional[torch.Generator] = None):
    """``x``: [B, input_dim] (PI) or [B, C, H, W] (conv).  Returns
    ``(logits [B, num_classes], forward stats)``."""
    _check_dropout(cfg, rng)
    tape = QTape(policy, scales, sinks)
    if cfg.conv:
        for i, ch in enumerate(cfg.conv_channels):
            p = params[f"conv{i}"]
            w = tape.weight(f"conv{i}/w", p["w"])
            z = _conv_same(x, w) + p["b"][None, :, None, None]
            z = tape.act(f"conv{i}/pre", z)
            B, _, H, W = z.shape
            z = z.reshape(B, cfg.pieces, ch, H, W).amax(dim=1)   # maxout
            z = F.max_pool2d(z, cfg.pool)
            z = tape.act(f"conv{i}/act", z)
            x = z
        x = x.reshape(x.shape[0], -1)
    else:
        for i, h in enumerate(cfg.hidden):
            p = params[f"fc{i}"]
            z = tape.dot(f"fc{i}/w", x, p["w"]) + p["b"]
            z = tape.act(f"fc{i}/pre", z)
            z = z.reshape(z.shape[0], cfg.pieces, h).amax(dim=1)  # maxout
            z = tape.act(f"fc{i}/act", z)
            x = z
    p = params["out"]
    logits = tape.dot("out/w", x, p["w"]) + p["b"]
    logits = tape.act("out/pre", logits)
    return logits, tape.stats


def loss_fn(cfg, policy, params, batch, scales, sinks, rng=None):
    """Mean negative log-likelihood (``log_softmax`` in f32)."""
    logits, stats = forward(cfg, policy, params, batch["x"], scales, sinks,
                            rng=rng)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, 1, batch["y"].long()[:, None])[:, 0]
    return -ll.mean(), stats


def accuracy(cfg, policy, params, batch, scales, sinks) -> Tensor:
    with torch.no_grad():
        logits, _ = forward(cfg, policy, params, batch["x"], scales, sinks)
        return (torch.argmax(logits, -1) == batch["y"].long()).to(
            torch.float32).mean()
