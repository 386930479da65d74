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
1).  Randomness is the reference's, drawn from threefry keys
(:mod:`repro_torch.core.prng`): :func:`init_params` draws the same
normals from the same key, and dropout (input, then each hidden layer,
keys split off ``rng`` in the reference's order) the same masks;
``rng=None`` is the dropout-off path, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import prng
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


def _normal(key: Tensor, shape, fan_in: int) -> Tensor:
    return prng.normal(key, shape) / math.sqrt(fan_in)


def init_params(cfg: MaxoutConfig, key, device="cuda") -> dict:
    """The reference's initial weights: threefry normals / sqrt(fan_in),
    zero biases, one key split off ``key`` per layer in the reference's
    order.  ``key`` is a threefry key or an int seed (``PRNGKey(seed)``);
    the numbers are drawn on ``device`` and are the same on every
    device."""
    key = prng.as_key(key, resolve_device(device))
    device = key.device
    params = {}

    def layer(key, shape, fan_in):
        key, k = prng.split(key)
        return key, _normal(k, shape, fan_in)

    if cfg.conv:
        C = cfg.image_shape[0]
        k = cfg.conv_kernel
        for i, ch in enumerate(cfg.conv_channels):
            key, w = layer(key, (cfg.pieces * ch, C, k, k), C * k ** 2)
            params[f"conv{i}"] = {
                "w": w,
                "b": torch.zeros((cfg.pieces * ch,), device=device),
            }
            C = ch
        feat = conv_out_dim(cfg)
        key, w = layer(key, (feat, cfg.num_classes), feat)
    else:
        d = cfg.input_dim
        for i, h in enumerate(cfg.hidden):
            key, w = layer(key, (d, cfg.pieces * h), d)
            params[f"fc{i}"] = {
                "w": w,
                "b": torch.zeros((cfg.pieces * h,), device=device),
            }
            d = h
        key, w = layer(key, (d, cfg.num_classes), d)
    params["out"] = {"w": w,
                     "b": torch.zeros((cfg.num_classes,), device=device)}
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


def _dropout(x: Tensor, rate: float, key: Tensor) -> Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` (threefry
    ``bernoulli``), kept values times ``1 / (1 - rate)`` — the reference's
    ``x / (1 - rate)`` as its compiled step computes it, a product with
    the float32 reciprocal."""
    if rate == 0.0:
        return x
    keep = prng.bernoulli(key, 1.0 - rate, tuple(x.shape))
    inv = float(np.float32(1.0) / np.float32(1.0 - rate))
    return torch.where(keep, x * inv, 0.0)


def _conv_same(x: Tensor, w: Tensor) -> Tensor:
    """Stride-1 ``SAME`` convolution, NCHW x OIHW (XLA's SAME padding:
    the extra row/column of an even kernel goes to the high side)."""
    k = w.shape[-1]
    lo, hi = (k - 1) // 2, k // 2
    if lo == hi:
        return F.conv2d(x, w, padding=lo)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w)


def forward(cfg: MaxoutConfig, policy: PrecisionPolicy, params, x: Tensor,
            scales, sinks, *, rng: Optional[Tensor] = None):
    """``x``: [B, input_dim] (PI) or [B, C, H, W] (conv).  ``rng``: a
    threefry key for dropout, ``None`` for none (eval).  Returns
    ``(logits [B, num_classes], forward stats)``."""
    tape = QTape(policy, scales, sinks)
    if rng is not None:
        if isinstance(rng, torch.Generator):
            raise TypeError("dropout draws from a threefry key "
                            "(repro_torch.core.prng), not a torch.Generator")
        rng, k = prng.split(prng.as_key(rng, x.device))
        x = _dropout(x, cfg.dropout_input, k)
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
            if rng is not None:
                rng, k = prng.split(rng)
                z = _dropout(z, cfg.dropout_hidden, k)
            x = z
        x = x.reshape(x.shape[0], -1)
    else:
        for i, h in enumerate(cfg.hidden):
            p = params[f"fc{i}"]
            z = tape.dot(f"fc{i}/w", x, p["w"]) + p["b"]
            z = tape.act(f"fc{i}/pre", z)
            z = z.reshape(z.shape[0], cfg.pieces, h).amax(dim=1)  # maxout
            z = tape.act(f"fc{i}/act", z)
            if rng is not None:
                rng, k = prng.split(rng)
                z = _dropout(z, cfg.dropout_hidden, k)
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
