"""Seeded inputs and cost model of the attention kernels at a given shape.

Shared by the card tests and ``chip_smoke.py``: each ``*_case`` returns
the keyword arguments of :func:`~repro_torch.kernels.attn.ops.flash_decode`
or :func:`~repro_torch.kernels.attn.ops.flash_prefill`, drawn on
``device`` from ``seed``; each ``*_cost`` returns the bytes a call must
move (each input read once, the output written once) and the flops its
unmasked (query, key) pairs need, from which :func:`bound_ms` gives the
least time an H100 could take.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packed import container_dtype, qrange

from . import ref as R

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores


def _storage(gen, shape, width: Optional[int], device):
    if width is None:
        return torch.randn(shape, generator=gen, device=device)
    qmax, qmin = qrange(width)
    return torch.randint(int(qmin), int(qmax) + 1, shape, generator=gen,
                         device=device).to(container_dtype(width))


def _exps(gen, B, width: Optional[int], device):
    if width is None:
        return None
    # steps that put the values at O(1..16), as calibration does
    return torch.randint(1 - width, 4 - width, (B,), generator=gen,
                         device=device).to(torch.float32)


def _ring(B: int, W: int, fill, device) -> torch.Tensor:
    """Ring positions: slot b holds the last ``min(fill[b], W)`` of the
    positions ``[0, fill[b])`` at ``p % W``; -1 elsewhere."""
    pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, n in enumerate(fill):
        p = torch.arange(max(0, n - W), n, dtype=torch.int32)
        pos[b, p % W] = p
    return pos.to(device)


def decode_case(B: int, W: int, K: int, G: int, hd: int,
                width: Optional[int], *, fill=None, window=None, seed=0,
                device="cuda") -> dict:
    """``flash_decode`` arguments; slot b has ``fill[b]`` tokens written
    (default: a full ring) and queries at position ``fill[b] - 1``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fill = list(fill) if fill is not None else [W] * B
    return dict(
        q=torch.randn((B, K, G, hd), generator=gen, device=device),
        k=_storage(gen, (B, W, K, hd), width, device),
        v=_storage(gen, (B, W, K, hd), width, device),
        pos=_ring(B, W, fill, device),
        q_pos=torch.tensor([max(n - 1, 0) for n in fill], dtype=torch.int32,
                           device=device),
        k_exp=_exps(gen, B, width, device), v_exp=_exps(gen, B, width, device),
        width=width, scale=hd ** -0.5, window=window)


def prefill_case(B: int, C: int, W: int, K: int, G: int, hd: int,
                 width: Optional[int], *, p0, n_valid, window=None, seed=0,
                 device="cuda") -> dict:
    """``flash_prefill`` arguments for chunks at ``p0`` with ``n_valid``
    rows; each slot's ring holds its ``p0`` prompt positions so far."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return dict(
        q=torch.randn((B, C, K, G, hd), generator=gen, device=device),
        k_new=torch.randn((B, C, K, hd), generator=gen, device=device),
        v_new=torch.randn((B, C, K, hd), generator=gen, device=device),
        k=_storage(gen, (B, W, K, hd), width, device),
        v=_storage(gen, (B, W, K, hd), width, device),
        pos=_ring(B, W, p0, device),
        p0=torch.tensor(p0, dtype=torch.int32, device=device),
        n_valid=torch.tensor(n_valid, dtype=torch.int32, device=device),
        k_exp=_exps(gen, B, width, device), v_exp=_exps(gen, B, width, device),
        width=width, scale=hd ** -0.5, window=window)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def decode_cost(a: dict):
    """(bytes, flops) of one ``flash_decode`` call on these inputs."""
    B, K, G, hd = a["q"].shape
    valid = R.valid_mask(a["pos"], a["q_pos"], window=a["window"],
                         causal=True)
    steps = 0 if a["width"] is None else 2 * B * 4
    nbytes = _nbytes(a["q"], a["k"], a["v"], a["pos"], a["q_pos"]) \
        + steps + a["q"].numel() * 4
    flops = 4 * hd * K * G * int(valid.sum())
    return nbytes, flops


def prefill_valid(a: dict):
    """([B, C, W] history, [B, C, C] self) validity masks of a case."""
    B, C = a["q"].shape[:2]
    p0, nv, pos = a["p0"], a["n_valid"], a["pos"]
    c = torch.arange(C, device=pos.device)
    row = c[None, :] < nv[:, None]
    d = (p0[:, None] + c[None, :])[:, :, None] - pos[:, None, :]
    vh = (pos[:, None, :] >= 0) & (pos[:, None, :] < p0[:, None, None]) \
        & row[:, :, None] & (d >= 0)
    dj = c[:, None] - c[None, :]
    vs = row[:, :, None] & row[:, None, :] & (dj >= 0)[None]
    if a["window"]:
        vh = vh & (d < a["window"])
        vs = vs & (dj < a["window"])[None]
    return vh, vs


def prefill_cost(a: dict):
    """(bytes, flops) of one ``flash_prefill`` call on these inputs."""
    B, C, K, G, hd = a["q"].shape
    vh, vs = prefill_valid(a)
    steps = 0 if a["width"] is None else 2 * B * 4
    nbytes = _nbytes(a["q"], a["k_new"], a["v_new"], a["k"], a["v"],
                     a["pos"], a["p0"], a["n_valid"]) + steps \
        + a["q"].numel() * 4
    flops = 4 * hd * K * G * int(vh.sum() + vs.sum())
    return nbytes, flops


def bound_ms(nbytes: int, flops: int):
    """(least ms on an H100, "bytes" or "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
