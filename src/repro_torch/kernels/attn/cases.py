"""Seeded inputs and cost model of the attention kernels at a given shape.

Shared by the card tests and ``chip_smoke.py``: each ``*_case`` returns
the keyword arguments of one wrapper of
:mod:`~repro_torch.kernels.attn.ops` (``flash_decode``,
``flash_prefill`` and their ``*_paged`` variants), drawn on ``device``
from ``seed``; each ``*_cost`` returns the bytes a call must move (each
input read once, the output written once) and the flops its unmasked
(query, key) pairs need, from which :func:`bound_ms` gives the least time
an H100 could take.  For the paged calls the K/V bytes are those of the
pages holding at least one visible row: what this call's data needs, not
the whole arena.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packed import container_dtype, qrange

from . import ref as R

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12      # TF32 on the tensor cores


def _storage(gen, shape, width: Optional[int], device):
    if width is None:
        return torch.randn(shape, generator=gen, device=device)
    qmax, qmin = qrange(width)
    return torch.randint(int(qmin), int(qmax) + 1, shape, generator=gen,
                         device=device).to(container_dtype(width))


def _exps(gen, n, width: Optional[int], device):
    """``n`` log2-steps (one per slot, or per page) that put the values at
    O(1..16), as calibration does."""
    if width is None:
        return None
    return torch.randint(1 - width, 4 - width, (n,), generator=gen,
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


def _paged_tables(gen, fills, mapped, P: int, nblocks: int, n_pages: int,
                  share: bool):
    """Block tables and positions of a paged case.

    Slot b maps ``ceil(mapped[b] / P)`` blocks to distinct pages drawn
    in a random, non-monotone order from ``1 .. n_pages - 1``, and the
    rest of its row to the null page 0; its logical rows ``r <
    fills[b]`` hold position ``r``, every other row -1.  With ``share``,
    slot 1's first block maps slot 0's first page (a shared prefix page).
    """
    B = len(fills)
    perm = (1 + torch.randperm(n_pages - 1, generator=gen)).tolist()
    bt = torch.zeros((B, nblocks), dtype=torch.int32)
    pos = torch.full((B, nblocks * P), -1, dtype=torch.int32)
    for b in range(B):
        nb = -(-mapped[b] // P)
        for j in range(nb):
            bt[b, j] = perm.pop()
        pos[b, :fills[b]] = torch.arange(fills[b], dtype=torch.int32)
    if share and B > 1 and min(fills[0], fills[1]) >= P:
        bt[1, 0] = bt[0, 0]
    return bt, pos


def decode_paged_case(B: int, P: int, nblocks: int, K: int, G: int, hd: int,
                      width: Optional[int], *, fill, n_pages=None,
                      window=None, share=True, seed=0,
                      device="cuda") -> dict:
    """``flash_decode_paged`` arguments: slot b has ``fill[b]`` tokens
    written through its block table and queries at ``fill[b] - 1``; the
    arena has ``n_pages`` pages (default ``1 + B * nblocks``), the null
    page all zero.  A slot with ``fill[b] == 0`` maps only the null page.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    fill = list(fill)
    n_pages = n_pages or 1 + B * nblocks
    bt, pos = _paged_tables(host, fill, fill, P, nblocks, n_pages, share)
    k = _storage(gen, (n_pages, P, K, hd), width, device)
    v = _storage(gen, (n_pages, P, K, hd), width, device)
    k[0] = 0
    v[0] = 0
    return dict(
        q=torch.randn((B, K, G, hd), generator=gen, device=device), k=k, v=v,
        bt=bt.to(device), pos=pos.to(device),
        q_pos=torch.tensor([max(n - 1, 0) for n in fill], dtype=torch.int32,
                           device=device),
        k_exp=_exps(gen, n_pages, width, device),
        v_exp=_exps(gen, n_pages, width, device),
        width=width, scale=hd ** -0.5, window=window)


def prefill_paged_case(B: int, C: int, P: int, nblocks: int, K: int, G: int,
                       hd: int, width: Optional[int], *, p0, n_valid,
                       n_pages=None, window=None, share=True, seed=0,
                       device="cuda") -> dict:
    """``flash_prefill_paged`` arguments for chunks at ``p0`` with
    ``n_valid`` rows: each slot's history holds its ``p0`` positions, and
    the blocks the chunk will write are mapped too (as the engine maps
    them before the chunk runs), their rows still empty."""
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    n_pages = n_pages or 1 + B * nblocks
    mapped = [a + n for a, n in zip(p0, n_valid)]
    bt, pos = _paged_tables(host, list(p0), mapped, P, nblocks, n_pages,
                            share)
    k = _storage(gen, (n_pages, P, K, hd), width, device)
    v = _storage(gen, (n_pages, P, K, hd), width, device)
    k[0] = 0
    v[0] = 0
    return dict(
        q=torch.randn((B, C, K, G, hd), generator=gen, device=device),
        k_new=torch.randn((B, C, K, hd), generator=gen, device=device),
        v_new=torch.randn((B, C, K, hd), generator=gen, device=device),
        k=k, v=v, bt=bt.to(device), pos=pos.to(device),
        p0=torch.tensor(p0, dtype=torch.int32, device=device),
        n_valid=torch.tensor(n_valid, dtype=torch.int32, device=device),
        k_exp=_exps(gen, n_pages, width, device),
        v_exp=_exps(gen, n_pages, width, device),
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


def prefill_products(width: Optional[int]):
    """TF32 products per multiply-add of K4's route, (history, self): q is
    split, so q·k takes 2 against int8 mantissas (exact in TF32) and 3
    against anything split; p·v the same against V."""
    return (2 if width is not None and width <= 8 else 3), 3


def _route(a: dict, cost):
    """(bytes, TF32 flops, rate) of one call on K4's and K6's tensor-core
    route, its bytes from ``cost``: each unmasked (query, key) pair's
    4·hd flops times the products its operands take
    (:func:`prefill_products`)."""
    B, C, K, G, hd = a["q"].shape
    vh, vs = prefill_valid(a)
    nbytes, _ = cost(a)
    ph, ps = prefill_products(a["width"])
    flops = 4 * hd * K * G * (ph * int(vh.sum()) + ps * int(vs.sum()))
    return nbytes, flops, H100_TF32_FLOPS


def _bounds(a: dict, cost) -> dict:
    nbytes, flops, rate = _route(a, cost)
    tc, tc_by = bound_ms(nbytes, flops, rate)
    f32, f32_by = bound_ms(*cost(a))
    return {"products": prefill_products(a["width"]), "route_flops": flops,
            "bound_ms": tc, "bound_by": tc_by, "f32_bound_ms": f32,
            "f32_bound_by": f32_by}


def prefill_route_cost(a: dict):
    """(bytes, TF32 flops, rate) of one ``flash_prefill`` call on K4's
    tensor-core route."""
    return _route(a, prefill_cost)


def prefill_bounds(a: dict) -> dict:
    """The route's bound and the float32 (SIMT) bound of one K4 call, ms,
    as :func:`repro_torch.kernels.qmatmul.cases.qmm_bounds` gives K2's."""
    return _bounds(a, prefill_cost)


def _visible_page_bytes(a: dict, seen) -> int:
    """K/V bytes (mantissas and per-page steps) of the distinct pages
    holding at least one visible row; ``seen``: bool [B, nblocks·P]."""
    B, nblocks = a["bt"].shape
    blk = seen.reshape(B, nblocks, -1).any(dim=-1)
    pages = torch.unique(a["bt"][blk])
    k = a["k"]
    per_page = k[0].numel() * k.element_size() * 2
    steps = 0 if a["width"] is None else 2 * 4
    return int(pages.numel()) * (per_page + steps)


def decode_paged_cost(a: dict):
    """(bytes, flops) of one ``flash_decode_paged`` call on these inputs."""
    B, K, G, hd = a["q"].shape
    valid = R.valid_mask(a["pos"], a["q_pos"], window=a["window"],
                         causal=True)
    nbytes = _visible_page_bytes(a, valid) \
        + _nbytes(a["q"], a["bt"], a["pos"], a["q_pos"]) + a["q"].numel() * 4
    flops = 4 * hd * K * G * int(valid.sum())
    return nbytes, flops


def prefill_paged_cost(a: dict):
    """(bytes, flops) of one ``flash_prefill_paged`` call on these inputs."""
    B, C, K, G, hd = a["q"].shape
    vh, vs = prefill_valid(a)
    nbytes = _visible_page_bytes(a, vh.any(dim=1)) \
        + _nbytes(a["q"], a["k_new"], a["v_new"], a["bt"], a["pos"],
                  a["p0"], a["n_valid"]) + a["q"].numel() * 4
    flops = 4 * hd * K * G * int(vh.sum() + vs.sum())
    return nbytes, flops


def prefill_paged_route_cost(a: dict):
    """(bytes, TF32 flops, rate) of one ``flash_prefill_paged`` call on
    K6's route, which is K4's over the visible pages."""
    return _route(a, prefill_paged_cost)


def prefill_paged_bounds(a: dict) -> dict:
    """The route's bound and the float32 (SIMT) bound of one K6 call, ms."""
    return _bounds(a, prefill_paged_cost)


def bound_ms(nbytes: int, flops: int, flops_per_s: float = H100_F32_FLOPS):
    """(least ms on an H100, "bytes" or "operations"), with the operations
    at ``flops_per_s`` (float32 outside the tensor cores by default)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
