"""Plain PyTorch versions of the flash-decode and flash-prefill kernels.

These are the numerics contract of :mod:`repro_torch.kernels.attn`, a
line-for-line port of ``repro.kernels.attn.ref``: single-query and
chunked GQA attention over a (possibly DFXP-packed) KV ring buffer, or
over a paged arena through a per-request block table, on the full
``[B, ...]`` shapes.  The kernel wrappers compute these for CPU tensors;
on the card they are what each kernel is held against.

Masking semantics match the reference's ``attention_decode``:

* ``pos < 0`` marks an empty ring slot (never attended);
* causal: the query at ``q_pos`` sees keys with ``pos <= q_pos``;
* ``window``: only keys with ``q_pos - pos < window`` (None = global).

The softmax is the flash form — masked lanes contribute an exact ``0.0``
(``torch.where`` before and after the exp), the max is subtracted per
row, and the normalizer divides the *output* (``o / l``, clamped at
``1e-30`` so a row with every lane masked gives 0, not NaN).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import exact_pow2

Tensor = torch.Tensor

_NEG = -1e30


def valid_mask(pos: Tensor, q_pos: Tensor, *, window: Optional[int],
               causal: bool) -> Tensor:
    """[B, W] bool: which ring slots the query at ``q_pos`` [B] may see."""
    d = q_pos[:, None] - pos
    valid = pos >= 0
    if causal:
        valid = valid & (d >= 0)
    if window:
        valid = valid & (d < window)
    return valid


def attend(qf: Tensor, kf: Tensor, vf: Tensor, pos: Tensor, q_pos: Tensor, *,
           scale: float, window: Optional[int] = None,
           causal: bool = True) -> Tensor:
    """Single-query GQA attention on dequantized (f32) operands.

    ``qf``: [B, K, G, hd] · ``kf``/``vf``: [B, W, K, hd] · ``pos``: [B, W]
    int32 · ``q_pos``: [B] int32.  Returns [B, K, G, hd] float32.
    """
    s = torch.einsum("bkgh,bwkh->bkgw", qf, kf) * scale
    v4 = valid_mask(pos, q_pos, window=window, causal=causal)[:, None, None, :]
    s = torch.where(v4, s, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(v4, torch.exp(s - m), 0.0)
    el = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgw,bwkh->bkgh", p, vf)
    return o / torch.clamp(el, min=1e-30)


def chunk_attend(qf: Tensor, kf: Tensor, vf: Tensor, pos: Tensor,
                 k_new: Tensor, v_new: Tensor, p0: Tensor, n_valid: Tensor, *,
                 scale: float, window: Optional[int] = None,
                 causal: bool = True) -> Tensor:
    """Chunked-prefill attention on dequantized (f32) operands.

    A chunk of ``C`` query positions starting at absolute position ``p0``
    attends (a) the already-written pool **history** — ring entries with
    ``0 <= pos < p0`` — and (b) its **own** chunk K/V causally, in one
    joint softmax.

    ``qf``: [B, C, K, G, hd] · ``kf``/``vf``: [B, W, K, hd] ·
    ``pos``: int32 [B, W] · ``k_new``/``v_new``: f32 [B, C, K, hd] ·
    ``p0``/``n_valid``: int32 [B] (rows past ``n_valid`` are masked
    everywhere and come out 0).  Returns f32 [B, C, K, G, hd].
    """
    B, C, K, G, hd = qf.shape
    W = kf.shape[1]
    cpos = torch.arange(C, dtype=torch.int32, device=qf.device)
    q_pos = p0[:, None] + cpos[None, :]                    # [B, C]
    row_ok = cpos[None, :] < n_valid[:, None]              # [B, C]

    sh = torch.einsum("bckgh,bwkh->bkgcw", qf, kf) * scale
    d = q_pos[:, :, None] - pos[:, None, :]                # [B, C, W]
    vh = (pos[:, None, :] >= 0) & (pos[:, None, :] < p0[:, None, None]) \
        & row_ok[:, :, None]
    if causal:
        vh = vh & (d >= 0)
    if window:
        vh = vh & (d < window)

    ss = torch.einsum("bckgh,bjkh->bkgcj", qf, k_new) * scale
    dj = cpos[:, None] - cpos[None, :]                     # [C, C]
    vs = row_ok[:, :, None] & row_ok[:, None, :]
    if causal:
        vs = vs & (dj >= 0)[None]
    if window:
        vs = vs & (dj < window)[None]

    v4h = vh[:, None, None]                                # [B,1,1,C,W]
    v4s = vs[:, None, None]                                # [B,1,1,C,C]
    s = torch.cat([torch.where(v4h, sh, _NEG),
                   torch.where(v4s, ss, _NEG)], dim=-1)
    m = torch.amax(s, dim=-1, keepdim=True)
    vcat = torch.cat([v4h.expand(sh.shape), v4s.expand(ss.shape)], dim=-1)
    p = torch.where(vcat, torch.exp(s - m), 0.0)
    el = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgcw,bwkh->bkgch", p[..., :W], vf) \
        + torch.einsum("bkgcj,bjkh->bkgch", p[..., W:], v_new)
    o = o / torch.clamp(el, min=1e-30)
    return o.permute(0, 3, 1, 2, 4)                        # [B, C, K, G, hd]


def dequant(m: Tensor, e: Tensor) -> Tensor:
    """[B, W, K, hd] mantissas × per-row exponents [B] → f32 values."""
    return m.to(torch.float32) * exact_pow2(e)[:, None, None, None]


def _wide(k: Tensor, v: Tensor, k_exp, v_exp, width: Optional[int]):
    if width is None:
        return k.to(torch.float32), v.to(torch.float32)
    return dequant(k, k_exp), dequant(v, v_exp)


def gather_pages(m: Tensor, e: Optional[Tensor], bt: Tensor,
                 width: Optional[int]) -> Tensor:
    """Block-table gather: paged storage → the slot-major wide layout.

    ``m``: [n_pages, P, K, hd] page arena (int mantissas when ``width``,
    raw floats otherwise) · ``e``: f32 [n_pages] per-page log2-steps ·
    ``bt``: int32 [B, nblocks] block table.  Returns f32
    [B, nblocks·P, K, hd] — logical row ``r`` is page ``bt[b, r // P]``
    offset ``r % P``, exactly the layout ``pos`` [B, nblocks·P] indexes,
    so :func:`attend`/:func:`chunk_attend` apply unchanged.
    """
    idx = bt.long()
    x = m[idx].to(torch.float32)                       # [B, nblocks, P, ...]
    if width is not None:
        x = x * exact_pow2(e[idx])[..., None, None, None]
    B, nblocks, P = x.shape[:3]
    return x.reshape((B, nblocks * P) + tuple(x.shape[3:]))


def paged_decode_attention_ref(q: Tensor, k: Tensor, v: Tensor, bt: Tensor,
                               pos: Tensor, q_pos: Tensor, *, k_exp=None,
                               v_exp=None, width: Optional[int] = None,
                               scale: float, window: Optional[int] = None,
                               causal: bool = True) -> Tensor:
    """Decode through the block-table gather — the plain K5.

    ``k``/``v`` are the [n_pages, P, K, hd] page arenas with per-**page**
    ``k_exp``/``v_exp`` [n_pages] (the
    :class:`repro_torch.serve.paged.PagedKVCodec` layout, one layer); the
    rest matches :func:`decode_attention_ref`.
    """
    kf = gather_pages(k, k_exp, bt, width)
    vf = gather_pages(v, v_exp, bt, width)
    return attend(q.to(torch.float32), kf, vf, pos, q_pos, scale=scale,
                  window=window, causal=causal)


def paged_decode_split_ref(q: Tensor, k: Tensor, v: Tensor, bt: Tensor,
                           pos: Tensor, q_pos: Tensor, *, splits: int,
                           k_exp=None, v_exp=None,
                           width: Optional[int] = None, scale: float,
                           window: Optional[int] = None,
                           causal: bool = True) -> Tensor:
    """K5's split over the pages on the CPU (used by tests only): the
    block table's entries cut into contiguous ranges of
    ``ceil(nblocks / splits)``, the flash partial ``(m, l, acc)`` of each
    range, then :func:`merge_splits`.  Equal to
    :func:`paged_decode_attention_ref` up to f32 summation order."""
    kf = gather_pages(k, k_exp, bt, width)
    vf = gather_pages(v, v_exp, bt, width)
    qf = q.to(torch.float32)
    nblocks, P = bt.shape[1], k.shape[1]
    pps = -(-nblocks // splits)
    valid = valid_mask(pos, q_pos, window=window, causal=causal)
    parts = []
    for b0 in range(0, nblocks, pps):
        r = slice(b0 * P, min(b0 + pps, nblocks) * P)
        v4 = valid[:, None, None, r]
        s = torch.einsum("bkgh,bwkh->bkgw", qf, kf[:, r]) * scale
        s = torch.where(v4, s, _NEG)
        m = torch.where(v4.any(dim=-1), torch.amax(s, dim=-1), -torch.inf)
        p = torch.where(v4, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgw,bwkh->bkgh", p, vf[:, r])))
    return merge_splits(parts)


def merge_splits(parts) -> Tensor:
    """Merge flash partials ``[(m, l, acc), ...]`` (``m``/``l``: [...],
    ``acc``: [..., hd]) in list order: ``m* = max m_s``, ``l* = Σ l_s
    e^(m_s - m*)``, ``out = Σ acc_s e^(m_s - m*) / max(l*, 1e-30)``.  A
    part with ``m = -inf`` weighs exactly 0, and a row whose parts all
    have ``m = -inf`` gives 0, not NaN."""
    mstar = parts[0][0]
    for m, _, _ in parts[1:]:
        mstar = torch.maximum(mstar, m)
    seen = mstar > -torch.inf
    el = torch.zeros_like(mstar)
    o = torch.zeros_like(parts[0][2])
    for m, l_s, acc in parts:
        w = torch.where(seen & (m > -torch.inf), torch.exp(m - mstar), 0.0)
        el = el + l_s * w
        o = o + acc * w[..., None]
    return o / torch.clamp(el, min=1e-30)[..., None]


def paged_prefill_attention_ref(q: Tensor, k: Tensor, v: Tensor, bt: Tensor,
                                pos: Tensor, k_new: Tensor, v_new: Tensor,
                                p0: Tensor, n_valid: Tensor, *, k_exp=None,
                                v_exp=None, width: Optional[int] = None,
                                scale: float, window: Optional[int] = None,
                                causal: bool = True) -> Tensor:
    """Chunked prefill through the block-table gather — the plain K6, in
    the :class:`repro_torch.serve.paged.PagedKVCodec` entry layout."""
    kf = gather_pages(k, k_exp, bt, width)
    vf = gather_pages(v, v_exp, bt, width)
    return chunk_attend(q.to(torch.float32), kf, vf, pos,
                        k_new.to(torch.float32), v_new.to(torch.float32),
                        p0, n_valid, scale=scale, window=window,
                        causal=causal)


def decode_attention_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                         q_pos: Tensor, *, k_exp=None, v_exp=None,
                         width: Optional[int] = None, scale: float,
                         window: Optional[int] = None,
                         causal: bool = True) -> Tensor:
    """Dequantize (when ``width``) then :func:`attend` — the plain K3.

    ``width=None`` takes ``k``/``v`` as raw float K/V; otherwise they are
    int8/int16 mantissas with ``k_exp``/``v_exp`` [B] log2-steps (the
    packed pool's entry layout for one layer).
    """
    kf, vf = _wide(k, v, k_exp, v_exp, width)
    return attend(q.to(torch.float32), kf, vf, pos, q_pos, scale=scale,
                  window=window, causal=causal)


def prefill_attention_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                          k_new: Tensor, v_new: Tensor, p0: Tensor,
                          n_valid: Tensor, *, k_exp=None, v_exp=None,
                          width: Optional[int] = None, scale: float,
                          window: Optional[int] = None,
                          causal: bool = True) -> Tensor:
    """Dequantize (when ``width``) then :func:`chunk_attend` — the plain K4."""
    kf, vf = _wide(k, v, k_exp, v_exp, width)
    return chunk_attend(q.to(torch.float32), kf, vf, pos,
                        k_new.to(torch.float32), v_new.to(torch.float32),
                        p0, n_valid, scale=scale, window=window,
                        causal=causal)
