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
from repro_torch.kernels.qmatmul.ref import LO_SCALE, split_tf32

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


def _split_partials(qf: Tensor, kf: Tensor, vf: Tensor, valid: Tensor,
                    ranges, scale: float):
    """The flash partials ``(m, l, acc)`` of single-query attention over
    each ``(w0, w1)`` key range: ``m = -inf`` where a range sees no key."""
    parts = []
    for w0, w1 in ranges:
        v4 = valid[:, None, None, w0:w1]
        s = torch.einsum("bkgh,bwkh->bkgw", qf, kf[:, w0:w1]) * scale
        s = torch.where(v4, s, _NEG)
        m = torch.where(v4.any(dim=-1), torch.amax(s, dim=-1), -torch.inf)
        p = torch.where(v4, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgw,bwkh->bkgh", p, vf[:, w0:w1])))
    return parts


def _cut(n: int, splits: int, unit: int, end: int):
    """``n`` units of ``unit`` keys cut into contiguous ranges of
    ``ceil(n / splits)`` units, as key ranges ``(w0, w1)`` clipped at
    ``end``."""
    per = -(-n // splits)
    return [(u * unit, min((u + per) * unit, end)) for u in range(0, n, per)]


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
    nblocks, P = bt.shape[1], k.shape[1]
    valid = valid_mask(pos, q_pos, window=window, causal=causal)
    return merge_splits(_split_partials(
        q.to(torch.float32), kf, vf, valid,
        _cut(nblocks, splits, P, nblocks * P), scale))


def decode_split_ref(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                     q_pos: Tensor, *, splits: int, k_exp=None, v_exp=None,
                     width: Optional[int] = None, scale: float,
                     window: Optional[int] = None,
                     causal: bool = True) -> Tensor:
    """K3's split over the ring on the CPU (used by tests only): the
    ring's ``ceil(W / 32)`` tiles cut into contiguous ranges of
    ``ceil(n_tiles / splits)`` tiles (the last clipped at W), the flash
    partial of each range, then :func:`merge_splits`.  Equal to
    :func:`decode_attention_ref` up to f32 summation order."""
    kf, vf = _wide(k, v, k_exp, v_exp, width)
    W = k.shape[1]
    valid = valid_mask(pos, q_pos, window=window, causal=causal)
    return merge_splits(_split_partials(
        q.to(torch.float32), kf, vf, valid, _cut(-(-W // 32), splits, 32, W),
        scale))


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


def _tf32_parts(x: Tensor, exact: bool):
    """``(hi, lo)`` TF32 parts of ``x`` (lo times 2^12), or ``(x, None)``
    for an operand that is exact in TF32."""
    return (x, None) if exact else split_tf32(x)


def _tf32_einsum(eq: str, a, b) -> Tensor:
    """``hi·hi + (lo·hi + hi·lo)·2^-12`` over the parts that exist: the
    card's products, each an f32 einsum of TF32 values."""
    (ah, al), (bh, bl) = a, b
    out = torch.einsum(eq, ah, bh)
    lo = None
    if al is not None:
        lo = torch.einsum(eq, al, bh)
    if bl is not None:
        t = torch.einsum(eq, ah, bl)
        lo = t if lo is None else lo + t
    return out if lo is None else out + lo / LO_SCALE


def prefill_tf32_emulated(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                          k_new: Tensor, v_new: Tensor, p0: Tensor,
                          n_valid: Tensor, *, k_exp=None, v_exp=None,
                          width: Optional[int] = None, scale: float,
                          window: Optional[int] = None, causal: bool = True,
                          splits: int = 1) -> Tensor:
    """K4's route on the CPU (used by tests only): q·k and p·v on TF32
    parts — q, p, int16 mantissas and every f32 K/V split into hi + lo,
    int8 mantissas whole, the slot's steps applied to the score and to
    the product — and the list of the ring's ``ceil(W / 32)`` tiles then
    the chunk's ``ceil(C / 32)``, kept where some (row, key) pair of the
    tile is unmasked, cut into ``splits`` even parts as a kernel block
    cuts its own list, each a flash partial, merged by
    :func:`merge_splits`.  The masks are :func:`chunk_attend`'s."""
    kf, vf = _wide(k, v, k_exp, v_exp, width)
    return _prefill_route(q, kf, vf, width, pos, k_new, v_new, p0, n_valid,
                          scale=scale, window=window, causal=causal,
                          splits=splits)


def paged_prefill_tf32_emulated(q: Tensor, k: Tensor, v: Tensor, bt: Tensor,
                                pos: Tensor, k_new: Tensor, v_new: Tensor,
                                p0: Tensor, n_valid: Tensor, *, k_exp=None,
                                v_exp=None, width: Optional[int] = None,
                                scale: float, window: Optional[int] = None,
                                causal: bool = True,
                                splits: int = 1) -> Tensor:
    """K6's route on the CPU (used by tests only): K4's route
    (:func:`prefill_tf32_emulated`) over the slot's ``nblocks·P`` logical
    rows through its block table, each history tile taking its own page's
    steps (with ``P`` a multiple of 32 a tile lies in one page)."""
    kf = gather_pages(k, k_exp, bt, width)
    vf = gather_pages(v, v_exp, bt, width)
    return _prefill_route(q, kf, vf, width, pos, k_new, v_new, p0, n_valid,
                          scale=scale, window=window, causal=causal,
                          splits=splits)


def _prefill_route(q: Tensor, kf: Tensor, vf: Tensor, width: Optional[int],
                   pos: Tensor, k_new: Tensor, v_new: Tensor, p0: Tensor,
                   n_valid: Tensor, *, scale: float, window: Optional[int],
                   causal: bool, splits: int) -> Tensor:
    """The TF32 route of K4 and K6 on dequantized history ``kf``/``vf``
    [B, W, K, hd].  A mantissa times its step (a power of two) splits into
    the mantissa's TF32 parts times the step, so applying the step before
    the products, as here, or after them, as the kernels do, gives the
    same values; int8 mantissas (``width <= 8``) are exact in TF32."""
    B, C, K, G, hd = q.shape
    W = kf.shape[1]
    exact = width is not None and width <= 8
    qp = _tf32_parts(q.to(torch.float32), False)
    kh = _tf32_parts(kf, exact)
    vh = _tf32_parts(vf, exact)
    kn = _tf32_parts(k_new.to(torch.float32), False)
    vn = _tf32_parts(v_new.to(torch.float32), False)
    sh = _tf32_einsum("bckgh,bwkh->bkgcw", qp, kh) * scale
    ss = _tf32_einsum("bckgh,bjkh->bkgcj", qp, kn) * scale
    s = torch.cat([sh, ss], dim=-1)                          # [B,K,G,C,W+C]

    cpos = torch.arange(C, dtype=torch.int32, device=q.device)
    qpos = p0[:, None] + cpos[None, :]
    row_ok = cpos[None, :] < n_valid[:, None]
    kpos = torch.cat([pos, qpos], dim=-1)                    # [B, W+C]
    kok = torch.cat([(pos >= 0) & (pos < p0[:, None]), row_ok], dim=-1)
    d = qpos[:, :, None] - kpos[:, None, :]
    valid = row_ok[:, :, None] & kok[:, None, :]
    if causal:
        valid = valid & (d >= 0)
    if window:
        valid = valid & (d < window)
    valid = valid[:, None, None]                              # [B,1,1,C,W+C]

    nh, ns = -(-W // 32), -(-C // 32)
    cols = [(t * 32, min(t * 32 + 32, W)) for t in range(nh)] \
        + [(W + j * 32, W + min(j * 32 + 32, C)) for j in range(ns)]
    cols = [(a, b) for a, b in cols if bool(valid[..., a:b].any())]
    parts = []
    for i in range(splits):
        part = cols[len(cols) * i // splits:len(cols) * (i + 1) // splits]
        if not part:
            continue
        sel = torch.cat([torch.arange(a, b, device=q.device)
                         for a, b in part])
        v4 = valid[..., sel]
        x = torch.where(v4, s[..., sel], _NEG)
        m = torch.where(v4.any(dim=-1), torch.amax(x, dim=-1), -torch.inf)
        p = torch.where(v4, torch.exp(x - m[..., None]), 0.0)
        pp = _tf32_parts(p, False)
        hist, own = sel[sel < W], sel[sel >= W] - W
        acc = _tf32_einsum("bkgcw,bwkh->bkgch",
                           (pp[0][..., :hist.numel()],
                            pp[1][..., :hist.numel()]),
                           (vh[0][:, hist], None if vh[1] is None
                            else vh[1][:, hist]))
        acc = acc + _tf32_einsum("bkgcj,bjkh->bkgch",
                                 (pp[0][..., hist.numel():],
                                  pp[1][..., hist.numel():]),
                                 (vn[0][:, own], vn[1][:, own]))
        parts.append((m, p.sum(dim=-1), acc))
    if not parts:                                             # no key seen
        return torch.zeros_like(q, dtype=torch.float32)
    return merge_splits(parts).permute(0, 3, 1, 2, 4)         # [B,C,K,G,hd]
