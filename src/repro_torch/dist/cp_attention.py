"""Context-parallel GQA decode attention (KV window sharded over the mesh).

The port of ``repro.dist.cp_attention``.  At long contexts the decode KV
cache dwarfs everything else on a device; the serving pool shards its
ring *window* over the ``data`` axis, and this module runs single-query
attention against that sharded window: each rank computes attention over
its local slots only, and the partial softmax statistics ``(max,
sum-exp, weighted values)`` are combined **exactly** across ranks with
``pmax``/``psum`` — the standard log-sum-exp merge.

Empty ring slots carry position ``-1``; validity is ``pos >= 0 and q_pos
>= pos`` (causality in absolute positions), evaluated locally — a rank
whose whole shard is invalid contributes zero weight through the
``exp(m_local - m_global)`` correction.

The reference compiles this as plain XLA math (no Pallas kernel), so its
port is plain PyTorch; ``exp`` is XLA's CPU evaluation
(:func:`repro_torch.core.prng.exp`), as the reference's jitted ``exp``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.prng import exp as _exp

Tensor = torch.Tensor


def _partial_attention(q, ck, cv, pos, q_pos, *, num_heads: int,
                       num_kv_heads: int, head_dim: int):
    """Local softmax partials over a (shard of the) KV window.

    ``q``: [B, Sq, H, hd]; ``ck``/``cv``: [B, W, K, hd]; ``pos``: [B, W]
    (slot absolute positions, -1 = empty); ``q_pos``: [B, Sq].
    Returns ``(o, l, m)``: [B, K, G, Sq, hd], [B, K, G, Sq], [B, K, G, Sq].
    """
    B, Sq = q.shape[:2]
    K, G = num_kv_heads, num_heads // num_kv_heads
    qg = q.to(torch.float32).reshape(B, Sq, K, G, head_dim)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, ck.to(torch.float32))
    s = s / math.sqrt(head_dim)
    valid = (pos[:, None, :] >= 0) & \
        (q_pos[:, :, None] - pos[:, None, :] >= 0)              # [B,Sq,W]
    vexp = valid[:, None, None, :, :]                           # [B,1,1,Sq,W]
    s = torch.where(vexp, s, -1e30)
    m = torch.amax(s, dim=-1)                                   # [B,K,G,Sq]
    # fully-masked shard: s - m == 0 everywhere would leak exp(0)=1 — the
    # explicit where() zeroes invalid slots regardless of m
    p = torch.where(vexp, _exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)                                           # [B,K,G,Sq]
    o = torch.einsum("bkgqs,bskh->bkgqh", p, cv.to(torch.float32))
    return o, l, m


def _merge(o, l, m, axes: Tuple[str, ...], mesh):
    """Exact cross-shard softmax merge: rescale partials to the global max."""
    m_glob = mesh.pmax(m, axes)
    alpha = _exp(m - m_glob)
    l_glob = mesh.psum(l * alpha, axes)
    o_glob = mesh.psum(o * alpha[..., None], axes)
    return o_glob, l_glob


def _finish(o, l, B: int, Sq: int, num_heads: int, head_dim: int, dtype):
    out = o / torch.clamp(l, min=1e-30)[..., None]   # [B, K, G, Sq, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, num_heads * head_dim)
    return out.to(dtype)


def cp_size(cp_axes: Tuple[str, ...], W: int, mesh=None) -> int:
    """The live CP degree: the product of ``cp_axes``' sizes in the
    (ambient) mesh when every axis exists, it exceeds 1 and divides the
    global window ``W``; 0 otherwise (the monolithic path)."""
    if mesh is None:
        from repro_torch.launch.mesh import ambient_mesh
        mesh = ambient_mesh()
    if not cp_axes or mesh is None or \
            not all(a in mesh.shape for a in cp_axes):
        return 0
    n = mesh.axis_size(tuple(cp_axes))
    return n if n > 1 and W % n == 0 else 0


def cp_decode_attention(q: Tensor, cache_k: Tensor, cache_v: Tensor,
                        cache_pos: Tensor, q_pos: Tensor, *, num_heads: int,
                        num_kv_heads: int, head_dim: int,
                        cp_axes: Tuple[str, ...] = (), mesh=None,
                        local: bool = False) -> Tensor:
    """Single-query attention over a (possibly window-sharded) KV cache.

    ``q``: [B, Sq, H, hd] (decode: Sq == 1); ``cache_k``/``cache_v``:
    [B, W, K, hd]; ``cache_pos``: [B, W] absolute positions (-1 empty);
    ``q_pos``: [B, Sq].  Returns [B, Sq, H*hd], the same on every rank.

    With ``cp_axes`` naming live mesh axes whose degree divides ``W``
    (:func:`cp_size`), each rank attends over its own contiguous slice of
    the window and the partial statistics are merged exactly; otherwise
    (no mesh, axis missing, indivisible window) the result is the
    monolithic one.  ``local=True`` says the cache already is this rank's
    slice of a window ``n`` times as long (the serving pool's shard).
    """
    from repro_torch.launch.mesh import ambient_mesh

    mesh = mesh if mesh is not None else ambient_mesh()
    B, Sq = q.shape[:2]
    cp_axes = tuple(cp_axes)
    W = cache_k.shape[1]
    n = mesh.axis_size(cp_axes) if (
        cp_axes and mesh is not None
        and all(a in mesh.shape for a in cp_axes)) else 1
    n = cp_size(cp_axes, W * n if local else W, mesh)
    if n and not local:
        Wl = W // n
        w0 = mesh.axis_index(cp_axes) * Wl
        cache_k, cache_v = cache_k[:, w0:w0 + Wl], cache_v[:, w0:w0 + Wl]
        cache_pos = cache_pos[:, w0:w0 + Wl]
    o, l, m = _partial_attention(q, cache_k, cache_v, cache_pos, q_pos,
                                 num_heads=num_heads,
                                 num_kv_heads=num_kv_heads,
                                 head_dim=head_dim)
    if n:
        o, l = _merge(o, l, m, cp_axes, mesh)
    return _finish(o, l, B, Sq, num_heads, head_dim, q.dtype)
