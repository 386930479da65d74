"""Shared neural-net layers, quantization-aware (tape-threaded), dense parts.

The port of ``repro.models.layers`` for the dense decoder: every weighted
sum goes through ``tape.dot`` (weight re-quantized to the computation
width at use time, f32 accumulation) and every group boundary through
``tape.act``.  With a float32 policy all of it is the identity.

Attention comes in a training shape and three serving shapes:
  * ``attention_train`` — naive masked scores (the training path);
  * ``attention_prefill`` — whole-prompt online softmax over KV chunks;
  * ``attention_prefill_chunk`` — one prompt chunk against the KV pool;
  * ``attention_decode`` — one token against the KV pool.

Weights are ``[d_in, d_out]`` as in ``x @ W``, and queries handed to the
attention kernels are kv-head-major ``[B, K, G, hd]`` — the reference's
layouts, so the two packages compare like with like.  Initial weights
are the reference's: threefry normals (:mod:`repro_torch.core.prng`) from
the same keys, split in the same order, so ``init_*(key)`` draws the
reference's numbers; a batch of keys ``[L, 2]`` draws ``L`` stacked
layers (the reference's ``vmap`` over its split keys).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import prng
from repro_torch.core.tape import QTape
from repro_torch.kernels.attn import ops as attn_ops
from repro_torch.kernels.attn import ref as AR

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def init_dense(key: Tensor, d_in: int, d_out: int,
               scale: Optional[float] = None) -> Tensor:
    """Normal ``[..., d_in, d_out]`` weights times ``scale`` (default
    ``1/sqrt(d_in)``), one ``[d_in, d_out]`` draw per key of ``key``
    ``[..., 2]``, drawn in row blocks (:func:`prng.normal_blocked`)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return prng.normal_blocked(key, (d_in, d_out)).mul_(scale)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return torch.exp(-ar / head_dim * torch.log(
        torch.tensor(theta, dtype=torch.float32, device=device)))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """``x``: [B, S, H, hd]. ``positions``: [B, S] absolute positions."""
    if positions.ndim != 2:
        raise NotImplementedError("M-RoPE position streams are not ported")
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    angle = positions.to(torch.float32)[..., None] * freqs     # [B, S, hd/2]
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    causal: bool = True

    @property
    def q_dim(self):
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.num_kv_heads * self.head_dim


def init_attn(key: Tensor, spec: AttnSpec) -> dict:
    ks = prng.split(key, 4)
    return {
        "wq": init_dense(ks[..., 0, :], spec.d_model, spec.q_dim),
        "wk": init_dense(ks[..., 1, :], spec.d_model, spec.kv_dim),
        "wv": init_dense(ks[..., 2, :], spec.d_model, spec.kv_dim),
        "wo": init_dense(ks[..., 3, :], spec.q_dim, spec.d_model),
    }


def _qkv(params, spec: AttnSpec, x: Tensor, positions, tape: QTape,
         prefix: str):
    B, S, _ = x.shape
    q = tape.dot(f"{prefix}/wq", x, params["wq"]).reshape(
        B, S, spec.num_heads, spec.head_dim)
    k = tape.dot(f"{prefix}/wk", x, params["wk"]).reshape(
        B, S, spec.num_kv_heads, spec.head_dim)
    v = tape.dot(f"{prefix}/wv", x, params["wv"]).reshape(
        B, S, spec.num_kv_heads, spec.head_dim)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    q = tape.act(f"{prefix}/qkv", q)
    k = tape.act(f"{prefix}/k", k)
    v = tape.act(f"{prefix}/v", v)
    return q, k, v


def _mask(q_pos: Tensor, k_pos: Tensor, window, causal: bool) -> Tensor:
    """[.., Sq, Sk] boolean validity mask. window==0/None means global."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = (d >= 0) if causal else torch.ones(d.shape, dtype=torch.bool,
                                           device=d.device)
    if window:
        m = m & (d < window)
    return m


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
          scale: float) -> Tensor:
    """Naive scores; f32 softmax; GQA via head-group reshape.  ``q``
    [B, Sq, H, hd], ``k``/``v`` [B, Sk, K, hd], ``mask`` [B, Sq, Sk]."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * scale
    logits = torch.where(mask[:, None, None], logits, -1e30)
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def attention_train(params, spec: AttnSpec, x: Tensor, positions: Tensor,
                    tape: QTape, prefix: str, window=None,
                    kv_source: Optional[Tensor] = None) -> Tensor:
    """Training-path self-attention (naive masked scores): ``x`` [B, S,
    D] at ``positions`` [B, S]; ``wo`` through ``tape.dot`` and the
    ``out`` site, as the reference's.  The q·k and p·v products are plain
    ``einsum``s, as the reference leaves them to XLA."""
    if kv_source is not None:
        raise NotImplementedError(
            "cross-attention (kv_source) is not ported yet: it comes with "
            "the encoder-decoder family (ROADMAP module item 21)")
    B, S, _ = x.shape
    q, k, v = _qkv(params, spec, x, positions, tape, prefix)
    mask = _mask(positions, positions, window, spec.causal)
    o = _sdpa(q, k, v, mask, 1.0 / math.sqrt(spec.head_dim))
    y = tape.dot(f"{prefix}/wo", o.reshape(B, S, spec.q_dim), params["wo"])
    return tape.act(f"{prefix}/out", y)


def attention_prefill(params, spec: AttnSpec, x: Tensor, positions: Tensor,
                      tape: QTape, prefix: str, window=None,
                      chunk: int = 1024):
    """Whole-prompt prefill: online softmax over KV chunks; returns
    ``(y, (k, v))``.  Peak memory ∝ ``Sq × chunk``."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, spec, x, positions, tape, prefix)
    K, hd = spec.num_kv_heads, spec.head_dim
    G = spec.num_heads // K
    scale = 1.0 / math.sqrt(hd)
    q_pos = positions

    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    # pad positions must be invalid under the causal mask → large positive
    pos_p = torch.nn.functional.pad(q_pos, (0, pad), value=2 ** 30)
    qg = q.reshape(B, S, K, G, hd)

    m = torch.full((B, K, G, S), -math.inf, dtype=torch.float32,
                   device=x.device)
    el = torch.zeros((B, K, G, S), dtype=torch.float32, device=x.device)
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kci, vci, pci = kp[:, sl], vp[:, sl], pos_p[:, sl]
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kci) * scale
        vexp = _mask(q_pos, pci, window, spec.causal)[:, None, None]
        s = torch.where(vexp, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked chunks: exp(-1e30 - (-1e30)) = 1 would leak — zero it
        p = torch.where(vexp, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        el = el * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckh->bkgqh", p, vci.to(torch.float32))
        m = m_new
    o = acc / torch.clamp(el, min=1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, spec.q_dim).to(x.dtype)
    y = tape.dot(f"{prefix}/wo", o, params["wo"])
    return tape.act(f"{prefix}/out", y), (k, v)


def scatter_drop(buf: Tensor, slot: Tensor, vals: Tensor) -> Tensor:
    """``buf`` [B, W, ...] with ``vals`` [B, C, ...] written at ring slots
    ``slot`` [B, C]; rows whose slot is ``W`` are dropped.

    The out-of-range rows land in a scratch row appended past the ring
    and cut off again, so a dropped row can never collide with a kept one
    — the reference's ``.at[].set(mode="drop")``.  Returns a new
    contiguous tensor; ``buf`` is not modified.
    """
    B, W = buf.shape[:2]
    out = torch.cat([buf, buf.new_zeros((B, 1) + buf.shape[2:])], dim=1)
    bidx = torch.arange(B, device=buf.device)[:, None].expand_as(slot)
    out[bidx, slot.long()] = vals.to(buf.dtype)
    return out[:, :W].contiguous()


def chunk_slots(p0: Tensor, n_valid: Tensor, C: int, W: int):
    """Ring slots of a prefill chunk's rows: ``(pos [B, C], keep [B, C],
    slot [B, C])``.  Rows past ``n_valid`` and rows the ring would evict
    within the same chunk (``C`` larger than a windowed cap) are not
    kept; their slot is ``W`` (dropped by :func:`scatter_drop`)."""
    idx = torch.arange(C, dtype=torch.int32, device=p0.device)
    pos = p0[:, None] + idx[None, :]
    keep = (idx[None, :] < n_valid[:, None]) & \
        (pos >= p0[:, None] + n_valid[:, None] - W)
    slot = torch.where(keep, pos % W, W)
    return pos, keep, slot


class RawKVCodec:
    """Float-container KV-cache codec: the ring buffer ``{"k","v","pos"}``.

    The codec protocol is the decode cache's storage contract:
    ``append(entry, k_new, v_new, pos)`` writes one token's K/V into slot
    ``pos % W``; ``load(entry)`` returns ``(k, v, pos)`` as wide tensors.
    :class:`repro_torch.serve.kv_pool.PackedKVCodec` stores int mantissas
    with per-slot DFXP exponents behind the same protocol.

    ``fused_decode`` selects the attention path: when set, decode and
    chunked prefill call ``fused_attention``/``fused_prefill`` — the
    flash kernels reading the entry's storage directly — instead of
    ``load`` and the plain einsums.  Every method is functional: it
    returns new tensors and leaves ``entry`` as it was.
    """

    def __init__(self, fused_decode: bool = False):
        self.fused_decode = bool(fused_decode)

    def append(self, entry: dict, k_new: Tensor, v_new: Tensor,
               pos: Tensor, mask: Optional[Tensor] = None) -> dict:
        """``k_new``/``v_new``: [B, K, hd]; ``pos``: [B] int32.  ``mask``
        (bool [B]) drops the append for masked-off rows entirely."""
        W = entry["k"].shape[1]
        slot = pos % W
        if mask is not None:
            slot = torch.where(mask, slot, W)
        slot = slot[:, None]
        return {"k": scatter_drop(entry["k"], slot, k_new[:, None]),
                "v": scatter_drop(entry["v"], slot, v_new[:, None]),
                "pos": scatter_drop(entry["pos"], slot, pos[:, None])}

    def append_chunk(self, entry: dict, k_new: Tensor, v_new: Tensor,
                     p0: Tensor, n_valid: Tensor) -> dict:
        """Write a prefill chunk's K/V ``[B, C, K, hd]`` at positions
        ``p0 + i``; ``p0 == 0`` (admission) first resets the slot's stale
        ring positions to -1."""
        W = entry["k"].shape[1]
        pos, _, slot = chunk_slots(p0, n_valid, k_new.shape[1], W)
        pos_buf = torch.where((p0 == 0)[:, None], -1, entry["pos"])
        return {"k": scatter_drop(entry["k"], slot, k_new),
                "v": scatter_drop(entry["v"], slot, v_new),
                "pos": scatter_drop(pos_buf, slot, pos)}

    def load(self, entry: dict):
        return entry["k"], entry["v"], entry["pos"]

    def fused_attention(self, entry: dict, qg: Tensor, q_pos: Tensor, *,
                        scale: float, window=None, causal: bool = True):
        """Flash-decode (K3) on the raw f32 ring (``width=None``)."""
        return attn_ops.flash_decode(qg, entry["k"], entry["v"],
                                     entry["pos"], q_pos, width=None,
                                     scale=scale, window=window,
                                     causal=causal)

    def fused_prefill(self, entry: dict, qg: Tensor, k_new: Tensor,
                      v_new: Tensor, p0: Tensor, n_valid: Tensor, *,
                      scale: float, window=None, causal: bool = True):
        """Flash-prefill (K4) on the raw f32 ring (``width=None``)."""
        return attn_ops.flash_prefill(qg, k_new, v_new, entry["k"],
                                      entry["v"], entry["pos"], p0, n_valid,
                                      width=None, scale=scale, window=window,
                                      causal=causal)


RAW_KV_CODEC = RawKVCodec()


def attention_prefill_chunk(params, spec: AttnSpec, x: Tensor,
                            positions: Tensor, cache: dict, tape: QTape,
                            prefix: str, *, n_valid: Tensor, window=None,
                            codec=None):
    """One chunked-prefill step: ``C`` prompt positions against the pool.

    ``x``: [B, C, D] at absolute positions ``positions`` [B, C]
    (``positions[:, 0]`` is the chunk start ``p0``; ``p0 == 0`` marks the
    admission chunk).  ``n_valid`` [B] masks a ragged final chunk.  The
    chunk attends the slot's history (``0 <= pos < p0``) plus its own
    fresh K/V causally, *before* ``codec.append_chunk`` writes the chunk
    into the pool.  Returns ``(y, cache')``.
    """
    codec = codec or RAW_KV_CODEC
    B, C, _ = x.shape
    q, k_new, v_new = _qkv(params, spec, x, positions, tape, prefix)
    K, hd = spec.num_kv_heads, spec.head_dim
    G = spec.num_heads // K
    scale = 1.0 / math.sqrt(hd)
    p0 = positions[:, 0].contiguous()
    qg = q.reshape(B, C, K, G, hd).to(torch.float32)
    kf = k_new.to(torch.float32)
    vf = v_new.to(torch.float32)
    if codec.fused_decode:
        o = codec.fused_prefill(cache, qg, kf, vf, p0, n_valid, scale=scale,
                                window=window, causal=spec.causal)
    else:
        ck, cv, cpos = codec.load(cache)
        o = AR.chunk_attend(qg, ck.to(torch.float32), cv.to(torch.float32),
                            cpos, kf, vf, p0, n_valid, scale=scale,
                            window=window, causal=spec.causal)
    cache = codec.append_chunk(cache, kf, vf, p0, n_valid)
    o = o.reshape(B, C, spec.q_dim).to(x.dtype)
    y = tape.dot(f"{prefix}/wo", o, params["wo"])
    return tape.act(f"{prefix}/out", y), cache


def attention_decode(params, spec: AttnSpec, x: Tensor, positions: Tensor,
                     cache: dict, tape: QTape, prefix: str, window=None,
                     codec=None, append_mask=None):
    """One-token decode. ``x``: [B, 1, D] at ``positions`` int32 [B, 1]
    (every slot decodes at its own position); ``cache``: a codec-owned
    entry.

    Appends the new token's K/V through the codec (slot ``pos % W``, so
    the token attends to itself), then attends over the whole ring with a
    position-validity mask.  ``append_mask`` (bool [B]) drops the append
    for masked-off rows.  With ``codec.fused_decode`` the attention is the
    flash-decode kernel on the codec's storage; otherwise ``codec.load``
    and the plain softmax.  Returns ``(y, cache')``.
    """
    codec = codec or RAW_KV_CODEC
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, spec, x, positions, tape, prefix)
    q_pos = positions[:, 0].contiguous()
    cache = codec.append(cache, k_new[:, 0], v_new[:, 0], q_pos,
                         mask=append_mask)
    K, hd = spec.num_kv_heads, spec.head_dim
    G = spec.num_heads // K
    scale = 1.0 / math.sqrt(hd)

    if codec.fused_decode:
        qg = q.reshape(B, K, G, hd).to(torch.float32)
        o = codec.fused_attention(cache, qg, q_pos, scale=scale,
                                  window=window, causal=spec.causal)
    else:
        cache_k, cache_v, cache_pos = codec.load(cache)
        qg = q.reshape(B, 1, K, G, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k) * scale
        valid = _mask(positions, cache_pos, window, spec.causal)  # [B, 1, W]
        valid = valid & (cache_pos >= 0)[:, None, :]              # -1 = empty
        s = torch.where(valid[:, None, None], s, -1e30)
        p = torch.softmax(s.to(torch.float32), dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, cache_v.to(torch.float32))
    o = o.reshape(B, 1, spec.q_dim).to(x.dtype)
    y = tape.dot(f"{prefix}/wo", o, params["wo"])
    return tape.act(f"{prefix}/out", y), cache


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------

def init_swiglu(key: Tensor, d_model: int, d_ff: int) -> dict:
    ks = prng.split(key, 3)
    return {
        "w_gate": init_dense(ks[..., 0, :], d_model, d_ff),
        "w_up": init_dense(ks[..., 1, :], d_model, d_ff),
        "w_down": init_dense(ks[..., 2, :], d_ff, d_model),
    }


def swiglu(params, x: Tensor, tape: QTape, prefix: str) -> Tensor:
    g = tape.dot(f"{prefix}/w_gate", x, params["w_gate"])
    u = tape.dot(f"{prefix}/w_up", x, params["w_up"])
    h = tape.act(f"{prefix}/pre", torch.nn.functional.silu(g) * u)
    y = tape.dot(f"{prefix}/w_down", h, params["w_down"])
    return tape.act(f"{prefix}/out", y)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def init_embed(key: Tensor, vocab: int, d_model: int) -> Tensor:
    return prng.normal_blocked(key, (vocab, d_model)).mul_(0.02)


def embed(table: Tensor, tokens: Tensor, tape: QTape) -> Tensor:
    t = tape.weight("emb/w", table)
    return tape.act("emb/out", t[tokens.long()])


def lm_head(table_or_w: Tensor, x: Tensor, tape: QTape, *,
            tied: bool) -> Tensor:
    """Vocabulary projection through ``tape.dot`` (K2 on the fused path).

    Tied heads contract against the embedding table's last dim
    (``transpose_b``: the ``nt`` layout on the fused path)."""
    logits = tape.dot("head/w", x, table_or_w, transpose_b=tied)
    return tape.act("head/logits", logits)
