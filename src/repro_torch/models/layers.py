"""Shared neural-net layers, quantization-aware (tape-threaded).

The port of ``repro.models.layers``: every weighted
sum goes through ``tape.dot`` (weight re-quantized to the computation
width at use time, f32 accumulation) and every group boundary through
``tape.act``.  With a float32 policy all of it is the identity.

Attention comes in a training shape and three serving shapes:
  * ``attention_train`` — naive masked scores (the training path, and
    cross-attention against an encoder's memory);
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
from typing import Optional, Tuple

import numpy as np
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
# rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return torch.exp(-ar / head_dim * torch.log(
        torch.tensor(theta, dtype=torch.float32, device=device)))


def mrope_streams(hd: int, sections: Tuple[int, ...]) -> list:
    """The position stream of each of the ``hd/2`` frequency dims: dims
    of section ``i`` take stream ``i``; the reference's ``jnp.repeat(...,
    total_repeat_length=hd // 2)`` cuts a longer list and repeats the
    last stream into a shorter one's tail."""
    ids = [i for i, n in enumerate(sections) for _ in range(n)][:hd // 2]
    return ids + [ids[-1]] * (hd // 2 - len(ids))


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> Tensor:
    """``x``: [B, S, H, hd]. ``positions``: [B, S], or [3, B, S] for
    M-RoPE (qwen2-vl): the frequency dims are split into (temporal,
    height, width) sections, each rotated by its own position stream
    (``mrope_sections``, default one section of ``hd/2``)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    if positions.ndim == 3:                                    # M-RoPE
        ids = mrope_streams(hd, tuple(mrope_sections) or (hd // 2,))
        pos = positions[torch.tensor(ids, device=positions.device)]
        angle = pos.to(torch.float32).permute(1, 2, 0) * freqs  # [B, S, hd/2]
    else:
        angle = positions.to(torch.float32)[..., None] * freqs  # [B, S, hd/2]
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
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()
    causal: bool = True

    @property
    def q_dim(self):
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.num_kv_heads * self.head_dim


def init_attn(key: Tensor, spec: AttnSpec) -> dict:
    ks = prng.split(key, 4)
    p = {
        "wq": init_dense(ks[..., 0, :], spec.d_model, spec.q_dim),
        "wk": init_dense(ks[..., 1, :], spec.d_model, spec.kv_dim),
        "wv": init_dense(ks[..., 2, :], spec.d_model, spec.kv_dim),
        "wo": init_dense(ks[..., 3, :], spec.q_dim, spec.d_model),
    }
    if spec.qk_norm:
        ones = key.shape[:-1] + (spec.head_dim,)
        p["q_norm"] = torch.ones(ones, dtype=torch.float32, device=key.device)
        p["k_norm"] = torch.ones(ones, dtype=torch.float32, device=key.device)
    return p


def _qkv(params, spec: AttnSpec, x: Tensor, positions, tape: QTape,
         prefix: str):
    B, S, _ = x.shape
    q = tape.dot(f"{prefix}/wq", x, params["wq"]).reshape(
        B, S, spec.num_heads, spec.head_dim)
    k = tape.dot(f"{prefix}/wk", x, params["wk"]).reshape(
        B, S, spec.num_kv_heads, spec.head_dim)
    v = tape.dot(f"{prefix}/wv", x, params["wv"]).reshape(
        B, S, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    q = apply_rope(q, positions, spec.rope_theta, spec.mrope_sections)
    k = apply_rope(k, positions, spec.rope_theta, spec.mrope_sections)
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


def _first_stream(positions: Tensor) -> Tensor:
    """The positions the masks compare: M-RoPE's temporal stream."""
    return positions if positions.ndim == 2 else positions[0]


def attention_train(params, spec: AttnSpec, x: Tensor, positions: Tensor,
                    tape: QTape, prefix: str, window=None,
                    kv_source: Optional[Tensor] = None,
                    kv_positions: Optional[Tensor] = None) -> Tensor:
    """Training-path attention (naive masked scores): ``x`` [B, S, D] at
    ``positions`` [B, S] (or M-RoPE's [3, B, S]); ``wo`` through
    ``tape.dot`` and the ``out`` site, as the reference's.  The q·k and
    p·v products are plain ``einsum``s, as the reference leaves them to
    XLA.

    ``kv_source`` [B, Sk, D] makes it cross-attention: q from ``x``, k
    and v from ``kv_source`` (the ``qkv``, ``k`` and ``v`` sites), no
    RoPE and no causal mask, keys at ``kv_positions`` (default
    ``arange(Sk)``)."""
    B, S, _ = x.shape
    if kv_source is None:
        q, k, v = _qkv(params, spec, x, positions, tape, prefix)
        k_pos, causal = positions, spec.causal
    else:
        Sk = kv_source.shape[1]
        q = tape.dot(f"{prefix}/wq", x, params["wq"]).reshape(
            B, S, spec.num_heads, spec.head_dim)
        k = tape.dot(f"{prefix}/wk", kv_source, params["wk"]).reshape(
            B, Sk, spec.num_kv_heads, spec.head_dim)
        v = tape.dot(f"{prefix}/wv", kv_source, params["wv"]).reshape(
            B, Sk, spec.num_kv_heads, spec.head_dim)
        q = tape.act(f"{prefix}/qkv", q)
        k = tape.act(f"{prefix}/k", k)
        v = tape.act(f"{prefix}/v", v)
        k_pos = kv_positions
        if k_pos is None:
            k_pos = torch.arange(Sk, device=x.device).expand(B, Sk)
        causal = False
    mask = _mask(_first_stream(positions), _first_stream(k_pos), window,
                 causal)
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
    q_pos = _first_stream(positions)

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


class KVShard:
    """Where a serve pool's storage is one rank's shard of the whole.

    ``tp_axis`` names the mesh axis the kv heads are sharded over (the
    attention wrappers' :func:`~repro_torch.kernels.attn.ops.tp_shard`
    guard decides whether they are); ``cp_axis`` the axis a slot-major
    ring's window is sharded over (context parallelism).  A codec is
    handed full-head, whole-window values — every rank computes the same
    K/V from replicated weights — quantizes them whole, so exponents and
    §5 counters are the global ones on every rank without a collective,
    and stores only its shard.  With neither axis set (or no ambient
    mesh) the shard is the whole pool.
    """

    tp_axis: Optional[str] = None
    cp_axis: Optional[str] = None
    _fused_decode: bool = False

    @property
    def fused_decode(self) -> bool:
        """Whether decode and chunked prefill attention run the flash
        kernels on this codec's storage (set by the pool factory)."""
        return self._fused_decode

    def local_heads(self, x: Tensor, dim: int) -> Tensor:
        """This rank's kv heads of ``x`` (all ``K`` heads on ``dim``)."""
        return attn_ops.local_heads(x, self.tp_axis, dim)

    def head_shard(self, n_kv_heads: int):
        """``(tp, index)`` of the kv-head sharding, ``(0, 0)`` if none."""
        return attn_ops.tp_shard(self.tp_axis, n_kv_heads)

    def window_shard(self, w_local: int):
        """``(W, w0)``: the whole ring window and the first slot of this
        rank's ``w_local`` slots (``(w_local, 0)`` when unsharded)."""
        if not self.cp_axis:
            return w_local, 0
        from repro_torch.launch.mesh import ambient_mesh
        mesh = ambient_mesh()
        if mesh is None or self.cp_axis not in mesh.shape:
            return w_local, 0
        n = mesh.axis_size(self.cp_axis)
        return w_local * n, mesh.axis_index(self.cp_axis) * w_local

    def local_slots(self, slot: Tensor, w_local: int) -> Tensor:
        """Ring slots ``slot`` of the whole window (``W`` = dropped) as
        slots of this rank's shard; a slot held elsewhere drops
        (``w_local``)."""
        W, w0 = self.window_shard(w_local)
        if W == w_local:
            return slot
        mine = (slot >= w0) & (slot < w0 + w_local)
        return torch.where(mine, slot - w0, w_local)

    def gather_window(self, entry: dict) -> dict:
        """``entry`` with its window-sharded leaves (storage and ``pos``)
        gathered whole over ``cp_axis``: the attention paths that see the
        whole window (chunked prefill, windowed layers).  ``entry``
        itself when the window is not sharded."""
        W, _ = self.window_shard(entry["pos"].shape[1])
        if W == entry["pos"].shape[1]:
            return entry
        from repro_torch.launch.mesh import ambient_mesh
        mesh = ambient_mesh()
        out = dict(entry)
        names = ("k_m", "v_m") if "k_m" in entry else ("k", "v")
        for n in names + ("pos",):
            out[n] = mesh.all_gather(entry[n], self.cp_axis, dim=1)
        return out


class RawKVCodec(KVShard):
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

    def __init__(self, fused_decode: bool = False, *,
                 tp_axis: Optional[str] = None,
                 cp_axis: Optional[str] = None):
        self._fused_decode = bool(fused_decode)
        self.tp_axis, self.cp_axis = tp_axis, cp_axis

    def append(self, entry: dict, k_new: Tensor, v_new: Tensor,
               pos: Tensor, mask: Optional[Tensor] = None) -> dict:
        """``k_new``/``v_new``: [B, K, hd]; ``pos``: [B] int32.  ``mask``
        (bool [B]) drops the append for masked-off rows entirely."""
        Wl = entry["k"].shape[1]
        W, _ = self.window_shard(Wl)
        slot = pos % W
        if mask is not None:
            slot = torch.where(mask, slot, W)
        slot = self.local_slots(slot, Wl)[:, None]
        k_new, v_new = self.local_heads(k_new, 1), self.local_heads(v_new, 1)
        return {"k": scatter_drop(entry["k"], slot, k_new[:, None]),
                "v": scatter_drop(entry["v"], slot, v_new[:, None]),
                "pos": scatter_drop(entry["pos"], slot, pos[:, None])}

    def append_chunk(self, entry: dict, k_new: Tensor, v_new: Tensor,
                     p0: Tensor, n_valid: Tensor) -> dict:
        """Write a prefill chunk's K/V ``[B, C, K, hd]`` at positions
        ``p0 + i``; ``p0 == 0`` (admission) first resets the slot's stale
        ring positions to -1."""
        Wl = entry["k"].shape[1]
        W, _ = self.window_shard(Wl)
        pos, _, slot = chunk_slots(p0, n_valid, k_new.shape[1], W)
        slot = self.local_slots(slot, Wl)
        k_new, v_new = self.local_heads(k_new, 2), self.local_heads(v_new, 2)
        pos_buf = torch.where((p0 == 0)[:, None], -1, entry["pos"])
        return {"k": scatter_drop(entry["k"], slot, k_new),
                "v": scatter_drop(entry["v"], slot, v_new),
                "pos": scatter_drop(pos_buf, slot, pos)}

    def load(self, entry: dict):
        return entry["k"], entry["v"], entry["pos"]

    def fused_attention(self, entry: dict, qg: Tensor, q_pos: Tensor, *,
                        scale: float, window=None, causal: bool = True):
        """Flash-decode (K3) on the raw f32 ring (``width=None``); ``qg``
        holds every kv head, the result this rank's."""
        return attn_ops.flash_decode(qg, entry["k"], entry["v"],
                                     entry["pos"], q_pos, width=None,
                                     scale=scale, window=window,
                                     causal=causal, tp_axis=self.tp_axis)

    def fused_prefill(self, entry: dict, qg: Tensor, k_new: Tensor,
                      v_new: Tensor, p0: Tensor, n_valid: Tensor, *,
                      scale: float, window=None, causal: bool = True):
        """Flash-prefill (K4) on the raw f32 ring (``width=None``)."""
        return attn_ops.flash_prefill(qg, k_new, v_new, entry["k"],
                                      entry["v"], entry["pos"], p0, n_valid,
                                      width=None, scale=scale, window=window,
                                      causal=causal, tp_axis=self.tp_axis)


RAW_KV_CODEC = RawKVCodec()


def _replicate_attn_out(o: Tensor, codec, n_kv_heads: int) -> Tensor:
    """The per-head attention output ``o`` [B, S, Kl·G·hd] of this rank's
    kv heads gathered whole over the TP axis, before the ``wo``
    contraction.

    Under serving tensor parallelism the pool — and so the per-head
    attention output — is sharded over kv heads, while ``wo`` contracts
    over the *full* head dimension.  Gathering here keeps that
    contraction replicated and in one rank's order, which is what makes
    the sharded engine's logits bit-identical to one process's (per-head
    attention is shard-local and exact; this is the only cross-head
    reduction).  The identity when the heads are not sharded.
    """
    tp, _ = attn_ops.tp_shard(getattr(codec, "tp_axis", None), n_kv_heads)
    if not tp:
        return o
    from repro_torch.launch.mesh import ambient_mesh
    return ambient_mesh().all_gather(o, codec.tp_axis, dim=-1)


def attention_prefill_chunk(params, spec: AttnSpec, x: Tensor,
                            positions: Tensor, cache: dict, tape: QTape,
                            prefix: str, *, n_valid: Tensor, window=None,
                            dist=None, codec=None):
    """One chunked-prefill step: ``C`` prompt positions against the pool.

    ``x``: [B, C, D] at absolute positions ``positions`` [B, C]
    (``positions[:, 0]`` is the chunk start ``p0``; ``p0 == 0`` marks the
    admission chunk).  ``n_valid`` [B] masks a ragged final chunk.  The
    chunk attends the slot's history (``0 <= pos < p0``) plus its own
    fresh K/V causally, *before* ``codec.append_chunk`` writes the chunk
    into the pool.  On a sharded pool the attention runs on this rank's
    kv heads over the whole window (a window-sharded ring is gathered
    first) and the heads are gathered before ``wo``.  Returns
    ``(y, cache')``.
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
    view = codec.gather_window(cache)
    if codec.fused_decode:
        o = codec.fused_prefill(view, qg, kf, vf, p0, n_valid, scale=scale,
                                window=window, causal=spec.causal)
    else:
        ck, cv, cpos = codec.load(view)
        o = AR.chunk_attend(codec.local_heads(qg, 2), ck.to(torch.float32),
                            cv.to(torch.float32), cpos,
                            codec.local_heads(kf, 2),
                            codec.local_heads(vf, 2), p0, n_valid,
                            scale=scale, window=window, causal=spec.causal)
    cache = codec.append_chunk(cache, kf, vf, p0, n_valid)
    o = _replicate_attn_out(o.reshape(B, C, -1), codec, K).to(x.dtype)
    y = tape.dot(f"{prefix}/wo", o, params["wo"])
    return tape.act(f"{prefix}/out", y), cache


def attention_decode(params, spec: AttnSpec, x: Tensor, positions: Tensor,
                     cache: dict, tape: QTape, prefix: str, window=None,
                     dist=None, codec=None, append_mask=None):
    """One-token decode. ``x``: [B, 1, D] at ``positions`` int32 [B, 1]
    (every slot decodes at its own position); ``cache``: a codec-owned
    entry.

    Appends the new token's K/V through the codec (slot ``pos % W``, so
    the token attends to itself), then attends over the whole ring with a
    position-validity mask.  ``append_mask`` (bool [B]) drops the append
    for masked-off rows.  With ``codec.fused_decode`` the attention is the
    flash-decode kernel on the codec's storage; otherwise ``codec.load``
    and the plain softmax.

    With ``dist.cp_decode`` (the ring window sharded over
    ``dist.cp_axis``) the global-attention layers run
    :func:`repro_torch.dist.cp_attention.cp_decode_attention` on this
    rank's slots and merge the softmax statistics exactly; windowed
    layers gather the ring first.  On a head-sharded pool the attention
    runs on this rank's kv heads and :func:`_replicate_attn_out` gathers
    them before ``wo``.  Returns ``(y, cache')``.
    """
    codec = codec or RAW_KV_CODEC
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, spec, x, positions, tape, prefix)
    q_pos = positions[:, 0].contiguous()
    cache = codec.append(cache, k_new[:, 0], v_new[:, 0], q_pos,
                         mask=append_mask)
    H, K, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    G = H // K
    scale = 1.0 / math.sqrt(hd)

    if (dist is not None and dist.active and dist.cp_decode and dist.cp_axis
            and window is None):
        from repro_torch.dist.cp_attention import cp_decode_attention
        cache_k, cache_v, cache_pos = codec.load(cache)
        qh = codec.local_heads(q.reshape(B, 1, K, G, hd), 2)
        Kl = qh.shape[2]
        o = cp_decode_attention(qh.reshape(B, 1, Kl * G, hd), cache_k,
                                cache_v, cache_pos, positions,
                                num_heads=Kl * G, num_kv_heads=Kl,
                                head_dim=hd, cp_axes=dist.cp_axes,
                                local=codec.cp_axis == dist.cp_axis)
    else:
        view = codec.gather_window(cache)
        if codec.fused_decode:
            qg = q.reshape(B, K, G, hd).to(torch.float32)
            o = codec.fused_attention(view, qg, q_pos, scale=scale,
                                      window=window, causal=spec.causal)
        else:
            cache_k, cache_v, cache_pos = codec.load(view)
            qg = codec.local_heads(q.reshape(B, 1, K, G, hd), 2)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k) * scale
            valid = _mask(positions, cache_pos, window, spec.causal)
            valid = valid & (cache_pos >= 0)[:, None, :]          # -1 = empty
            s = torch.where(valid[:, None, None], s, -1e30)
            p = torch.softmax(s.to(torch.float32), dim=-1)
            o = torch.einsum("bkgqs,bskh->bqkgh", p,
                             cache_v.to(torch.float32))
    o = _replicate_attn_out(o.reshape(B, 1, -1), codec, K).to(x.dtype)
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


def init_gelu_ffn(key: Tensor, d_model: int, d_ff: int) -> dict:
    ks = prng.split(key, 2)
    lead = key.shape[:-1]
    return {"w_in": init_dense(ks[..., 0, :], d_model, d_ff),
            "w_out": init_dense(ks[..., 1, :], d_ff, d_model),
            "b_in": torch.zeros(lead + (d_ff,), device=key.device),
            "b_out": torch.zeros(lead + (d_model,), device=key.device)}


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, in its formula:
    ``x * (1 + tanh(sqrt(2/pi) (x + 0.044715 x**3))) / 2`` (``F.gelu``
    defaults to the erf form)."""
    c = float(np.float32(math.sqrt(2.0 / math.pi)))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3)))))


def gelu_ffn(params, x: Tensor, tape: QTape, prefix: str) -> Tensor:
    h = tape.dot(f"{prefix}/w_in", x, params["w_in"]) + params["b_in"]
    h = tape.act(f"{prefix}/pre", gelu(h))
    y = tape.dot(f"{prefix}/w_out", h, params["w_out"]) + params["b_out"]
    return tape.act(f"{prefix}/out", y)


def init_maxout(key: Tensor, d_in: int, d_out: int, k: int) -> dict:
    """Maxout unit (paper §2): max over ``k`` affine maps; the
    reference's ``split(key, 1)`` draw."""
    kw = prng.split(key, 1)[..., 0, :]
    lead = key.shape[:-1]
    w = prng.normal_blocked(kw, (k, d_in, d_out)).div_(
        float(np.float32(math.sqrt(d_in))))
    return {"w": w, "b": torch.zeros(lead + (k, d_out), device=key.device)}


def maxout(params, x: Tensor, tape: QTape, prefix: str) -> Tensor:
    """``h_i = max_j (b_ij + w_ij · x)``, the paper's hidden unit: the
    ``k`` affine maps as one ``[d_in, k·d_out]`` product, then the max."""
    k, d_in, d_out = params["w"].shape
    w2 = params["w"].permute(1, 0, 2).reshape(d_in, k * d_out)
    b2 = params["b"].reshape(k * d_out)
    z = tape.dot(f"{prefix}/w", x, w2) + b2
    h = torch.amax(z.reshape(z.shape[:-1] + (k, d_out)), dim=-2)
    return tape.act(f"{prefix}/out", h)


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
