"""The port's LM: ``repro.models.transformer``, decoders and encoder-decoder.

A model is a sequence of **stages**; each stage repeats a *super-block*
(an ordered tuple of sub-blocks) ``count`` times over layer-stacked
parameters ``[count, ...]``.  The reference's ``lax.scan`` over layers is
a Python loop here that stacks each layer's statistics.  Every family of
the reference:

  * dense (llama3/qwen3/phi3, the example's LM_100M): ``(attn, ffn) × L``;
  * gemma3's 5:1 local:global: ``5×(windowed attn, ffn) + (attn, ffn)``
    repeated, the remainder a ``dec_tail`` stage of local layers; local
    layers take their own RoPE theta;
  * MoE (granite every layer, llama4 every 2nd): ``(attn, ffn|moe)``;
  * SSM (mamba2): ``(mamba,) × L``;
  * hybrid (zamba2): ``N×mamba + shared attn + shared ffn``, the shared
    blocks' weights stored once (``"shared"``), a ``dec_tail`` of mamba;
  * encoder-decoder (seamless): an ``enc`` stage ``(attn non-causal,
    ffn)`` over ``src_embeds``, then ``(attn, xattn, ffn)`` decoder
    layers whose cross-attention reads the normed encoder output;
  * embeds input (qwen2-vl): ``embeds`` [B, S, D] in place of tokens,
    an untied head, M-RoPE's three position streams ``[3, B, S]``.

Parameters keep the reference's pytree: ``{"stages": {"dec": {"stacked":
{"0:attn": {...}, "1:ffn": {...}}, "shared": {...}}}, "embed", "head",
"final_norm", "enc_norm"}`` with ``[count, d_in, d_out]`` weights (no
``head`` when the embeddings are tied: the head contracts against the
table; no ``embed`` for an embeds-input model), so
:func:`repro_torch.models.convert.params_from_jax` is a leaf-for-leaf
copy, and :func:`init_params` draws the reference's numbers from the
same threefry key.  Caches keep the reference's ``[n_layer, B, ...]``
layout too.

Training: :func:`forward` in ``train``/``hidden`` mode and
:func:`loss_fn` (mean cross-entropy, optionally over sequence chunks
recomputed in the backward, ``torch.utils.checkpoint`` for the
reference's ``jax.checkpoint``) take the per-site gradient-statistics
sinks of :mod:`repro_torch.core.quant`, and the reference's ``remat``
(each layer recomputed in the backward, saving nothing or the matrix
products' outputs).

The serving entry points (:func:`prefill`, :func:`decode_step`,
:func:`prefill_chunk_step`) update the cache they are given **in
place**, layer by layer, and return it: the port's counterpart of the
reference's donated pool, which keeps one copy of the pool resident.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quant import qbound_site
from repro_torch.core.tape import QTape

from . import layers as L
from . import moe as M
from . import ssm as S

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` (``transformer.py:47-107``), field
    for field."""

    name: str = "model"
    family: str = "dense"          # dense|moe|ssm|hybrid|encdec
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    # attention variants
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()
    window: int = 0                # >0: sliding window for local layers
    local_global_pattern: int = 0  # N: N local then 1 global (gemma3: 5)
    local_rope_theta: float = 1e4  # theta for local (windowed) layers
    embed_scale: bool = False      # multiply embeds by sqrt(d_model) (gemma)
    # ffn
    ffn_kind: str = "swiglu"       # swiglu|gelu|maxout
    maxout_k: int = 2
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1            # MoE every k-th layer (llama4: 2)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    hybrid_period: int = 0         # zamba2: shared attn+ffn every N mamba
    # enc-dec
    encoder_layers: int = 0
    # io
    input_mode: str = "tokens"     # tokens|embeds
    tie_embeddings: bool = True

    @property
    def attn_spec(self) -> L.AttnSpec:
        return L.AttnSpec(self.d_model, self.num_heads, self.num_kv_heads,
                          self.head_dim, qk_norm=self.qk_norm,
                          rope_theta=self.rope_theta,
                          mrope_sections=self.mrope_sections)

    @property
    def tied(self) -> bool:
        """The head contracts against the embedding table."""
        return self.tie_embeddings and self.input_mode == "tokens"

    @property
    def ssm_spec(self) -> S.SSMSpec:
        return S.SSMSpec(self.d_model, self.ssm_state, self.ssm_headdim,
                         self.ssm_expand, chunk=self.ssm_chunk)

    @property
    def moe_spec(self) -> M.MoESpec:
        return M.MoESpec(self.d_model, self.moe_d_ff or self.d_ff,
                         self.num_experts, self.top_k,
                         capacity_factor=self.capacity_factor,
                         shared_expert_d_ff=self.d_ff if self.shared_expert
                         else 0)


@dataclasses.dataclass(frozen=True)
class SubBlock:
    kind: str                      # attn|xattn|ffn|moe|mamba
    window: int = 0                # 0 = global
    shared: bool = False           # one weight for every repetition
    causal: bool = True
    rope_theta: float = 0.0        # 0 → cfg.rope_theta


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    count: int
    blocks: Tuple[SubBlock, ...]
    decoder: bool = True           # runs on the decode path


def build_stages(cfg: ModelConfig) -> Tuple[Stage, ...]:
    """The reference's stages (``transformer.py:125-168``)."""
    stages = []
    if cfg.encoder_layers:
        stages.append(Stage("enc", cfg.encoder_layers,
                            (SubBlock("attn", causal=False),
                             SubBlock("ffn")), decoder=False))
    Ld = cfg.num_layers
    if cfg.family == "ssm":
        stages.append(Stage("dec", Ld, (SubBlock("mamba"),)))
    elif cfg.family == "hybrid":
        p = cfg.hybrid_period or 6
        reps, rem = divmod(Ld, p)
        blocks = tuple(SubBlock("mamba") for _ in range(p)) + (
            SubBlock("attn", shared=True), SubBlock("ffn", shared=True))
        stages.append(Stage("dec", reps, blocks))
        if rem:
            stages.append(Stage("dec_tail", 1,
                                tuple(SubBlock("mamba") for _ in range(rem))))
    elif cfg.local_global_pattern:
        n = cfg.local_global_pattern
        reps, rem = divmod(Ld, n + 1)
        local = (SubBlock("attn", window=cfg.window,
                          rope_theta=cfg.local_rope_theta), SubBlock("ffn"))
        glob = (SubBlock("attn"), SubBlock("ffn"))
        stages.append(Stage("dec", reps, local * n + glob))
        if rem:
            stages.append(Stage("dec_tail", 1, local * rem))
    elif cfg.num_experts:
        p = cfg.moe_period
        reps, rem = divmod(Ld, p)
        blocks = []
        for i in range(p):
            blocks.append(SubBlock("attn"))
            blocks.append(SubBlock("moe" if i == p - 1 else "ffn"))
        stages.append(Stage("dec", reps, tuple(blocks)))
        assert rem == 0, "num_layers must divide moe_period"
    else:
        blocks = [SubBlock("attn", window=cfg.window)]
        if cfg.encoder_layers:
            blocks.append(SubBlock("xattn"))
        blocks.append(SubBlock("ffn"))
        stages.append(Stage("dec", Ld, tuple(blocks)))
    return tuple(stages)


def _block_attn_spec(cfg: ModelConfig, blk: SubBlock) -> L.AttnSpec:
    spec = cfg.attn_spec
    if blk.rope_theta:
        spec = dataclasses.replace(spec, rope_theta=blk.rope_theta)
    if not blk.causal:
        spec = dataclasses.replace(spec, causal=False)
    return spec


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_block(key: Tensor, cfg: ModelConfig, blk: SubBlock) -> dict:
    """One sub-block's parameters from ``key`` (a batch ``[count, 2]``
    draws the stacked layers, one key each; a shared block one key)."""
    p = {"norm": torch.ones(key.shape[:-1] + (cfg.d_model,),
                            dtype=torch.float32, device=key.device)}
    if blk.kind in ("attn", "xattn"):
        p.update(L.init_attn(key, _block_attn_spec(cfg, blk)))
    elif blk.kind == "ffn":
        if cfg.ffn_kind == "swiglu":
            p.update(L.init_swiglu(key, cfg.d_model, cfg.d_ff))
        elif cfg.ffn_kind == "gelu":
            p.update(L.init_gelu_ffn(key, cfg.d_model, cfg.d_ff))
        else:
            p.update(L.init_maxout(key, cfg.d_model, cfg.d_ff, cfg.maxout_k))
    elif blk.kind == "moe":
        p.update(M.init_moe(key, cfg.moe_spec))
    elif blk.kind == "mamba":
        p.update(S.init_ssm(key, cfg.ssm_spec))
    else:
        raise ValueError(blk.kind)
    return p


def init_params(cfg: ModelConfig, key=0, *, device="cuda") -> dict:
    """The reference's initial parameters (``transformer.py:198-222``),
    drawn on ``device`` from the threefry ``key`` (an int is
    ``PRNGKey(int)``) with the reference's key tree: ``split`` into
    ``len(stages) + 3`` keys, ``fold_in(keys[stage], i)`` per sub-block,
    ``split`` over its stacked layers (a shared block takes the folded
    key itself); the embedding (token input only) from ``keys[-3]``, an
    untied head from ``keys[-2]``.

    Each leaf is drawn where it lives and large ones in row blocks
    (:func:`prng.normal_blocked`), so a full-width model never exists on
    the host and the draw's temporaries stay small; ``device="meta"``
    gives the shapes alone."""
    key = prng.as_key(key, resolve_device(device))
    stages = build_stages(cfg)
    keys = prng.split(key, len(stages) + 3)
    params: dict = {"stages": {}}
    for si, stage in enumerate(stages):
        stacked, shared = {}, {}
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            k = prng.fold_in(keys[si], i)
            if blk.shared:
                shared[bkey] = _init_block(k, cfg, blk)
            else:
                stacked[bkey] = _init_block(prng.split(k, stage.count), cfg,
                                            blk)
        params["stages"][stage.name] = {"stacked": stacked, "shared": shared}
    if cfg.input_mode == "tokens":
        params["embed"] = L.init_embed(keys[-3], cfg.vocab_size, cfg.d_model)
    if not cfg.tied:
        params["head"] = L.init_dense(keys[-2], cfg.d_model, cfg.vocab_size,
                                      scale=0.02)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                      device=key.device)
    if cfg.encoder_layers:
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                        device=key.device)
    return params


# ---------------------------------------------------------------------------
# quantization groups
# ---------------------------------------------------------------------------

_SITES = {
    "attn": (("wq", "wk", "wv", "wo"), ("qkv", "k", "v", "out", "res")),
    "xattn": (("wq", "wk", "wv", "wo"), ("qkv", "k", "v", "out", "res")),
    "ffn": {
        "swiglu": (("w_gate", "w_up", "w_down"), ("pre", "out", "res")),
        "gelu": (("w_in", "w_out"), ("pre", "out", "res")),
        "maxout": (("w",), ("out", "res")),
    },
    "moe": (("w_gate", "w_up", "w_down"),
            ("dispatch", "pre", "expert_out", "out", "res")),
    "mamba": (("in_proj", "out_proj"), ("x", "y", "out", "state", "res")),
}


def block_sites(cfg: ModelConfig, blk: SubBlock):
    """``(weight sites, activation sites)`` of a sub-block: the names of
    its matrix weights (its quantization groups ``w:``) and of the
    tensors it quantizes (``a:``), the shared expert's included."""
    if blk.kind == "ffn":
        w, a = _SITES["ffn"][cfg.ffn_kind]
    else:
        w, a = _SITES[blk.kind]
    if blk.kind == "moe" and cfg.shared_expert:
        w = w + ("shared/w_gate", "shared/w_up", "shared/w_down")
        a = a + ("shared/pre", "shared/out")
    return w, a


def group_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """All quantization scale groups and their shapes: ``(count,)`` for a
    stacked sub-block, ``()`` for a shared one and the embed/head sites.

    The same names and shapes as the reference, ``g:`` gradient groups
    included, so a scale state carries over between the packages."""
    groups: Dict[str, tuple] = {}
    for stage in build_stages(cfg):
        for i, blk in enumerate(stage.blocks):
            pfx = f"{stage.name}/{i}:{blk.kind}"
            shape = () if blk.shared else (stage.count,)
            w_sites, a_sites = block_sites(cfg, blk)
            for s in w_sites:
                groups[f"w:{pfx}/{s}"] = shape
            for s in a_sites:
                groups[f"a:{pfx}/{s}"] = shape
                groups[f"g:{pfx}/{s}"] = shape
    if cfg.input_mode == "tokens":
        groups["w:emb/w"] = ()
    for g in ("a:emb/out", "g:emb/out", "w:head/w", "a:head/logits",
              "g:head/logits"):
        groups[g] = ()
    return groups


def _stage_group_names(cfg: ModelConfig, stage: Stage, shared: bool):
    names = []
    for i, blk in enumerate(stage.blocks):
        if blk.shared != shared:
            continue
        pfx = f"{stage.name}/{i}:{blk.kind}"
        w_sites, a_sites = block_sites(cfg, blk)
        names += [f"w:{pfx}/{s}" for s in w_sites]
        for s in a_sites:
            names += [f"a:{pfx}/{s}", f"g:{pfx}/{s}"]
    return names


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ring_cache(k: Tensor, v: Tensor, cap: int) -> dict:
    """Pack full-sequence KV [B,S,K,hd] into a ring buffer of ``cap`` slots."""
    B, S = k.shape[:2]
    n_keep = min(S, cap)
    pos_keep = torch.arange(S - n_keep, S, device=k.device)
    slots = pos_keep % cap
    shape = (B, cap) + tuple(k.shape[2:])
    ck = torch.zeros(shape, dtype=k.dtype, device=k.device)
    cv = torch.zeros(shape, dtype=v.dtype, device=v.device)
    ck[:, slots] = k[:, S - n_keep:]
    cv[:, slots] = v[:, S - n_keep:]
    cpos = torch.full((B, cap), -1, dtype=torch.int32, device=k.device)
    cpos[:, slots] = pos_keep.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


def _apply_block(cfg: ModelConfig, blk: SubBlock, pfx: str, bp, x,
                 positions, tape: QTape, mode: str, cache_in=None,
                 max_cache_len: int = 0, kv_codec=None, n_valid=None,
                 append_mask=None, memory=None, dist=None):
    """Apply one sub-block (pre-norm residual). Returns (x, cache_out).

    ``memory`` is the encoder's normed output, which an ``xattn`` block
    attends; its decode cache is static, written once at prefill (so
    decode returns no new entry for it)."""
    h = L.rmsnorm(x, bp["norm"])
    cache_out = None
    window = blk.window if blk.window > 0 else None
    if mode == "chunk" and blk.kind not in ("attn", "ffn"):
        # chunked prefill is attention-family only: MoE capacity and SSM
        # state couple a whole prompt (the engine keeps those on the
        # whole-prompt path), and xattn needs an encoder pass
        raise ValueError(f"chunked prefill does not support {blk.kind!r}")
    if blk.kind == "xattn":
        spec = _block_attn_spec(cfg, blk)
        if mode == "decode":
            y = _xattn_decode(bp, spec, h, cache_in, tape, pfx)
        else:
            y = L.attention_train(bp, spec, h, positions, tape, pfx,
                                  window=window, kv_source=memory)
        if mode == "prefill":
            # the cross-attention KV is static over decode: cache it once
            # (the reference computes wk/wv of memory a second time here,
            # so their weight sites record twice at prefill)
            B, Sk = memory.shape[:2]
            K, hd = spec.num_kv_heads, spec.head_dim
            cache_out = {
                "k": tape.dot(f"{pfx}/wk", memory, bp["wk"]).reshape(
                    B, Sk, K, hd),
                "v": tape.dot(f"{pfx}/wv", memory, bp["wv"]).reshape(
                    B, Sk, K, hd)}
    elif blk.kind == "attn":
        spec = _block_attn_spec(cfg, blk)
        if mode == "train":
            y = L.attention_train(bp, spec, h, positions, tape, pfx,
                                  window=window)
        elif mode == "prefill":
            y, (k, v) = L.attention_prefill(bp, spec, h, positions, tape,
                                            pfx, window=window)
            cap = min(window, max_cache_len) if window else max_cache_len
            cache_out = _ring_cache(k, v, cap)
        elif mode == "chunk":
            y, cache_out = L.attention_prefill_chunk(
                bp, spec, h, positions, cache_in, tape, pfx,
                n_valid=n_valid, window=window, dist=dist, codec=kv_codec)
        else:  # decode
            y, cache_out = L.attention_decode(
                bp, spec, h, positions, cache_in, tape, pfx, window=window,
                dist=dist, codec=kv_codec, append_mask=append_mask)
    elif blk.kind == "ffn":
        if cfg.ffn_kind == "swiglu":
            y = L.swiglu(bp, h, tape, pfx)
        elif cfg.ffn_kind == "gelu":
            y = L.gelu_ffn(bp, h, tape, pfx)
        else:
            y = L.maxout(bp, h, tape, pfx)
    elif blk.kind == "moe":
        y = M.moe_ffn(bp, cfg.moe_spec, h, tape, pfx, dist,
                      dropless=(mode == "decode"))
    elif blk.kind == "mamba":
        if mode == "decode":
            y, cache_out = S.ssm_decode(bp, cfg.ssm_spec, h, cache_in, tape,
                                        pfx)
        else:
            y, cache_out = S.ssm_forward(bp, cfg.ssm_spec, h, tape, pfx,
                                         return_cache=(mode == "prefill"))
    else:
        raise ValueError(blk.kind)
    x = x + y.to(x.dtype)
    x = tape.act(f"{pfx}/res", x)
    return x, cache_out


def _xattn_decode(bp, spec: L.AttnSpec, h: Tensor, cache: dict,
                  tape: QTape, pfx: str) -> Tensor:
    """Cross-attention of one decode token against the static cache
    (reference ``transformer.py:393-409``): plain einsums, the scale as a
    division by ``sqrt(hd)``, and of the activation sites only ``out``."""
    B = h.shape[0]
    K, hd = spec.num_kv_heads, spec.head_dim
    q = tape.dot(f"{pfx}/wq", h, bp["wq"])
    qg = q.reshape(B, 1, K, spec.num_heads // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, cache["k"])
    s = s / float(np.float32(math.sqrt(hd)))
    p = torch.softmax(s.to(torch.float32), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, cache["v"].to(torch.float32))
    o = o.reshape(B, 1, spec.q_dim).to(h.dtype)
    y = tape.dot(f"{pfx}/wo", o, bp["wo"])
    return tape.act(f"{pfx}/out", y)


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked dict (views, no copies)."""
    return {k: (_layer(t, i) if isinstance(t, dict) else t[i])
            for k, t in tree.items()}


def _unbind(tree, n: int):
    """The ``n`` layers of a layer-stacked dict as views, one
    ``unbind`` per leaf: under autograd the layers' gradients meet in one
    stack per leaf, not in ``n`` full-size sums."""
    if isinstance(tree, dict):
        per = {k: _unbind(t, n) for k, t in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


# the matrix products that ``remat="dots"`` keeps (``checkpoint_dots``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(remat: str) -> dict:
    """``torch.utils.checkpoint`` arguments of a ``remat`` policy: the
    reference's ``jax.checkpoint`` policies (``transformer.py:443-446``),
    ``"full"`` saving nothing (``nothing_saveable``), ``"dots"`` the
    outputs of the matrix products (``checkpoint_dots``)."""
    if remat == "full":
        return {"use_reentrant": False}
    if remat == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"remat is 'none', 'dots' or 'full', not {remat!r}")


def _run_stage(cfg, policy, stage: Stage, sp, x, positions, scales,
               mode: str, cache=None, max_cache_len: int = 0, kv_codec=None,
               n_valid=None, append_mask=None, sinks=None, memory=None,
               dist=None, remat: str = "none"):
    """Run one stage layer by layer. Returns (x, stats, cache_out).

    Decode and chunk modes write each layer's new cache entry back into
    ``cache`` in place; prefill mode builds and stacks fresh entries;
    train mode threads each layer's slice of the ``g:`` ``sinks``.
    A shared sub-block's weights, scales and sinks serve every repetition
    (its sink's gradient sums over them), and its statistics are summed
    over the repetitions, as the reference's scan does
    (``transformer.py:450-452``); its cache has one entry a repetition.

    ``remat`` (train mode): each layer runs under non-reentrant
    ``torch.utils.checkpoint`` with that policy (:func:`_remat_kwargs`)
    and is recomputed in the backward.  A layer builds its tape and
    returns its statistics, so a recomputation records nothing twice;
    the numbers are those of ``remat="none"``, bit for bit.
    """
    if remat != "none":
        remat_kw = _remat_kwargs(remat)
    names = _stage_group_names(cfg, stage, shared=False)
    shared_names = _stage_group_names(cfg, stage, shared=True)
    sinks = sinks or {}
    sc_shared = {n: scales[n] for n in shared_names if n in scales}
    sk_shared = {n: sinks[n] for n in shared_names if n in sinks}
    per_layer_stats = []
    fresh: Dict[str, list] = {}
    layers = _unbind(sp["stacked"], stage.count)
    sk_names = [n for n in names if n in sinks]
    sk_layers = {n: sinks[n].unbind(0) for n in sk_names}

    def layer(li: int, x: Tensor):
        """Layer ``li``: ``(x, stats, {bkey: fresh cache entry})``."""
        sc = {n: scales[n][li] for n in names if n in scales}
        sc.update(sc_shared)
        sk = {n: sk_layers[n][li] for n in sk_names}
        sk.update(sk_shared)
        tape = QTape(policy, sc, sk)
        new = {}
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            ci = None
            if cache is not None and bkey in cache:
                ci = _layer(cache[bkey], li)
            bp = sp["shared"][bkey] if blk.shared else layers[li][bkey]
            x, co = _apply_block(cfg, blk, f"{stage.name}/{bkey}", bp, x,
                                 positions, tape, mode, ci,
                                 max_cache_len=max_cache_len,
                                 kv_codec=kv_codec, n_valid=n_valid,
                                 append_mask=append_mask, memory=memory,
                                 dist=dist)
            if co is None:
                continue
            if ci is None:
                new[bkey] = co
            else:
                for name, t in co.items():
                    ci[name].copy_(t)
        return x, tape.stats, new

    for li in range(stage.count):
        if remat != "none" and mode == "train":
            x, st, new = checkpoint(layer, li, x, **remat_kw)
        else:
            x, st, new = layer(li, x)
        per_layer_stats.append(st)
        for bkey, co in new.items():
            fresh.setdefault(bkey, []).append(co)
    stats = {}
    for n in (per_layer_stats[0] if per_layer_stats else ()):
        s = torch.stack([st[n] for st in per_layer_stats])
        stats[n] = s.sum(0) if n in shared_names else s
    if mode == "prefill":
        cache = {bkey: {name: torch.stack([e[name] for e in entries])
                        for name in entries[0]}
                 for bkey, entries in fresh.items()}
    return x, stats, cache


def _embed(cfg, policy, params, tokens_or_embeds, tape):
    """The decoder's input: token ids through the table, or ``embeds``
    [B, S, D] through the ``emb/out`` site."""
    if cfg.input_mode == "tokens":
        x = L.embed(params["embed"], tokens_or_embeds, tape)
    else:
        x = tape.act("emb/out", tokens_or_embeds)
    if cfg.embed_scale:
        x = x * float(np.float32(math.sqrt(cfg.d_model)))
    return x.to(getattr(torch, policy.compute_dtype))


def _positions(batch, x: Tensor) -> Tensor:
    """``batch["positions"]`` ([B, S], or M-RoPE's [3, B, S]), default
    ``arange(S)`` on every row."""
    positions = batch.get("positions")
    if positions is None:
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    return positions


def _encode(cfg, policy, params, batch, scales, sinks, stats,
            remat: str = "none"):
    """The encoder stage over ``batch["src_embeds"]`` [B, Ssrc, D] (train
    mode, also under prefill), then ``enc_norm``: the decoder's
    ``memory``, ``None`` for a decoder-only model."""
    if not cfg.encoder_layers:
        return None
    src = batch["src_embeds"]
    B, Ss = src.shape[:2]
    mpos = torch.arange(Ss, dtype=torch.int32, device=src.device).expand(B, Ss)
    memory, st, _ = _run_stage(cfg, policy, build_stages(cfg)[0],
                               params["stages"]["enc"], src, mpos, scales,
                               "train", sinks=sinks, remat=remat)
    stats.update(st)
    return L.rmsnorm(memory, params["enc_norm"])


def _head(cfg, params, x, tape):
    """Final norm and the vocabulary projection (tied: the table)."""
    x = L.rmsnorm(x, params["final_norm"])
    if cfg.tied:
        return L.lm_head(params["embed"], x, tape, tied=True)
    return L.lm_head(params["head"], x, tape, tied=False)


def decoder_stages(cfg):
    """The stages a decode step runs: all but the encoder's."""
    return [st for st in build_stages(cfg) if st.decoder]


def forward(cfg: ModelConfig, policy: PrecisionPolicy, params, batch,
            scales: Dict[str, Tensor], sinks: Dict[str, Tensor], *,
            mode: str = "train", dist=None, remat: str = "none"):
    """Full-sequence forward of the training path. Returns ``(logits
    [B, S, V], stats, None)``; ``mode="hidden"`` returns the final-normed
    hidden states instead of logits (the caller fuses head and loss).

    ``batch``: ``tokens`` [B, S] (or ``embeds`` [B, S, D] for an
    embeds-input model), optional ``positions`` ([B, S], or [3, B, S]
    for M-RoPE), and ``src_embeds`` [B, Ssrc, D] for an encoder-decoder.
    ``sinks``: the ``g:`` groups' zero sinks (``[count, 3]`` per stacked
    group), whose gradients are the backward statistics.  ``dist`` (a
    :class:`repro_torch.dist.DistCtx`) reaches the MoE blocks' expert
    parallelism, under the ambient mesh.  ``remat`` (``"none"``,
    ``"dots"``, ``"full"``) recomputes each layer in the backward
    (:func:`_run_stage`)."""
    if mode not in ("train", "hidden"):
        raise ValueError(f"forward runs the train or hidden mode, not "
                         f"{mode!r} (serving: prefill/decode_step/"
                         f"prefill_chunk_step)")
    tape = QTape(policy, scales, sinks)      # the embed and head sites
    x = _embed(cfg, policy, params, batch[
        "tokens" if cfg.input_mode == "tokens" else "embeds"], tape)
    positions = _positions(batch, x)
    stats: Dict[str, Tensor] = {}
    memory = _encode(cfg, policy, params, batch, scales, sinks, stats,
                     remat)
    for stage in decoder_stages(cfg):
        x, st, _ = _run_stage(cfg, policy, stage,
                              params["stages"][stage.name], x, positions,
                              scales, "train", sinks=sinks, memory=memory,
                              dist=dist, remat=remat)
        stats.update(st)
    if mode == "hidden":
        x = L.rmsnorm(x, params["final_norm"])
        stats.update(tape.stats)
        return x, stats, None
    logits = _head(cfg, params, x, tape)
    stats.update(tape.stats)
    return logits, stats, None


def _ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Log-likelihood of each label (``log_softmax`` in f32)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def loss_fn(cfg: ModelConfig, policy: PrecisionPolicy, params, batch,
            scales: Dict[str, Tensor], sinks: Dict[str, Tensor], *,
            ce_chunk: int = 0, dist=None, remat: str = "none"):
    """Mean cross-entropy over ``batch["labels"]`` (masked by an optional
    ``loss_mask``); returns ``(loss, stats)``.  ``remat`` as
    :func:`forward`'s.

    ``ce_chunk > 0`` computes the head product and the softmax-CE over
    sequence chunks of that many positions, each recomputed in the
    backward (``torch.utils.checkpoint``), so the ``[tokens, vocab]``
    logits never exist whole — the reference's rematerialized scan,
    with the head's ``qbound`` and statistics per chunk."""
    labels = batch["labels"]
    if not ce_chunk:
        logits, stats, _ = forward(cfg, policy, params, batch, scales, sinks,
                                   dist=dist, remat=remat)
        ll = _ce(logits, labels)
        mask = batch.get("loss_mask")
        if mask is None:
            return -ll.mean(), stats
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0), stats

    hidden, stats, _ = forward(cfg, policy, params, batch, scales, sinks,
                               mode="hidden", dist=dist, remat=remat)
    tape = QTape(policy, scales, sinks)
    table = params["embed"] if cfg.tied else params["head"]
    w = tape.weight("head/w", table).to(hidden.dtype)
    B, S, D = hidden.shape
    if S % ce_chunk:
        raise ValueError(f"ce_chunk {ce_chunk} does not divide seq {S}")
    fmt = policy.comp_format()
    a_e = scales.get("a:head/logits", 0.0)
    g_e = scales.get("g:head/logits", 0.0)
    head_sink = sinks.get("g:head/logits")

    def body(xch: Tensor, lch: Tensor):
        logits = (torch.einsum("bsd,vd->bsv", xch, w) if cfg.tied
                  else torch.einsum("bsd,dv->bsv", xch, w))
        logits, st = qbound_site(logits, fmt, fmt, a_e, g_e, head_sink,
                                 want_stats=True)
        return _ce(logits, lch).sum(), st

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    head_stats = []
    for c in range(S // ce_chunk):
        sl = slice(c * ce_chunk, (c + 1) * ce_chunk)
        part, st = checkpoint(body, hidden[:, sl], labels[:, sl],
                              use_reentrant=False)
        total = total + part
        head_stats.append(st)
    stats["a:head/logits"] = torch.stack(head_stats).sum(0)
    stats.update(tape.stats)
    return -total / (B * S), stats


def prefill(cfg: ModelConfig, policy: PrecisionPolicy, params, batch,
            scales, *, max_cache_len: int, dist=None):
    """Whole-prompt prefill: returns (last-position logits [B, V], stats,
    decode cache ``{stage: {bkey: {"k","v","pos"}}}``).  ``batch`` as
    :func:`forward`'s; an encoder-decoder's cache also holds its
    cross-attention K/V (``{"k","v"}`` over the source) and
    ``"enc_memory"``."""
    tape = QTape(policy, scales)
    x = _embed(cfg, policy, params, batch[
        "tokens" if cfg.input_mode == "tokens" else "embeds"], tape)
    positions = _positions(batch, x)
    stats: Dict[str, Tensor] = {}
    memory = _encode(cfg, policy, params, batch, scales, {}, stats)
    cache_all = {}
    for stage in decoder_stages(cfg):
        x, st, cache_out = _run_stage(cfg, policy, stage,
                                      params["stages"][stage.name], x,
                                      positions, scales, "prefill",
                                      max_cache_len=max_cache_len,
                                      memory=memory, dist=dist)
        stats.update(st)
        cache_all[stage.name] = cache_out
    # decode only needs the last position: skip the full-seq head matmul
    logits = _head(cfg, params, x[:, -1:, :], tape)
    stats.update(tape.stats)
    if memory is not None:
        cache_all["enc_memory"] = memory
    return logits[:, -1, :], stats, cache_all


def decode_step(cfg: ModelConfig, policy, params, cache, tokens, pos,
                scales, kv_codec=None, append_mask=None, *, dist=None):
    """One decoding step. ``tokens``: [B] ids, or [B, 1, D] embeds for an
    embeds-input model; ``pos``: int32 [B], each slot's own position (one
    stream: after an M-RoPE prefill all three streams advance together,
    as the reference's 2-D decode positions do).  ``append_mask`` (bool
    [B]) drops the cache append for masked-off rows.  Returns (logits
    [B, V], stats, cache) — ``cache`` updated in place."""
    tape = QTape(policy, scales)
    x = _embed(cfg, policy, params, tokens[:, None]
               if cfg.input_mode == "tokens" else tokens, tape)
    positions = pos.to(torch.int32).reshape(-1, 1)
    memory = cache.get("enc_memory") if cfg.encoder_layers else None
    stats: Dict[str, Tensor] = {}
    for stage in decoder_stages(cfg):
        x, st, _ = _run_stage(cfg, policy, stage,
                              params["stages"][stage.name], x, positions,
                              scales, "decode", cache=cache[stage.name],
                              kv_codec=kv_codec, append_mask=append_mask,
                              memory=memory, dist=dist)
        stats.update(st)
    logits = _head(cfg, params, x, tape)
    stats.update(tape.stats)
    return logits[:, -1, :], stats, cache


def prefill_chunk_step(cfg: ModelConfig, policy, params, cache, tokens, p0,
                       n_valid, scales, kv_codec=None, *, dist=None):
    """One chunked-prefill step: ``C`` prompt positions against the cache.

    ``tokens``: [B, C] ids at positions ``p0 + i``, rows ``>= n_valid``
    zero-padded.  Each layer attends the chunk against its written history
    plus the chunk's own K/V causally, then writes the chunk K/V through
    ``kv_codec``.  Returns (last-valid-position logits [B, V], stats,
    cache) — ``cache`` updated in place.  Token-in models only.
    """
    if cfg.input_mode != "tokens":
        raise ValueError("chunked prefill serves token-in models")
    tape = QTape(policy, scales)
    x = _embed(cfg, policy, params, tokens, tape)
    B, C = tokens.shape
    p0 = torch.as_tensor(p0, dtype=torch.int32, device=x.device)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=x.device)
    positions = p0[:, None] + torch.arange(C, dtype=torch.int32,
                                           device=x.device)[None, :]
    stats: Dict[str, Tensor] = {}
    for stage in decoder_stages(cfg):
        x, st, _ = _run_stage(cfg, policy, stage,
                              params["stages"][stage.name], x, positions,
                              scales, "chunk", cache=cache[stage.name],
                              kv_codec=kv_codec, n_valid=n_valid, dist=dist)
        stats.update(st)
    # only the last valid position's logits matter (first sampled token)
    idx = torch.clamp(n_valid - 1, 0, C - 1).long()
    x = x[torch.arange(B, device=x.device), idx][:, None, :]
    logits = _head(cfg, params, x, tape)
    stats.update(tape.stats)
    return logits[:, -1, :], stats, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               src_len: int = 0, device="cpu",
               dtype: torch.dtype = torch.float32) -> dict:
    """Zero decode cache for ``batch`` sequences of capacity ``max_len``:
    per attention sub-block a ring of ``min(window, max_len)`` slots
    (``max_len`` for a global one), per cross-attention sub-block the K/V
    of ``src_len`` source positions, per mamba sub-block its conv window
    and f32 state, each with a leading dim of the stage's count (a shared
    block keeps one entry a repetition); an encoder-decoder's
    ``"enc_memory"`` [batch, src_len, d_model].  ``dtype`` is the K/V,
    conv and memory storage, as the reference's (positions stay int32,
    the SSM state f32); ``device="meta"`` gives the shapes alone."""
    kw = dict(device=device, dtype=dtype)
    cache: dict = {}
    for stage in decoder_stages(cfg):
        sc: dict = {}
        n = stage.count
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            if blk.kind == "attn":
                cap = min(blk.window, max_len) if blk.window else max_len
                K, hd = cfg.num_kv_heads, cfg.head_dim
                sc[bkey] = {
                    "k": torch.zeros((n, batch, cap, K, hd), **kw),
                    "v": torch.zeros((n, batch, cap, K, hd), **kw),
                    "pos": torch.full((n, batch, cap), -1, dtype=torch.int32,
                                      device=device),
                }
            elif blk.kind == "xattn":
                K, hd = cfg.num_kv_heads, cfg.head_dim
                sc[bkey] = {
                    "k": torch.zeros((n, batch, src_len, K, hd), **kw),
                    "v": torch.zeros((n, batch, src_len, K, hd), **kw)}
            elif blk.kind == "mamba":
                s = cfg.ssm_spec
                sc[bkey] = {
                    "conv": torch.zeros((n, batch, s.conv_kernel - 1,
                                         s.conv_dim), **kw),
                    "state": torch.zeros((n, batch, s.heads, s.headdim,
                                          s.state), device=device),
                }
        cache[stage.name] = sc
    if cfg.encoder_layers:
        cache["enc_memory"] = torch.zeros((batch, src_len, cfg.d_model),
                                          **kw)
    return cache
