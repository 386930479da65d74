"""Decoder LM of the port: the dense stage of ``repro.models.transformer``.

A model is a sequence of **stages**; each stage repeats a *super-block*
(an ordered tuple of sub-blocks) ``count`` times over layer-stacked
parameters ``[count, ...]``.  The dense family (llama3/qwen3/phi3) is one
stage of ``(attn, ffn) × L``.  The reference's ``lax.scan`` over layers is
a Python loop here that stacks each layer's statistics.

Parameters keep the reference's pytree: ``{"stages": {"dec": {"stacked":
{"0:attn": {...}, "1:ffn": {...}}, "shared": {}}}, "embed", "head",
"final_norm"}`` with ``[count, d_in, d_out]`` weights, so
:func:`repro_torch.models.convert.params_from_jax` is a leaf-for-leaf
copy.  Caches keep the reference's ``[n_layer, B, ...]`` layout too.

The serving entry points (:func:`prefill`, :func:`decode_step`,
:func:`prefill_chunk_step`) update the cache they are given **in
place**, layer by layer, and return it: the port's counterpart of the
reference's donated pool, which keeps one copy of the pool resident.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.tape import QTape

from . import layers as L

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The dense-decoder fields of the reference's ``ModelConfig``."""

    name: str = "model"
    family: str = "dense"          # the port serves the dense family
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    rope_theta: float = 1e6
    window: int = 0                # >0: sliding window attention
    tie_embeddings: bool = False   # the port has untied heads only

    @property
    def attn_spec(self) -> L.AttnSpec:
        return L.AttnSpec(self.d_model, self.num_heads, self.num_kv_heads,
                          self.head_dim, rope_theta=self.rope_theta)


@dataclasses.dataclass(frozen=True)
class SubBlock:
    kind: str                      # attn|ffn
    window: int = 0                # 0 = global


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    count: int
    blocks: Tuple[SubBlock, ...]


def build_stages(cfg: ModelConfig) -> Tuple[Stage, ...]:
    """The dense branch of the reference's ``build_stages`` (swiglu FFN,
    token inputs, untied head)."""
    if cfg.family != "dense" or cfg.tie_embeddings:
        raise NotImplementedError(
            f"the port serves dense models with an untied head; "
            f"{cfg.name!r} is {cfg.family}, tied={cfg.tie_embeddings}")
    blocks = (SubBlock("attn", window=cfg.window), SubBlock("ffn"))
    return (Stage("dec", cfg.num_layers, blocks),)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, blk: SubBlock, lead, device) -> dict:
    p = {"norm": torch.ones((*lead, cfg.d_model), dtype=torch.float32,
                            device=device)}
    if blk.kind == "attn":
        p.update(L.init_attn(gen, cfg.attn_spec, lead=lead, device=device))
    else:
        p.update(L.init_swiglu(gen, cfg.d_model, cfg.d_ff, lead=lead,
                               device=device))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cpu") -> dict:
    """Random parameters drawn on ``device`` from a seeded generator.

    Same shapes and scales as the reference's ``init_params`` (different
    numbers: the generators differ; tests copy the reference's weights
    with :func:`repro_torch.models.convert.params_from_jax`).  Each leaf
    is drawn where it lives, so a full-width model never exists on the
    host; ``device="meta"`` gives the shapes alone.
    """
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    params: dict = {"stages": {}}
    for stage in build_stages(cfg):
        stacked = {f"{i}:{blk.kind}": _init_block(gen, cfg, blk,
                                                  (stage.count,), device)
                   for i, blk in enumerate(stage.blocks)}
        params["stages"][stage.name] = {"stacked": stacked, "shared": {}}
    params["embed"] = L.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                   device=device)
    params["head"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                  scale=0.02, device=device)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                      device=device)
    return params


# ---------------------------------------------------------------------------
# quantization groups
# ---------------------------------------------------------------------------

_SITES = {
    "attn": (("wq", "wk", "wv", "wo"), ("qkv", "k", "v", "out", "res")),
    "ffn": (("w_gate", "w_up", "w_down"), ("pre", "out", "res")),
}


def group_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """All quantization scale groups and their shapes (() or (count,)).

    The same names and shapes as the reference, ``g:`` gradient groups
    included, so a scale state carries over between the packages."""
    groups: Dict[str, tuple] = {}
    for stage in build_stages(cfg):
        for i, blk in enumerate(stage.blocks):
            pfx = f"{stage.name}/{i}:{blk.kind}"
            w_sites, a_sites = _SITES[blk.kind]
            for s in w_sites:
                groups[f"w:{pfx}/{s}"] = (stage.count,)
            for s in a_sites:
                groups[f"a:{pfx}/{s}"] = (stage.count,)
                groups[f"g:{pfx}/{s}"] = (stage.count,)
    groups["w:emb/w"] = ()
    for g in ("a:emb/out", "g:emb/out", "w:head/w", "a:head/logits",
              "g:head/logits"):
        groups[g] = ()
    return groups


def _stage_group_names(stage: Stage):
    names = []
    for i, blk in enumerate(stage.blocks):
        pfx = f"{stage.name}/{i}:{blk.kind}"
        w_sites, a_sites = _SITES[blk.kind]
        names += [f"w:{pfx}/{s}" for s in w_sites]
        names += [f"a:{pfx}/{s}" for s in a_sites]
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
                 append_mask=None):
    """Apply one sub-block (pre-norm residual). Returns (x, cache_out)."""
    h = L.rmsnorm(x, bp["norm"])
    cache_out = None
    window = blk.window if blk.window > 0 else None
    if blk.kind == "attn":
        spec = cfg.attn_spec
        if mode == "prefill":
            y, (k, v) = L.attention_prefill(bp, spec, h, positions, tape,
                                            pfx, window=window)
            cap = min(window, max_cache_len) if window else max_cache_len
            cache_out = _ring_cache(k, v, cap)
        elif mode == "chunk":
            y, cache_out = L.attention_prefill_chunk(
                bp, spec, h, positions, cache_in, tape, pfx,
                n_valid=n_valid, window=window, codec=kv_codec)
        else:  # decode
            y, cache_out = L.attention_decode(
                bp, spec, h, positions, cache_in, tape, pfx, window=window,
                codec=kv_codec, append_mask=append_mask)
    else:
        y = L.swiglu(bp, h, tape, pfx)
    x = x + y.to(x.dtype)
    x = tape.act(f"{pfx}/res", x)
    return x, cache_out


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked dict (views, no copies)."""
    return {k: (_layer(t, i) if isinstance(t, dict) else t[i])
            for k, t in tree.items()}


def _run_stage(cfg, policy, stage: Stage, sp, x, positions, scales,
               mode: str, cache=None, max_cache_len: int = 0, kv_codec=None,
               n_valid=None, append_mask=None):
    """Run one stage layer by layer. Returns (x, stats, cache_out).

    Decode and chunk modes write each layer's new cache entry back into
    ``cache`` in place; prefill mode builds and stacks fresh entries.
    """
    names = _stage_group_names(stage)
    per_layer_stats = []
    fresh: Dict[str, list] = {}
    for li in range(stage.count):
        sc = {n: scales[n][li] for n in names if n in scales}
        tape = QTape(policy, sc)
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            ci = None
            if cache is not None and bkey in cache:
                ci = _layer(cache[bkey], li)
            x, co = _apply_block(cfg, blk, f"{stage.name}/{bkey}",
                                 _layer(sp["stacked"][bkey], li), x,
                                 positions, tape, mode, ci,
                                 max_cache_len=max_cache_len,
                                 kv_codec=kv_codec, n_valid=n_valid,
                                 append_mask=append_mask)
            if co is None:
                continue
            if ci is None:
                fresh.setdefault(bkey, []).append(co)
            else:
                for name, t in co.items():
                    ci[name].copy_(t)
        per_layer_stats.append(tape.stats)
    stats = {n: torch.stack([s[n] for s in per_layer_stats])
             for n in per_layer_stats[0]} if per_layer_stats else {}
    if mode == "prefill":
        cache = {bkey: {name: torch.stack([e[name] for e in entries])
                        for name in entries[0]}
                 for bkey, entries in fresh.items()}
    return x, stats, cache


def _embed_tokens(policy, params, tokens, tape):
    x = L.embed(params["embed"], tokens, tape)
    return x.to(getattr(torch, policy.compute_dtype))


def _head(params, x, tape):
    return L.lm_head(params["head"], L.rmsnorm(x, params["final_norm"]), tape)


def prefill(cfg: ModelConfig, policy: PrecisionPolicy, params, batch,
            scales, *, max_cache_len: int):
    """Whole-prompt prefill: returns (last-position logits [B, V], stats,
    decode cache ``{stage: {bkey: {"k","v","pos"}}}``)."""
    tape = QTape(policy, scales)
    tokens = batch["tokens"]
    x = _embed_tokens(policy, params, tokens, tape)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    stats: Dict[str, Tensor] = {}
    cache_all = {}
    for stage in build_stages(cfg):
        x, st, cache_out = _run_stage(cfg, policy, stage,
                                      params["stages"][stage.name], x,
                                      positions, scales, "prefill",
                                      max_cache_len=max_cache_len)
        stats.update(st)
        cache_all[stage.name] = cache_out
    # decode only needs the last position: skip the full-seq head matmul
    logits = _head(params, x[:, -1:, :], tape)
    stats.update(tape.stats)
    return logits[:, -1, :], stats, cache_all


def decode_step(cfg: ModelConfig, policy, params, cache, tokens, pos,
                scales, kv_codec=None, append_mask=None):
    """One decoding step. ``tokens``: [B] ids; ``pos``: int32 [B], each
    slot's own position.  ``append_mask`` (bool [B]) drops the cache
    append for masked-off rows.  Returns (logits [B, V], stats, cache) —
    ``cache`` updated in place."""
    tape = QTape(policy, scales)
    x = _embed_tokens(policy, params, tokens[:, None], tape)
    positions = pos.to(torch.int32).reshape(-1, 1)
    stats: Dict[str, Tensor] = {}
    for stage in build_stages(cfg):
        x, st, _ = _run_stage(cfg, policy, stage,
                              params["stages"][stage.name], x, positions,
                              scales, "decode", cache=cache[stage.name],
                              kv_codec=kv_codec, append_mask=append_mask)
        stats.update(st)
    logits = _head(params, x, tape)
    stats.update(tape.stats)
    return logits[:, -1, :], stats, cache


def prefill_chunk_step(cfg: ModelConfig, policy, params, cache, tokens, p0,
                       n_valid, scales, kv_codec=None):
    """One chunked-prefill step: ``C`` prompt positions against the cache.

    ``tokens``: [B, C] ids at positions ``p0 + i``, rows ``>= n_valid``
    zero-padded.  Each layer attends the chunk against its written history
    plus the chunk's own K/V causally, then writes the chunk K/V through
    ``kv_codec``.  Returns (last-valid-position logits [B, V], stats,
    cache) — ``cache`` updated in place.
    """
    tape = QTape(policy, scales)
    x = _embed_tokens(policy, params, tokens, tape)
    B, C = tokens.shape
    p0 = torch.as_tensor(p0, dtype=torch.int32, device=x.device)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=x.device)
    positions = p0[:, None] + torch.arange(C, dtype=torch.int32,
                                           device=x.device)[None, :]
    stats: Dict[str, Tensor] = {}
    for stage in build_stages(cfg):
        x, st, _ = _run_stage(cfg, policy, stage,
                              params["stages"][stage.name], x, positions,
                              scales, "chunk", cache=cache[stage.name],
                              kv_codec=kv_codec, n_valid=n_valid)
        stats.update(st)
    # only the last valid position's logits matter (first sampled token)
    idx = torch.clamp(n_valid - 1, 0, C - 1).long()
    x = x[torch.arange(B, device=x.device), idx][:, None, :]
    logits = _head(params, x, tape)
    stats.update(tape.stats)
    return logits[:, -1, :], stats, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cpu") -> dict:
    """Zero decode cache for ``batch`` sequences of capacity ``max_len``."""
    cache: dict = {}
    for stage in build_stages(cfg):
        sc: dict = {}
        for i, blk in enumerate(stage.blocks):
            if blk.kind != "attn":
                continue
            cap = min(blk.window, max_len) if blk.window else max_len
            K, hd, n = cfg.num_kv_heads, cfg.head_dim, stage.count
            sc[f"{i}:{blk.kind}"] = {
                "k": torch.zeros((n, batch, cap, K, hd), device=device),
                "v": torch.zeros((n, batch, cap, K, hd), device=device),
                "pos": torch.full((n, batch, cap), -1, dtype=torch.int32,
                                  device=device),
            }
        cache[stage.name] = sc
    return cache
