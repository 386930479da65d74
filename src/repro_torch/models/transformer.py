"""Decoder LM of the port: the dense stage of ``repro.models.transformer``.

A model is a sequence of **stages**; each stage repeats a *super-block*
(an ordered tuple of sub-blocks) ``count`` times over layer-stacked
parameters ``[count, ...]``.  The dense family (llama3/qwen3/phi3 and the
example's LM_100M) is one stage of ``(attn, ffn) × L``.  The reference's
``lax.scan`` over layers is a Python loop here that stacks each layer's
statistics.

Parameters keep the reference's pytree: ``{"stages": {"dec": {"stacked":
{"0:attn": {...}, "1:ffn": {...}}, "shared": {}}}, "embed", "head",
"final_norm"}`` with ``[count, d_in, d_out]`` weights (no ``head`` when
the embeddings are tied: the head contracts against the table), so
:func:`repro_torch.models.convert.params_from_jax` is a leaf-for-leaf
copy, and :func:`init_params` draws the reference's numbers from the
same threefry key.  Caches keep the reference's ``[n_layer, B, ...]``
layout too.

Training: :func:`forward` in ``train``/``hidden`` mode and
:func:`loss_fn` (mean cross-entropy, optionally over sequence chunks
recomputed in the backward, ``torch.utils.checkpoint`` for the
reference's ``jax.checkpoint``) take the per-site gradient-statistics
sinks of :mod:`repro_torch.core.quant`.

The serving entry points (:func:`prefill`, :func:`decode_step`,
:func:`prefill_chunk_step`) update the cache they are given **in
place**, layer by layer, and return it: the port's counterpart of the
reference's donated pool, which keeps one copy of the pool resident.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quant import qbound_site
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
    family: str = "dense"          # the port has the dense family
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    rope_theta: float = 1e6
    window: int = 0                # >0: sliding window attention
    tie_embeddings: bool = True

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
    token inputs)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port has the dense family; {cfg.name!r} is {cfg.family} "
            f"(ROADMAP module item 21)")
    blocks = (SubBlock("attn", window=cfg.window), SubBlock("ffn"))
    return (Stage("dec", cfg.num_layers, blocks),)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_block(key: Tensor, cfg: ModelConfig, blk: SubBlock) -> dict:
    """One sub-block's parameters from ``key`` (a batch ``[count, 2]``
    draws the stacked layers, one key each)."""
    p = {"norm": torch.ones(key.shape[:-1] + (cfg.d_model,),
                            dtype=torch.float32, device=key.device)}
    if blk.kind == "attn":
        p.update(L.init_attn(key, cfg.attn_spec))
    else:
        p.update(L.init_swiglu(key, cfg.d_model, cfg.d_ff))
    return p


def init_params(cfg: ModelConfig, key=0, *, device="cuda") -> dict:
    """The reference's initial parameters (``transformer.py:198-226``),
    drawn on ``device`` from the threefry ``key`` (an int is
    ``PRNGKey(int)``) with the reference's key tree: ``split`` into
    ``len(stages) + 3`` keys, ``fold_in(keys[stage], i)`` per sub-block
    and ``split`` over its stacked layers; the embedding from
    ``keys[-3]``, an untied head from ``keys[-2]``.

    Each leaf is drawn where it lives and large ones in row blocks
    (:func:`prng.normal_blocked`), so a full-width model never exists on
    the host and the draw's temporaries stay small; ``device="meta"``
    gives the shapes alone."""
    key = prng.as_key(key, resolve_device(device))
    stages = build_stages(cfg)
    keys = prng.split(key, len(stages) + 3)
    params: dict = {"stages": {}}
    for si, stage in enumerate(stages):
        stacked = {}
        for i, blk in enumerate(stage.blocks):
            ks = prng.split(prng.fold_in(keys[si], i), stage.count)
            stacked[f"{i}:{blk.kind}"] = _init_block(ks, cfg, blk)
        params["stages"][stage.name] = {"stacked": stacked, "shared": {}}
    params["embed"] = L.init_embed(keys[-3], cfg.vocab_size, cfg.d_model)
    if not cfg.tie_embeddings:
        params["head"] = L.init_dense(keys[-2], cfg.d_model, cfg.vocab_size,
                                      scale=0.02)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                      device=key.device)
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
                 append_mask=None):
    """Apply one sub-block (pre-norm residual). Returns (x, cache_out)."""
    h = L.rmsnorm(x, bp["norm"])
    cache_out = None
    window = blk.window if blk.window > 0 else None
    if blk.kind == "attn":
        spec = cfg.attn_spec
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


def _unbind(tree, n: int):
    """The ``n`` layers of a layer-stacked dict as views, one
    ``unbind`` per leaf: under autograd the layers' gradients meet in one
    stack per leaf, not in ``n`` full-size sums."""
    if isinstance(tree, dict):
        per = {k: _unbind(t, n) for k, t in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def _run_stage(cfg, policy, stage: Stage, sp, x, positions, scales,
               mode: str, cache=None, max_cache_len: int = 0, kv_codec=None,
               n_valid=None, append_mask=None, sinks=None):
    """Run one stage layer by layer. Returns (x, stats, cache_out).

    Decode and chunk modes write each layer's new cache entry back into
    ``cache`` in place; prefill mode builds and stacks fresh entries;
    train mode threads each layer's slice of the ``g:`` ``sinks``.
    """
    names = _stage_group_names(stage)
    per_layer_stats = []
    fresh: Dict[str, list] = {}
    layers = _unbind(sp["stacked"], stage.count)
    sk_names = [n for n in names if sinks and n in sinks]
    sk_layers = {n: sinks[n].unbind(0) for n in sk_names}
    for li in range(stage.count):
        sc = {n: scales[n][li] for n in names if n in scales}
        tape = QTape(policy, sc, {n: sk_layers[n][li] for n in sk_names})
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            ci = None
            if cache is not None and bkey in cache:
                ci = _layer(cache[bkey], li)
            x, co = _apply_block(cfg, blk, f"{stage.name}/{bkey}",
                                 layers[li][bkey], x,
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


def _head(cfg, params, x, tape):
    """Final norm and the vocabulary projection (tied: the table)."""
    x = L.rmsnorm(x, params["final_norm"])
    if cfg.tie_embeddings:
        return L.lm_head(params["embed"], x, tape, tied=True)
    return L.lm_head(params["head"], x, tape, tied=False)


def forward(cfg: ModelConfig, policy: PrecisionPolicy, params, batch,
            scales: Dict[str, Tensor], sinks: Dict[str, Tensor], *,
            mode: str = "train"):
    """Full-sequence forward of the training path. Returns ``(logits
    [B, S, V], stats, None)``; ``mode="hidden"`` returns the final-normed
    hidden states instead of logits (the caller fuses head and loss).

    ``batch``: ``tokens`` [B, S] and optional ``positions`` [B, S].
    ``sinks``: the ``g:`` groups' zero sinks (``[count, 3]`` per stacked
    group), whose gradients are the backward statistics."""
    if mode not in ("train", "hidden"):
        raise ValueError(f"forward runs the train or hidden mode, not "
                         f"{mode!r} (serving: prefill/decode_step/"
                         f"prefill_chunk_step)")
    tape = QTape(policy, scales, sinks)      # the embed and head sites
    tokens = batch["tokens"]
    x = _embed_tokens(policy, params, tokens, tape)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    stats: Dict[str, Tensor] = {}
    for stage in build_stages(cfg):
        x, st, _ = _run_stage(cfg, policy, stage,
                              params["stages"][stage.name], x, positions,
                              scales, "train", sinks=sinks)
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
            ce_chunk: int = 0):
    """Mean cross-entropy over ``batch["labels"]`` (masked by an optional
    ``loss_mask``); returns ``(loss, stats)``.

    ``ce_chunk > 0`` computes the head product and the softmax-CE over
    sequence chunks of that many positions, each recomputed in the
    backward (``torch.utils.checkpoint``), so the ``[tokens, vocab]``
    logits never exist whole — the reference's rematerialized scan,
    with the head's ``qbound`` and statistics per chunk."""
    labels = batch["labels"]
    if not ce_chunk:
        logits, stats, _ = forward(cfg, policy, params, batch, scales, sinks)
        ll = _ce(logits, labels)
        mask = batch.get("loss_mask")
        if mask is None:
            return -ll.mean(), stats
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0), stats

    hidden, stats, _ = forward(cfg, policy, params, batch, scales, sinks,
                               mode="hidden")
    tape = QTape(policy, scales, sinks)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    w = tape.weight("head/w", table).to(hidden.dtype)
    B, S, D = hidden.shape
    if S % ce_chunk:
        raise ValueError(f"ce_chunk {ce_chunk} does not divide seq {S}")
    fmt = policy.comp_format()
    a_e = scales.get("a:head/logits", 0.0)
    g_e = scales.get("g:head/logits", 0.0)
    head_sink = sinks.get("g:head/logits")

    def body(xch: Tensor, lch: Tensor):
        logits = (torch.einsum("bsd,vd->bsv", xch, w) if cfg.tie_embeddings
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
    logits = _head(cfg, params, x[:, -1:, :], tape)
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
    logits = _head(cfg, params, x, tape)
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
    logits = _head(cfg, params, x, tape)
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
