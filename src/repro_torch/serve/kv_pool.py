"""Slot-pooled KV cache with DFXP-packed storage (paper §5/§6, serve-side).

The port of ``repro.serve.kv_pool`` for single-device pools: the
slot-major layout here, the paged layout in :mod:`repro_torch.serve.paged`
(:func:`make_kv_pool` builds either).
:class:`PackedKVCodec` keeps K/V as int8/int16 **mantissas** plus a
per-layer/per-slot log2-step, quantized on append and dequantized in the
attention kernels' tile loads.  Scale management is the core controller:

* on **admit**, exponents are calibrated from the prompt K/V
  max-magnitude (``calibrate_exp`` with a margin bit), accumulators reset;
* on **append**, per-slot overflow statistics accumulate, and every
  ``update_interval`` appends ``controller_step`` applies the paper's
  ×2/÷2 rule per slot; stored mantissas are rescaled in place when an
  exponent moves.

Rounding is to nearest even, or, with ``CacheQuantConfig(stochastic=True)``,
stochastic on every append: each slot carries a threefry key chain per
layer (``key``), seeded from its request's key and split into three at
every append (K draw, V draw, next key), as the reference's.  The
admission chunk and :meth:`PackedKVCodec.pack_entry` round to nearest,
as there.  The reference skips the mantissa re-grid
with a ``lax.cond`` when no exponent moved; here the re-grid always runs
(``round(m * 2**0) == m`` exactly), which costs one pass over a layer's
slots and saves a device-to-host sync per layer per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.packed import (_overflow_counts, container_dtype, pack,
                                     pack_rows, qrange)
from repro_torch.core.quant import exact_pow2, round_mantissa
from repro_torch.core.scale import ScaleState, calibrate_exp, controller_step
from repro_torch.kernels.attn import ops as attn_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CacheQuantConfig:
    """How the packed KV pool stores and re-scales its mantissas."""

    width: int = 8                   # mantissa bits: 8 → int8, 16 → int16
    update_interval: int = 16        # appends between controller applications
    max_overflow_rate: float = 1e-4  # paper §5 threshold
    margin_bits: int = 1             # calibration headroom on admit
    stochastic: bool = False         # stochastic-rounded appends

    def __post_init__(self):
        if not 2 <= self.width <= 16:
            raise ValueError(f"cache width {self.width} outside [2, 16]")


def is_attn_entry(entry: dict) -> bool:
    """True for decode-attention cache entries (raw or packed); a mamba
    sub-block's ``{"conv", "state"}`` entry is not one."""
    return ("k" in entry or "k_m" in entry) and "pos" in entry


def _rescale(m: Tensor, de: Tensor, width: int) -> Tensor:
    """Re-grid a mantissa buffer after its exponent moved by ``de`` [B]:
    ``m' = round(m * 2**-de)``, clipped.  ``de == 0`` rows are exact."""
    qmax, qmin = qrange(width)
    f = exact_pow2(-de).reshape(de.shape + (1,) * (m.ndim - de.ndim))
    mf = torch.round(m.to(torch.float32) * f)
    return mf.clamp_(qmin, qmax).to(m.dtype)


def _pack_chunk(x: Tensor, width: int, e: Tensor, keep: Tensor, key=None,
                det=None):
    """Quantize a chunk ``[B, C, ...]`` against per-row exponents ``e[B]``.

    ``keep`` [B, C] marks the rows that will be written; overflow
    statistics count those rows only.  ``key`` [B, 2] rounds
    stochastically with one draw stream per slot; ``det`` [B] rounds a
    row's slot to nearest instead (the admission chunk, as
    ``pack_entry``).  Returns ``(mantissa int[B, C, ...], stats
    f32[B, 3])``.
    """
    qmax, qmin = qrange(width)
    step = exact_pow2(e).reshape(e.shape + (1,) * (x.ndim - 1))
    m = round_mantissa(x.to(torch.float32) / step, key, det)
    kexp = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
    ovf, ovfh = _overflow_counts(m, width, axes=tuple(range(1, x.ndim)),
                                 mask=kexp)
    row_sz = float(math.prod(x.shape[2:]))
    total = keep.sum(dim=1).to(torch.float32) * row_sz
    stats = torch.stack([ovf, ovfh, total], dim=-1)
    return m.clamp_(qmin, qmax).to(container_dtype(width)), stats


def append_keys(keys: Tensor, mask: Optional[Tensor] = None):
    """One append's draw keys of every slot's chain ``keys`` [B, 2]:
    ``(key_k, key_v, next)`` from ``split(key, 3)``; a masked-off row
    (``mask`` False) keeps its key."""
    ks = prng.split(keys, 3)
    nxt = ks[:, 2] if mask is None else torch.where(mask[:, None], ks[:, 2],
                                                    keys)
    return ks[:, 0], ks[:, 1], nxt


def _layer_keys(slot_keys: Tensor, n: int) -> Tensor:
    """The cache chains ``[n, g, 2]`` of requests keyed ``slot_keys``
    [g, 2]: a domain-tagged root ``fold_in(key, 2**31 - 1)`` (the sampler
    folds the same request key by position, which never reaches it)
    folded by layer index."""
    roots = prng.fold_in(slot_keys, 2 ** 31 - 1)
    layer = torch.arange(n, device=roots.device)
    return prng.fold_in(roots[None], layer[:, None])


class PackedKVCodec(L.KVShard):
    """KV-cache codec storing int mantissas + per-layer/per-slot exponents.

    Entry layout (leading layer dim ``n`` stripped inside the layer loop)::

        k_m, v_m : int8/int16 [n, B, W, K, hd]   mantissas
        k_e, v_e : f32 [n, B]                    log2-steps (integer-valued)
        pos      : int32 [n, B, W]               ring positions (-1 = empty)
        acc_k/v  : f32 [n, B, 3]                 controller window stats
        tot_k/v  : f32 [n, B, 3]                 cumulative stats (metrics)
        n_app    : f32 [n, B]                    appends since admit
        key      : int64 [n, B, 2]               (stochastic mode only)

    ``fused_decode`` selects the attention path, as on
    :class:`repro_torch.models.layers.RawKVCodec`: the flash kernels read
    the mantissas directly, and :meth:`load` — the f32 K/V
    materialization — is not called.  Every method is functional.

    On a sharded pool (``tp_axis``/``cp_axis``,
    :class:`repro_torch.models.layers.KVShard`) the mantissas are this
    rank's kv heads and ring slots; the rows are quantized whole, so the
    exponents and counters are the global ones on every rank.
    """

    def __init__(self, config: CacheQuantConfig, fused_decode: bool = False,
                 *, tp_axis: Optional[str] = None,
                 cp_axis: Optional[str] = None):
        self.cfg = config
        self._fused_decode = bool(fused_decode)
        self.tp_axis, self.cp_axis = tp_axis, cp_axis

    # -- model-layer protocol (called per layer) ---------------------------
    def load(self, entry: dict):
        k = entry["k_m"].to(torch.float32) * \
            exact_pow2(entry["k_e"])[:, None, None, None]
        v = entry["v_m"].to(torch.float32) * \
            exact_pow2(entry["v_e"])[:, None, None, None]
        return k, v, entry["pos"]

    def fused_attention(self, entry: dict, qg: Tensor, q_pos: Tensor, *,
                        scale: float, window=None, causal: bool = True):
        """Flash-decode (K3) directly on the packed mantissas."""
        return attn_ops.flash_decode(qg, entry["k_m"], entry["v_m"],
                                     entry["pos"], q_pos, entry["k_e"],
                                     entry["v_e"], width=self.cfg.width,
                                     scale=scale, window=window,
                                     causal=causal, tp_axis=self.tp_axis)

    def fused_prefill(self, entry: dict, qg: Tensor, k_new: Tensor,
                      v_new: Tensor, p0: Tensor, n_valid: Tensor, *,
                      scale: float, window=None, causal: bool = True):
        """Flash-prefill (K4) directly on the packed mantissas."""
        return attn_ops.flash_prefill(qg, k_new, v_new, entry["k_m"],
                                      entry["v_m"], entry["pos"], p0,
                                      n_valid, entry["k_e"], entry["v_e"],
                                      width=self.cfg.width, scale=scale,
                                      window=window, causal=causal,
                                      tp_axis=self.tp_axis)

    def _control(self, out: dict, k_e, v_e, acc_k, acc_v, apply, k_buf,
                 v_buf) -> dict:
        """§5 controller per slot where ``apply``; re-grid moved slots."""
        cfg = self.cfg
        st = controller_step(
            ScaleState(exps={"k": k_e, "v": v_e},
                       acc={"k": acc_k, "v": acc_v}),
            max_overflow_rate=cfg.max_overflow_rate, apply=apply)
        out["k_e"], out["v_e"] = st.exps["k"], st.exps["v"]
        out["acc_k"], out["acc_v"] = st.acc["k"], st.acc["v"]
        out["k_m"] = _rescale(k_buf, out["k_e"] - k_e, cfg.width)
        out["v_m"] = _rescale(v_buf, out["v_e"] - v_e, cfg.width)
        return out

    def append(self, entry: dict, k_new: Tensor, v_new: Tensor,
               pos: Tensor, mask: Optional[Tensor] = None) -> dict:
        """Append one token's K/V per slot (quantize, count, control).

        ``mask`` (bool [B]) suppresses the append for masked-off rows
        completely — no write, no statistics, no counter advance, no
        controller application, no move of the slot's key chain.
        """
        cfg = self.cfg
        Wl = entry["k_m"].shape[1]
        W, _ = self.window_shard(Wl)
        slot = pos % W
        out = dict(entry)
        key_k = key_v = None
        if cfg.stochastic:
            key_k, key_v, out["key"] = append_keys(entry["key"], mask)
        k_m, st_k = pack_rows(k_new, cfg.width, entry["k_e"],
                              stochastic_keys=key_k)
        v_m, st_v = pack_rows(v_new, cfg.width, entry["v_e"],
                              stochastic_keys=key_v)
        if mask is None:
            napp = 1.0
        else:
            mf = mask.to(torch.float32)
            st_k = st_k * mf[:, None]
            st_v = st_v * mf[:, None]
            slot = torch.where(mask, slot, W)
            napp = mf
        slot = self.local_slots(slot, Wl)[:, None]
        k_m, v_m = self.local_heads(k_m, 1), self.local_heads(v_m, 1)
        k_buf = L.scatter_drop(entry["k_m"], slot, k_m[:, None])
        v_buf = L.scatter_drop(entry["v_m"], slot, v_m[:, None])
        out["pos"] = L.scatter_drop(entry["pos"], slot, pos[:, None])
        acc_k = entry["acc_k"] + st_k
        acc_v = entry["acc_v"] + st_v
        out["tot_k"] = entry["tot_k"] + st_k
        out["tot_v"] = entry["tot_v"] + st_v
        out["n_app"] = entry["n_app"] + napp
        apply = torch.remainder(out["n_app"], float(cfg.update_interval)) == 0.0
        if mask is not None:
            apply = apply & mask
        return self._control(out, entry["k_e"], entry["v_e"], acc_k, acc_v,
                             apply, k_buf, v_buf)

    def append_chunk(self, entry: dict, k_new: Tensor, v_new: Tensor,
                     p0: Tensor, n_valid: Tensor) -> dict:
        """Quantize-on-write for one prefill chunk (positions ``p0+i``).

        ``p0 == 0`` marks the **admission** chunk, which behaves like
        :meth:`pack_entry` for its slot: stale ring positions reset to -1,
        exponents calibrate from this chunk's max-magnitude, statistics and
        the append counter reset.  Later chunks count their valid rows as
        appends and run the §5 controller on every ``update_interval``
        crossing.  Rows ``>= n_valid`` and rows evicted within the same
        chunk are dropped from both writes and statistics.
        """
        cfg = self.cfg
        Wl = entry["k_m"].shape[1]
        W, _ = self.window_shard(Wl)
        B, C = k_new.shape[:2]
        pos, keep, slot = L.chunk_slots(p0, n_valid, C, W)
        first = p0 == 0                                          # [B]

        def _cal(x):
            ax = torch.amax(x.to(torch.float32).abs() * keep[..., None, None],
                            dim=(1, 2, 3))
            return calibrate_exp(ax, cfg.width, cfg.margin_bits)

        k_e = torch.where(first, _cal(k_new), entry["k_e"])
        v_e = torch.where(first, _cal(v_new), entry["v_e"])
        out = dict(entry)
        key_k = key_v = None
        if cfg.stochastic:
            key_k, key_v, out["key"] = append_keys(entry["key"])
        k_m, st_k = _pack_chunk(k_new, cfg.width, k_e, keep, key_k, first)
        v_m, st_v = _pack_chunk(v_new, cfg.width, v_e, keep, key_v, first)
        slot = self.local_slots(slot, Wl)
        k_m, v_m = self.local_heads(k_m, 2), self.local_heads(v_m, 2)
        k_buf = L.scatter_drop(entry["k_m"], slot, k_m)
        v_buf = L.scatter_drop(entry["v_m"], slot, v_m)
        pos_buf = torch.where(first[:, None], -1, entry["pos"])
        out["pos"] = L.scatter_drop(pos_buf, slot, pos)

        zero3 = torch.zeros((B, 3), dtype=torch.float32, device=k_new.device)
        f1 = first[:, None]
        acc_k = torch.where(f1, zero3, entry["acc_k"] + st_k)
        acc_v = torch.where(f1, zero3, entry["acc_v"] + st_v)
        out["tot_k"] = torch.where(f1, zero3, entry["tot_k"] + st_k)
        out["tot_v"] = torch.where(f1, zero3, entry["tot_v"] + st_v)
        cnt = keep.sum(dim=1).to(torch.float32)
        n_prev = torch.where(first, 0.0, entry["n_app"])
        n_new = torch.where(first, 0.0, entry["n_app"] + cnt)
        out["n_app"] = n_new
        interval = float(cfg.update_interval)
        apply = torch.floor(n_new / interval) > torch.floor(n_prev / interval)
        return self._control(out, k_e, v_e, acc_k, acc_v, apply, k_buf,
                             v_buf)

    # -- pool management (full [n, B, ...] shapes) -------------------------
    def init_like(self, raw: dict) -> dict:
        """Packed zero-entry matching a raw ``{"k","v","pos"}`` entry."""
        n, B, W = raw["pos"].shape
        dev = raw["pos"].device
        idtype = container_dtype(self.cfg.width)
        f32 = dict(dtype=torch.float32, device=dev)
        entry = {
            "k_m": torch.zeros(raw["k"].shape, dtype=idtype, device=dev),
            "v_m": torch.zeros(raw["v"].shape, dtype=idtype, device=dev),
            "k_e": torch.zeros((n, B), **f32),
            "v_e": torch.zeros((n, B), **f32),
            "pos": torch.full((n, B, W), -1, dtype=torch.int32, device=dev),
            "acc_k": torch.zeros((n, B, 3), **f32),
            "acc_v": torch.zeros((n, B, 3), **f32),
            "tot_k": torch.zeros((n, B, 3), **f32),
            "tot_v": torch.zeros((n, B, 3), **f32),
            "n_app": torch.zeros((n, B), **f32),
        }
        if self.cfg.stochastic:
            entry["key"] = torch.zeros((n, B, 2), dtype=torch.int64,
                                       device=dev)
        return entry

    def pack_entry(self, raw: dict, slot_keys: Optional[Tensor] = None
                   ) -> dict:
        """Quantize a fresh prefill entry ``[n, g, ...]`` for pool insertion.

        Exponents are calibrated per layer/slot from the prompt K/V
        max-magnitude (empty ring slots, ``pos < 0``, excluded);
        accumulators start at zero.  ``slot_keys`` [g, 2] (the requests'
        keys) seed the slots' key chains in stochastic mode.
        """
        cfg = self.cfg
        n, g, W = raw["pos"].shape
        valid = (raw["pos"] >= 0)[..., None, None]

        def _cal(x):
            ax = torch.amax(x.to(torch.float32).abs() * valid, dim=(2, 3, 4))
            return calibrate_exp(ax, cfg.width, cfg.margin_bits)

        k_e, v_e = _cal(raw["k"]), _cal(raw["v"])
        exp = (..., None, None, None)
        f32 = dict(dtype=torch.float32, device=raw["pos"].device)
        entry = {
            "k_m": pack(raw["k"], cfg.width, k_e[exp]).mantissa,
            "v_m": pack(raw["v"], cfg.width, v_e[exp]).mantissa,
            "k_e": k_e,
            "v_e": v_e,
            "pos": raw["pos"],
            "acc_k": torch.zeros((n, g, 3), **f32),
            "acc_v": torch.zeros((n, g, 3), **f32),
            "tot_k": torch.zeros((n, g, 3), **f32),
            "tot_v": torch.zeros((n, g, 3), **f32),
            "n_app": torch.zeros((n, g), **f32),
        }
        if cfg.stochastic:
            if slot_keys is None:
                raise ValueError("a stochastic cache needs per-slot keys")
            entry["key"] = _layer_keys(prng.as_key(slot_keys,
                                                   raw["pos"].device), n)
        return entry


def make_pool(cfg: T.ModelConfig, max_slots: int, max_len: int,
              codec: Optional[PackedKVCodec] = None, *, device="cpu") -> dict:
    """Zero slot pool: ``init_cache`` with attn entries optionally packed
    (a mamba entry's conv window and state stay f32, as the reference
    keeps them)."""
    raw = T.init_cache(cfg, max_slots, max_len, device=device)
    if codec is None:
        return raw
    return {sname: {bkey: codec.init_like(e) if is_attn_entry(e) else e
                    for bkey, e in sc.items()}
            for sname, sc in raw.items()}


@dataclasses.dataclass
class KVPool:
    """A constructed serve KV pool: tensors + codec + quantization config.

    ``codec`` is ``None`` for the plain f32 ring pool on the plain
    attention path of one process (the model layer falls back to
    ``RAW_KV_CODEC``).  ``shardings`` is the entry tree
    (:meth:`repro_torch.dist.ShardingRules.pool_shardings`) the pool was
    cut by on a mesh, ``None`` otherwise.
    """

    pool: dict
    codec: object
    cache_cfg: Optional[CacheQuantConfig]
    page_size: int = 0                # 0 = slot-major
    total_pages: int = 0              # incl. the null page; 0 if slot-major
    nblocks: int = 0                  # block-table width; 0 if slot-major
    shardings: Optional[dict] = None

    @property
    def packed(self) -> bool:
        return self.cache_cfg is not None

    @property
    def paged(self) -> bool:
        return bool(self.page_size)


def make_kv_pool(cfg: T.ModelConfig, policy, dist=None, *, max_slots: int,
                 max_len: int, cache_bits: int = 0,
                 cache_cfg: Optional[CacheQuantConfig] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None, mesh=None,
                 device=None) -> KVPool:
    """Build the serve KV pool and its codec on ``device``.

    ``cache_bits`` 0 keeps f32 K/V, 8/16 packs mantissas;
    ``policy.fused_decode`` routes attention through the flash kernels.
    ``page_size`` (``None`` takes ``policy.page_size``) > 0 builds the
    paged pool of :mod:`repro_torch.serve.paged` with ``n_pages`` pages
    (default: full residency plus the null page); 0 the slot-major one.

    With an active ``dist`` and its ``mesh`` (a bound mesh,
    :func:`repro_torch.launch.mesh.make_serve_mesh`) the pool is this
    rank's shard, cut by
    :meth:`repro_torch.dist.ShardingRules.pool_shardings`: kv heads over
    ``model`` (TP), and — for slot-major pools under ``cp_decode`` — the
    ring window over ``data`` (CP).  Incoherent requests raise
    :class:`repro_torch.dist.MeshConfigError` here, at construction: an
    active context without its mesh, axes missing from the mesh, CP over
    a paged arena, a window the CP degree does not divide.
    """
    from repro_torch.dist import DistCtx, MeshConfigError

    dist = dist or DistCtx()
    if dist.active and mesh is None:
        raise MeshConfigError(
            "an active DistCtx needs the mesh it names; pass "
            "mesh=launch.mesh.make_serve_mesh(...)")
    if dist.active:
        missing = [a for a in dist.all_axes if a not in mesh.shape]
        if missing:
            raise MeshConfigError(
                f"DistCtx names mesh axes {missing} absent from the mesh "
                f"{dict(mesh.shape)}")
    device = resolve_device(device)
    fused = policy.fused_decode
    psize = int(page_size if page_size is not None
                else getattr(policy, "page_size", 0) or 0)
    tp_axis = "model" if (dist.active and "model" in dist.all_axes) else None
    cp = bool(dist.active and dist.cp_decode and dist.cp_axis)
    if cp and psize:
        raise MeshConfigError(
            "context parallelism cannot shard a paged arena: pages tile "
            "the window axis CP would shard — use the slot-major pool "
            "(page_size=0) with cp, or drop cp for paged serving")
    if cp:
        cp_size = int(mesh.shape.get(dist.cp_axis, 1))
        if cp_size > 1 and max_len % cp_size:
            raise MeshConfigError(
                f"max_len {max_len} is not divisible by the CP degree "
                f"{cp_size}: the KV window must shard evenly")
    cp_axis = dist.cp_axis if cp else None
    if cache_bits:
        ccfg = cache_cfg or CacheQuantConfig(width=cache_bits)
        if ccfg.width != cache_bits:
            raise ValueError("cache_bits and cache_cfg.width disagree")
    else:
        ccfg = None    # a cache_cfg without cache_bits is ignored (f32)
    if psize:
        from . import paged
        if cfg.family != "dense" or cfg.num_experts or cfg.encoder_layers:
            raise ValueError("paged KV pool requires the dense attention "
                             "family (chunked prefill writes pages "
                             "incrementally)")
        codec = paged.PagedKVCodec(psize, ccfg, fused_decode=fused,
                                   tp_axis=tp_axis)
        pool = paged.make_paged_pool(cfg, max_slots, max_len, codec,
                                     n_pages=n_pages, device=device)
        nblocks = -(-max_len // psize)
        total = n_pages if n_pages is not None else 1 + max_slots * nblocks
        kvp = KVPool(pool=pool, codec=codec, cache_cfg=ccfg,
                     page_size=psize, total_pages=total, nblocks=nblocks)
    else:
        if ccfg is not None:
            codec = PackedKVCodec(ccfg, fused_decode=fused, tp_axis=tp_axis,
                                  cp_axis=cp_axis)
        elif fused or dist.active:
            # an f32 pool on the flash kernels (width=None), or one
            # process's shard of an f32 pool
            codec = L.RawKVCodec(fused_decode=fused, tp_axis=tp_axis,
                                 cp_axis=cp_axis)
        else:
            codec = None
        pool = make_pool(cfg, max_slots, max_len,
                         codec if ccfg is not None else None, device=device)
        kvp = KVPool(pool=pool, codec=codec, cache_cfg=ccfg)
    if dist.active:
        from repro_torch.dist.sharding import ShardingRules, shard_tree
        rules = ShardingRules(mesh, shard_batch=False, seq_shard_cache=cp)
        kvp.shardings = rules.pool_shardings(kvp.pool)
        kvp.pool = shard_tree(kvp.pool, kvp.shardings, mesh)
    return kvp


def insert(pool: dict, raw_entry: dict, slots: Tensor,
           codec: Optional[PackedKVCodec] = None,
           slot_keys: Optional[Tensor] = None,
           shardings: Optional[dict] = None) -> dict:
    """Write a fresh prefill cache (group size g) into pool rows ``slots``,
    in place.  In packed mode each attention entry is quantized via
    ``codec.pack_entry`` first (``slot_keys`` [g, 2] seeding a stochastic
    pool's chains); a mamba entry's conv window and state are copied as
    they are.  On a sharded pool (``shardings``, the pool's entry tree,
    under its ambient mesh) the whole entry is packed and this rank's
    shard of it written.  Returns ``pool``."""
    slots = slots.long()
    if shardings is not None:
        from repro_torch.dist.sharding import shard_local
        from repro_torch.launch.mesh import ambient_mesh
        mesh = ambient_mesh()
    for sname, sc in pool.items():
        for bkey, pe in sc.items():
            src = raw_entry[sname][bkey]
            if codec is not None and "k_m" in pe:
                src = codec.pack_entry(src, slot_keys)
            for name, dst in pe.items():
                val = src[name]
                if shardings is not None:
                    val = shard_local(val, shardings[sname][bkey][name],
                                      mesh)
                dst[:, slots] = val.to(dst.dtype)
    return pool


def seed_slot_keys(pool: dict, slot: int, key: Tensor) -> dict:
    """Seed one slot's stochastic-rounding chains before chunked
    admission, in place: :meth:`PackedKVCodec.pack_entry`'s derivation
    (the domain-tagged root of the request's ``key`` folded by layer), so
    a request's cache stream is the same whichever admission path seeds
    it.  Entries without a ``key`` field (deterministic pools) are left
    as they are.  Returns ``pool``."""
    for sc in pool.values():
        for e in sc.values():
            if isinstance(e, dict) and "key" in e:
                k = prng.as_key(key, e["key"].device)[None]
                e["key"][:, slot] = _layer_keys(k, e["key"].shape[0])[:, 0]
    return pool


def _pool_device(pool: dict) -> torch.device:
    for sc in pool.values():
        for e in sc.values():
            return next(iter(e.values())).device
    raise ValueError("empty pool")


def _packed_entries(pool: dict):
    for sc in pool.values():
        for e in sc.values():
            if "tot_k" in e:
                yield e


def _by_slot(t: Tensor, bt: Tensor) -> Tensor:
    """Per-page counters ``t`` [n, pages, 3] gathered through the block
    tables ``bt`` [n, B, nblocks] → [n, B, nblocks, 3] (the null page
    carries zeros)."""
    n = t.shape[0]
    layer = torch.arange(n, device=t.device)[:, None, None]
    return t[layer, bt.long()]


def overflow_summary(pool: dict, active=None) -> dict:
    """Cumulative append overflow rates of the packed pool (metrics hook).

    ``active``: optional bool [B] mask restricting the summary to occupied
    slots.  Returns zeros for float32 pools (slot-major or paged).

    Paged pools keep statistics per PAGE: the summary walks the active
    slots' block tables and counts each referenced page ONCE, however
    many requests share it.  With ``active=None`` every page counts but
    the null page (and the scratch page, which holds dropped rows).
    """
    ovf = tot = 0.0
    for e in _packed_entries(pool):
        if "bt" in e:                     # paged: per-page statistics
            n, n_arena = e["tot_k"].shape[:2]
            dev = e["tot_k"].device
            if active is None:
                used = torch.ones((n, n_arena), dtype=torch.bool, device=dev)
            else:
                act = torch.as_tensor(active, dtype=torch.bool, device=dev)
                sel = torch.where(act[None, :, None], e["bt"], 0)
                used = torch.zeros((n, n_arena), dtype=torch.bool,
                                   device=dev)
                used.scatter_(1, sel.reshape(n, -1).long(), True)
            used[:, 0] = False               # the null page never counts
            used[:, -1] = False              # nor the scratch page
            m = used.to(torch.float32)[..., None]
            for t in (e["tot_k"], e["tot_v"]):
                ovf += float((t * m)[..., 0].sum())
                tot += float((t * m)[..., 2].sum())
            continue
        for t in (e["tot_k"], e["tot_v"]):
            if active is not None:
                act = torch.as_tensor(active, device=t.device)
                t = t * act.to(torch.float32)[None, :, None]
            ovf += float(t[..., 0].sum())
            tot += float(t[..., 2].sum())
    return {"cache_overflow_rate": ovf / tot if tot else 0.0,
            "cache_appends_quantized": tot}


def slot_overflow_rates(pool: dict, n_slots: int) -> Tensor:
    """Per-slot cumulative §5 overflow rate: f32 [n_slots] of overflowed
    over quantized elements since admission, summed over layers and K/V;
    paged pools gather their per-page counters through each slot's block
    table.  Float32 pools return zeros."""
    dev = _pool_device(pool)
    ovf = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
    tot = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
    for e in _packed_entries(pool):
        for t in (e["tot_k"], e["tot_v"]):
            if "bt" in e:
                g = _by_slot(t, e["bt"])
                ovf = ovf + g[..., 0].sum(dim=(0, 2))
                tot = tot + g[..., 2].sum(dim=(0, 2))
            else:
                ovf = ovf + t[..., 0].sum(dim=0)
                tot = tot + t[..., 2].sum(dim=0)
    return ovf / torch.clamp(tot, min=1.0)


def numerics_snapshot(pool: dict, n_slots: int) -> dict:
    """Per-layer/per-slot §5 exponents and overflow counters of the
    packed pool: the serve-side sample of
    :func:`repro_torch.obs.numerics.serve_records`.  For every packed
    attention entry, keyed ``"stage/bkey"``, f32 ``[n_layers, n_slots]``
    tensors:

    * ``k_e`` / ``v_e`` — the shared exponents.  A paged pool keeps them
      per page; each slot reports its newest mapped page's (the one its
      appends quantize against);
    * ``ovf`` / ``half`` / ``tot`` — cumulative append counters
      (overflowed, would-overflow-at-half-range, quantized) summed over
      K and V, gathered through the block tables for a paged pool.

    Empty for float32 pools.  The caller fetches it to the host in one
    transfer per sample."""
    out: Dict[str, dict] = {}
    for sname, sc in pool.items():
        for bkey, e in sc.items():
            if not isinstance(e, dict) or "k_m" not in e \
                    or "tot_k" not in e:
                continue
            if "bt" in e:                  # paged: through the block table
                bt = e["bt"].long()                        # [n, B, nblocks]
                # newest mapped page per slot (page 0 is the null page)
                last = torch.clamp((bt != 0).sum(-1) - 1, min=0)
                newest = torch.gather(bt, 2, last[..., None])[..., 0]
                k_e = torch.gather(e["k_e"], 1, newest)
                v_e = torch.gather(e["v_e"], 1, newest)
                cnt = (_by_slot(e["tot_k"], bt)
                       + _by_slot(e["tot_v"], bt)).sum(2)   # [n, B, 3]
            else:                          # slot-major: per slot directly
                k_e, v_e = e["k_e"], e["v_e"]
                cnt = e["tot_k"] + e["tot_v"]
            out[f"{sname}/{bkey}"] = {
                "k_e": k_e[:, :n_slots], "v_e": v_e[:, :n_slots],
                "ovf": cnt[:, :n_slots, 0], "half": cnt[:, :n_slots, 1],
                "tot": cnt[:, :n_slots, 2]}
    return out


def slot_totals(pool: dict, slot: int) -> Tensor:
    """One slot's cumulative ``(ovf, ovf_half, total)`` over all layers —
    between admit and finish, the occupying request's append statistics.

    Paged pools gather the per-page counters of every page on the slot's
    block table, so pages inherited from a shared prefix count toward
    each request that maps them, as the reference's totals do."""
    dev = _pool_device(pool)
    out = torch.zeros((3,), dtype=torch.float32, device=dev)
    for e in _packed_entries(pool):
        for t in (e["tot_k"], e["tot_v"]):
            if "bt" in e:
                out = out + _by_slot(t, e["bt"])[:, slot].sum(dim=(0, 1))
            else:
                out = out + t[:, slot].sum(dim=0)
    return out
