"""Paged KV pool: fixed-size pages + per-request block tables.

The port of ``repro.serve.paged``.  K/V mantissas live in a global
``[n_pages, page_size, K, hd]`` arena per layer, a per-request *block
table* maps logical token blocks to physical pages, and admission hashes
the prompt prefix page by page so identical prefixes map the same
physical pages copy-on-write (refcounted; a write to a shared page forks
a private copy first).

DFXP storage keeps the paper's §5 discipline per page, as the reference
does: exponents, controller windows and cumulative counters are
``[n_pages]`` / ``[n_pages, 3]``; a page calibrates when its first row is
written; the ×2/÷2 controller applies on the writing request's
``update_interval`` crossings to its tail page only.

Split of responsibilities:

* :class:`PagedKVCodec` — the device side: the model layer's codec
  protocol (``load``, ``append``, ``append_chunk``, ``fused_attention``,
  ``fused_prefill``) on paged entries.  ``width=None`` stores raw f32
  pages.
* :class:`PageAllocator` — the host side (numpy and hashlib): free list,
  refcounts, the prompt-prefix index, copy-on-write decisions, LRU
  eviction.  The engine consults it between steps and applies its
  decisions through the pool ops (:func:`reset_slot`, :func:`cow_page`,
  :func:`set_block`), which write the pool in place.

Page 0 is the permanent **null page**: block-table rows point at it when
no page is mapped, its rows are never written, and its ``pos`` image is
always -1 so attention masks it out.

**The scratch page.**  The reference drops masked rows with an
out-of-range scatter index (``mode="drop"``), which PyTorch does not
have: on the card an out-of-range index is a device-side assert.  So
every per-page leaf (``k_m``, ``v_m``, ``k_e``, ``v_e``, ``acc_*``,
``tot_*``) carries one page more than the allocator hands out: index
``n_pages``, the reference's drop index, is a real scratch page.  Masked
rows write there; no block table maps it, so neither attention nor the
counters ever read it.  Positions, which are per slot, drop their masked
rows through :func:`repro_torch.models.layers.scatter_drop`.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.packed import _overflow_counts, container_dtype, \
    pack_rows, qrange
from repro_torch.core.quant import exact_pow2, round_mantissa
from repro_torch.core.scale import ScaleState, calibrate_exp, controller_step
from repro_torch.kernels.attn import ops as attn_ops
from repro_torch.kernels.attn import ref as AR
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.kv_pool import _rescale, append_keys, is_attn_entry

Tensor = torch.Tensor

# entry leaves indexed by slot on axis 1 (full [n, B, ...] shapes); the
# page-storage leaves are indexed by page
_SLOT_KEYS = ("bt", "pos", "n_app", "key")
PAGE_KEYS = ("k_m", "v_m", "k_e", "v_e", "acc_k", "acc_v", "tot_k", "tot_v")


class PageExhausted(RuntimeError):
    """The page arena has no free or evictable page left.

    A ``RuntimeError`` subclass, typed so the engine can catch exhaustion
    specifically and answer it with preemption.
    """


def is_paged_entry(entry) -> bool:
    """True for paged attention cache entries (block table present)."""
    return isinstance(entry, dict) and "bt" in entry and "pos" in entry


def _put(buf: Tensor, index, vals) -> Tensor:
    """A copy of ``buf`` with ``vals`` written at ``index``."""
    out = buf.clone()
    out[index] = vals.to(buf.dtype) if torch.is_tensor(vals) else vals
    return out


def _pack_paged_rows(x: Tensor, width: int, e_rows: Tensor, keep: Tensor,
                     key=None, det=None):
    """Quantize chunk rows ``[B, C, ...]`` against per-row exponents.

    ``e_rows`` is ``[B, C]``: each row quantizes against its destination
    page's exponent.  ``key`` [B, 2] rounds stochastically, one stream a
    slot, except where ``det`` [B] (an admission chunk) rounds to
    nearest.  Returns ``(mantissa int[B, C, ...], stats f32[B, C, 3])``
    with per-row statistics of the kept rows, which the caller
    scatter-adds per page.
    """
    qmax, qmin = qrange(width)
    step = exact_pow2(e_rows).reshape(e_rows.shape + (1,) * (x.ndim - 2))
    m = round_mantissa(x.to(torch.float32) / step, key, det)
    kexp = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
    ovf, ovfh = _overflow_counts(m, width, axes=tuple(range(2, x.ndim)),
                                 mask=kexp)
    total = keep.to(torch.float32) * float(math.prod(x.shape[2:]))
    stats = torch.stack([ovf, ovfh, total], dim=-1)
    return m.clamp_(qmin, qmax).to(container_dtype(width)), stats


class PagedKVCodec(L.KVShard):
    """KV-cache codec over paged storage + per-request block tables.

    Entry layout (leading layer dim ``n`` stripped inside the layer loop;
    ``P`` = page_size, ``Wp`` = nblocks × P ≥ max_len, ``n_pages``
    counting the null page but not the scratch page)::

        k_m, v_m : int8/int16 (or f32) [n, n_pages + 1, P, K, hd]
        bt       : int32 [n, B, nblocks]   block table (0 = null page)
        pos      : int32 [n, B, Wp]        logical positions (-1 = empty)
        k_e, v_e : f32 [n, n_pages + 1]    per-PAGE log2-steps (packed)
        acc_k/v  : f32 [n, n_pages + 1, 3] controller window stats
        tot_k/v  : f32 [n, n_pages + 1, 3] cumulative stats (metrics)
        n_app    : f32 [n, B]              absolute stored-token count
        key      : int64 [n, B, 2]         (stochastic mode only)

    Every layer's block-table row is identical.  Logical row ``r`` of a
    request lives at page ``bt[b, r // P]``, offset ``r % P``; ``pos`` is
    indexed by the logical row, so attention masking is the slot-major
    pool's.  ``config=None`` stores raw f32 pages.  Admission state
    (positions, block-table row, prefix sharing) is host-driven through
    :func:`reset_slot`.  Every method is functional: it returns new
    tensors and leaves ``entry`` as it was.
    """

    def __init__(self, page_size: int, config=None,
                 fused_decode: bool = False, *,
                 tp_axis: Optional[str] = None):
        if page_size < 1:
            raise ValueError(f"page_size {page_size} < 1")
        self.page_size = page_size
        self.cfg = config
        self._fused_decode = bool(fused_decode)
        # serving TP shards the kv heads inside every page; pages already
        # tile the window, so a paged pool never shards it (cp_axis None)
        self.tp_axis = tp_axis

    @property
    def width(self) -> Optional[int]:
        return None if self.cfg is None else self.cfg.width

    # -- model-layer protocol (called per layer) ---------------------------
    def load(self, entry: dict):
        """Gather the block table into ``[B, Wp, K, hd]`` f32 K/V."""
        k = AR.gather_pages(entry["k_m"], entry.get("k_e"), entry["bt"],
                            self.width)
        v = AR.gather_pages(entry["v_m"], entry.get("v_e"), entry["bt"],
                            self.width)
        return k, v, entry["pos"]

    def fused_attention(self, entry: dict, qg: Tensor, q_pos: Tensor, *,
                        scale: float, window=None, causal: bool = True):
        """Paged flash-decode (K5) on the page arenas."""
        return attn_ops.flash_decode_paged(
            qg, entry["k_m"], entry["v_m"], entry["bt"], entry["pos"], q_pos,
            entry.get("k_e"), entry.get("v_e"), width=self.width,
            scale=scale, window=window, causal=causal, tp_axis=self.tp_axis)

    def fused_prefill(self, entry: dict, qg: Tensor, k_new: Tensor,
                      v_new: Tensor, p0: Tensor, n_valid: Tensor, *,
                      scale: float, window=None, causal: bool = True):
        """Paged flash-prefill (K6) on the page arenas."""
        return attn_ops.flash_prefill_paged(
            qg, k_new, v_new, entry["k_m"], entry["v_m"], entry["bt"],
            entry["pos"], p0, n_valid, entry.get("k_e"), entry.get("v_e"),
            width=self.width, scale=scale, window=window, causal=causal,
            tp_axis=self.tp_axis)

    def _control(self, out: dict, k_e, v_e, acc_k, acc_v, apply, k_buf,
                 v_buf) -> dict:
        """§5 controller on the pages where ``apply``; re-grid moved pages
        (``round(m * 2**0) == m`` exactly, so unmoved pages keep their
        bits and no device-to-host check is needed)."""
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
        """Append one token's K/V per slot into its tail page.

        The engine makes the destination block writable before the step
        (a fresh private page at a block boundary, a copy-on-write fork of
        a shared tail).  A row whose page starts here (``pos % P == 0``)
        calibrates the page exponent and resets the page's statistics;
        ``mask`` (bool [B]) drops writes, statistics, counter advances and
        key-chain moves.
        """
        P = entry["k_m"].shape[1]
        drop = entry["k_m"].shape[0] - 1                  # the scratch page
        bt = entry["bt"]
        B, nblocks = bt.shape
        Wp = entry["pos"].shape[1]
        dev = bt.device
        bidx = torch.arange(B, device=dev)
        posi = pos.to(torch.int32)
        blk = torch.clamp(posi // P, 0, nblocks - 1).long()
        off = (posi % P).long()
        pages = bt[bidx, blk].long()                       # [B]
        if mask is None:
            mask = torch.ones((B,), dtype=torch.bool, device=dev)
        wpg = torch.where(mask, pages, drop)
        wrow = torch.where(mask, posi, Wp)[:, None]

        out = dict(entry)
        out["pos"] = L.scatter_drop(entry["pos"], wrow, posi[:, None])
        if self.cfg is None:
            out["k_m"] = _put(entry["k_m"], (wpg, off),
                              self.local_heads(k_new, 1))
            out["v_m"] = _put(entry["v_m"], (wpg, off),
                              self.local_heads(v_new, 1))
            return out

        cfg = self.cfg
        key_k = key_v = None
        if cfg.stochastic:
            key_k, key_v, out["key"] = append_keys(entry["key"], mask)
        fresh = (off == 0) & mask
        wfresh = torch.where(fresh, pages, drop)

        def _cal(x):
            ax = torch.amax(x.to(torch.float32).abs(), dim=(1, 2))
            return calibrate_exp(ax, cfg.width, cfg.margin_bits)

        k_e = _put(entry["k_e"], (wfresh,), _cal(k_new))
        v_e = _put(entry["v_e"], (wfresh,), _cal(v_new))
        k_m, st_k = pack_rows(k_new, cfg.width, k_e[pages],
                              stochastic_keys=key_k)
        v_m, st_v = pack_rows(v_new, cfg.width, v_e[pages],
                              stochastic_keys=key_v)
        mf = mask.to(torch.float32)[:, None]
        st_k, st_v = st_k * mf, st_v * mf
        k_buf = _put(entry["k_m"], (wpg, off), self.local_heads(k_m, 1))
        v_buf = _put(entry["v_m"], (wpg, off), self.local_heads(v_m, 1))

        def _stats(name, st):
            t = _put(entry[name], (wfresh,), 0.0)
            return t.index_put_((wpg,), st, accumulate=True)

        acc_k, acc_v = _stats("acc_k", st_k), _stats("acc_v", st_v)
        out["tot_k"], out["tot_v"] = _stats("tot_k", st_k), \
            _stats("tot_v", st_v)
        pf = posi.to(torch.float32)
        out["n_app"] = torch.where(mask, pf + 1.0, entry["n_app"])

        # §5 controller on update_interval crossings of the absolute
        # stored-token count, applied to the writing row's page only
        interval = float(cfg.update_interval)
        cross = (torch.floor((pf + 1.0) / interval)
                 > torch.floor(pf / interval)) & mask
        apply = torch.zeros((drop + 1,), dtype=torch.bool, device=dev)
        apply[torch.where(cross, pages, drop)] = True
        return self._control(out, k_e, v_e, acc_k, acc_v, apply, k_buf,
                             v_buf)

    def append_chunk(self, entry: dict, k_new: Tensor, v_new: Tensor,
                     p0: Tensor, n_valid: Tensor) -> dict:
        """Quantize-on-write one prefill chunk into the mapped pages.

        A page is **fresh** when its first logical row is inside this
        chunk (``block·P >= p0``): it calibrates from the chunk rows
        landing on it and its statistics reset.  A partly filled page
        continuing an earlier chunk (or a copy-on-write fork) keeps its
        exponent.  ``n_app`` tracks the absolute stored-token count, so
        the controller's cadence is a function of position only.  Rows
        ``>= n_valid`` drop from writes and statistics.
        """
        P = entry["k_m"].shape[1]
        drop = entry["k_m"].shape[0] - 1                  # the scratch page
        bt = entry["bt"]
        B, nblocks = bt.shape
        Wp = entry["pos"].shape[1]
        C = k_new.shape[1]
        dev = bt.device
        idx = torch.arange(C, dtype=torch.int32, device=dev)
        pos = p0[:, None] + idx[None, :]                     # [B, C]
        keep = idx[None, :] < n_valid[:, None]               # [B, C]
        blk = torch.clamp(pos // P, 0, nblocks - 1)
        off = (pos % P).long()
        pages = torch.gather(bt, 1, blk.long()).long()       # [B, C]
        wpg = torch.where(keep, pages, drop)

        out = dict(entry)
        out["pos"] = L.scatter_drop(entry["pos"], torch.where(keep, pos, Wp),
                                    pos)
        if self.cfg is None:
            out["k_m"] = _put(entry["k_m"], (wpg, off),
                              self.local_heads(k_new, 2))
            out["v_m"] = _put(entry["v_m"], (wpg, off),
                              self.local_heads(v_new, 2))
            return out

        cfg = self.cfg
        key_k = key_v = None
        if cfg.stochastic:
            key_k, key_v, out["key"] = append_keys(entry["key"])
        det = p0 == 0          # admission chunks round to nearest
        fresh_row = keep & (blk * P >= p0[:, None])
        wfr = torch.where(fresh_row, pages, drop).reshape(-1)
        fresh_pg = torch.zeros((drop + 1,), dtype=torch.bool, device=dev)
        fresh_pg[wfr] = True

        def _cal(x, e_old):
            rmax = torch.amax(x.to(torch.float32).abs(), dim=(2, 3))
            pmax = torch.zeros((drop + 1,), dtype=torch.float32,
                               device=dev).scatter_reduce(
                0, wfr, rmax.reshape(-1), reduce="amax")
            return torch.where(fresh_pg, calibrate_exp(pmax, cfg.width,
                                                       cfg.margin_bits),
                               e_old)

        k_e = _cal(k_new, entry["k_e"])
        v_e = _cal(v_new, entry["v_e"])
        k_m, rst_k = _pack_paged_rows(k_new, cfg.width, k_e[pages], keep,
                                      key_k, det)
        v_m, rst_v = _pack_paged_rows(v_new, cfg.width, v_e[pages], keep,
                                      key_v, det)
        k_buf = _put(entry["k_m"], (wpg, off), self.local_heads(k_m, 2))
        v_buf = _put(entry["v_m"], (wpg, off), self.local_heads(v_m, 2))

        wpg_f = wpg.reshape(-1)

        def _stats(name, rst):
            t = torch.where(fresh_pg[:, None], 0.0, entry[name])
            return t.index_put_((wpg_f,), rst.reshape(-1, 3),
                                accumulate=True)

        acc_k, acc_v = _stats("acc_k", rst_k), _stats("acc_v", rst_v)
        out["tot_k"], out["tot_v"] = _stats("tot_k", rst_k), \
            _stats("tot_v", rst_v)
        pf0 = p0.to(torch.float32)
        nv = n_valid.to(torch.float32)
        out["n_app"] = pf0 + nv

        interval = float(cfg.update_interval)
        cross = (torch.floor((pf0 + nv) / interval)
                 > torch.floor(pf0 / interval)) & (n_valid > 0)
        last_blk = torch.clamp((p0 + n_valid - 1) // P, 0, nblocks - 1)
        tail_pg = torch.gather(bt, 1, last_blk[:, None].long())[:, 0].long()
        apply = torch.zeros((drop + 1,), dtype=torch.bool, device=dev)
        apply[torch.where(cross, tail_pg, drop)] = True
        return self._control(out, k_e, v_e, acc_k, acc_v, apply, k_buf,
                             v_buf)

    # -- pool construction (full [n, B, ...] shapes) -----------------------
    def init_like(self, raw: dict, n_pages: int, device=None) -> dict:
        """Paged zero-entry matching a raw ``{"k","v","pos"}`` entry (whose
        tensors may live on the ``meta`` device: only shapes are read)."""
        n, B, W, K, hd = raw["k"].shape
        dev = torch.device(device) if device is not None else raw["k"].device
        P = self.page_size
        nblocks = -(-W // P)
        arena = n_pages + 1                              # + the scratch page
        dtype = (torch.float32 if self.cfg is None
                 else container_dtype(self.cfg.width))
        f32 = dict(dtype=torch.float32, device=dev)
        entry = {
            "k_m": torch.zeros((n, arena, P, K, hd), dtype=dtype, device=dev),
            "v_m": torch.zeros((n, arena, P, K, hd), dtype=dtype, device=dev),
            "bt": torch.zeros((n, B, nblocks), dtype=torch.int32, device=dev),
            "pos": torch.full((n, B, nblocks * P), -1, dtype=torch.int32,
                              device=dev),
        }
        if self.cfg is not None:
            entry.update({
                "k_e": torch.zeros((n, arena), **f32),
                "v_e": torch.zeros((n, arena), **f32),
                "acc_k": torch.zeros((n, arena, 3), **f32),
                "acc_v": torch.zeros((n, arena, 3), **f32),
                "tot_k": torch.zeros((n, arena, 3), **f32),
                "tot_v": torch.zeros((n, arena, 3), **f32),
                "n_app": torch.zeros((n, B), **f32),
            })
            if self.cfg.stochastic:
                entry["key"] = torch.zeros((n, B, 2), dtype=torch.int64,
                                           device=dev)
        return entry


def make_paged_pool(cfg: T.ModelConfig, max_slots: int, max_len: int,
                    codec: PagedKVCodec, n_pages: Optional[int] = None, *,
                    device="cpu") -> dict:
    """Zero paged pool: ``init_cache``'s attention entries laid out as pages.

    ``n_pages`` defaults to full residency (every slot can map its whole
    ``max_len``) plus the null page; a smaller budget is legal — the
    allocator recycles freed and evicted pages, and the engine answers
    exhaustion with preemption.

    What the reference refuses, this refuses with its messages: rings of
    more than one cap (windowed attention is not paged) and non-attention
    entries (an SSM's conv window and state are per-slot, not paged;
    :func:`repro_torch.serve.kv_pool.make_kv_pool` refuses those families
    first).
    """
    raw = T.init_cache(cfg, max_slots, max_len, device="meta")
    P = codec.page_size
    entries = [e for sc in raw.values() for e in sc.values()]
    if not all(is_attn_entry(e) for e in entries):
        raise ValueError("paged KV pool requires the dense attention family "
                         "(chunked prefill writes pages incrementally)")
    caps = {e["k"].shape[2] for e in entries}
    if len(caps) > 1:
        raise ValueError(f"paged pool needs one ring cap, got {caps} "
                         "(windowed attention is not paged)")
    nblocks = -(-max(caps) // P) if caps else 0
    if n_pages is None:
        n_pages = 1 + max_slots * nblocks
    return {sname: {bkey: codec.init_like(e, n_pages, device)
                    for bkey, e in sc.items()}
            for sname, sc in raw.items()}


# -- pool ops (engine-driven admission / sharing / copy-on-write), in place
def _paged_entries(pool: dict):
    for sc in pool.values():
        for e in sc.values():
            if is_paged_entry(e):
                yield e


def reset_slot(pool: dict, slot: int, shared_len: int, bt_row,
               n_app0: float) -> dict:
    """Re-admit ``slot``: block-table row, position reset, counter seed.

    ``bt_row`` [nblocks] carries the allocator's mapping (shared prefix
    pages first, null elsewhere); positions ``< shared_len`` are marked
    live (the shared pages already hold those rows), the rest empty.
    """
    for e in _paged_entries(pool):
        Wp = e["pos"].shape[2]
        iota = torch.arange(Wp, dtype=torch.int32, device=e["pos"].device)
        e["pos"][:, slot] = torch.where(iota < shared_len, iota, -1)
        e["bt"][:, slot] = torch.as_tensor(np.asarray(bt_row),
                                           dtype=torch.int32,
                                           device=e["bt"].device)
        if "n_app" in e:
            e["n_app"][:, slot] = float(n_app0)
    return pool


def cow_page(pool: dict, src: int, dst: int) -> dict:
    """Copy page ``src`` onto ``dst`` in every layer of every paged entry:
    mantissas, the page exponent and its statistics, so the fork goes on
    exactly where the shared page's writer left off."""
    for e in _paged_entries(pool):
        for f in PAGE_KEYS:
            if f in e:
                e[f][:, dst] = e[f][:, src]
    return pool


def set_block(pool: dict, slot: int, block: int, page: int) -> dict:
    """Point ``slot``'s logical ``block`` at physical ``page`` (all layers)."""
    for e in _paged_entries(pool):
        e["bt"][:, slot, block] = int(page)
    return pool


def slice_slot(pool: dict, slot: int) -> dict:
    """One-slot view for a prefill chunk.

    Per-slot leaves (block table, positions, counters) narrow to
    ``[n, 1, ...]`` views; the page arenas pass through whole, so the
    chunk's writes land in the global pages.  Slot-major entries narrow on
    axis 1 wholesale.
    """
    def _one(t):
        return t[:, slot:slot + 1]

    return {sname: {bkey: {f: (_one(t) if f in _SLOT_KEYS
                               or not is_paged_entry(e) else t)
                           for f, t in e.items()}
                    for bkey, e in sc.items()}
            for sname, sc in pool.items()}


def merge_slot(pool: dict, sub: dict, slot: int) -> dict:
    """Write a :func:`slice_slot` view back into the pool.

    Per-slot leaves update the slot's row, page arenas replace the
    pool's.  Leaves of ``sub`` that are views of ``pool`` (all of them,
    as :func:`slice_slot` returns them) already hold the writes and are
    skipped.
    """
    for sname, sc in pool.items():
        for bkey, e in sc.items():
            s = sub[sname][bkey]
            for f, t in e.items():
                if f in _SLOT_KEYS or not is_paged_entry(e):
                    t = t[:, slot:slot + 1]
                if s[f].data_ptr() != t.data_ptr():
                    t.copy_(s[f])
    return pool


def page_nbytes(pool: dict) -> int:
    """Device bytes of ONE page across every layer of every paged entry:
    the mantissa rows plus the per-page exponent and statistics."""
    total = 0
    for e in _paged_entries(pool):
        for f in PAGE_KEYS:
            if f in e:
                t = e[f]
                total += t.numel() // t.shape[1] * t.element_size()
    return total


def slot_nbytes(pool: dict) -> int:
    """Device bytes ONE slot permanently reserves in a slot-major pool."""
    total = 0
    for sc in pool.values():
        for e in sc.values():
            if is_paged_entry(e) or "pos" not in e:
                continue
            for t in e.values():
                total += t.numel() // t.shape[1] * t.element_size()
    return total


class PageAllocator:
    """Host-side page bookkeeping: free list, refcounts, prefix index.

    The allocator never touches device tensors: it decides, the engine
    applies through the pool ops.  Page ids are ``1..n_pages-1`` (0 is
    the null page).  Invariants:

    * ``rc[p] >= 1`` while any block table maps ``p``; the prefix index
      holds one extra pin on every registered page;
    * a page with ``rc > 1`` is **shared** and immutable — the engine
      must :meth:`ensure_block` before any write, which forks a private
      copy (copy-on-write) or maps a fresh page for a new block;
    * eviction only unpins index-registered pages nobody maps
      (``rc == 1``), oldest registration first.
    """

    def __init__(self, n_pages: int, page_size: int, nblocks: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.nblocks = nblocks
        self._free = list(range(n_pages - 1, 0, -1))     # pop() -> 1, 2, ...
        self.rc = np.zeros(n_pages, np.int32)
        self.bt: dict = {}                               # slot -> [nblocks]
        self._index: dict = {}                           # digest -> page
        self._rev: dict = {}                             # page -> digest
        self._order: List[str] = []                      # registration FIFO
        self.peak_pages = 0
        self.hits = 0                                    # prefix page hits
        self.cow_forks = 0
        self.evictions = 0
        self.allocs = 0

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - len(self._free)

    # -- allocation -------------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            self._evict_one()
        if not self._free:
            raise PageExhausted(
                f"page pool exhausted ({self.n_pages - 1} pages, "
                f"{len(self._index)} registered prefixes all still mapped)")
        p = self._free.pop()
        self.rc[p] = 1
        self.allocs += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return p

    def decref(self, p: int) -> None:
        self.rc[p] -= 1
        if self.rc[p] == 0:
            self._free.append(p)

    def _evict_one(self) -> None:
        """Unpin the oldest registered prefix page nobody maps."""
        for d in self._order:
            p = self._index[d]
            if self.rc[p] == 1:                          # index pin only
                self._order.remove(d)
                del self._index[d]
                del self._rev[p]
                self.rc[p] = 0
                self._free.append(p)
                self.evictions += 1
                return

    # -- per-slot block tables -------------------------------------------
    def new_slot(self, slot: int, mapped: List[int]) -> np.ndarray:
        """Open ``slot`` with ``mapped`` prefix pages; returns the bt row."""
        row = np.zeros(self.nblocks, np.int32)
        row[:len(mapped)] = mapped
        self.bt[slot] = row
        return row

    def free_slot(self, slot: int) -> None:
        for p in self.bt.pop(slot, []):
            if p:
                self.decref(int(p))

    def ensure_block(self, slot: int, block: int) -> Optional[Tuple]:
        """Make ``slot``'s ``block`` writable before a step touches it.

        Returns ``None`` (already private), ``("alloc", 0, page)`` (a
        fresh page was mapped), or ``("cow", src, dst)`` (a shared page
        was forked — the engine must copy ``src → dst`` on the device).
        """
        page = int(self.bt[slot][block])
        if page == 0:
            p = self.alloc()
            self.bt[slot][block] = p
            return ("alloc", 0, p)
        if self.rc[page] > 1:
            dst = self.alloc()
            self.rc[page] -= 1
            self.bt[slot][block] = dst
            self.cow_forks += 1
            return ("cow", page, dst)
        return None

    # -- fault injection --------------------------------------------------
    def grab(self, n: int) -> List[int]:
        """Hold up to ``n`` pages hostage (forced exhaustion in tests).
        Grabbed pages are allocated but mapped by no block table;
        :meth:`ungrab` returns them.  Stops early, without raising, when
        the arena runs dry."""
        out: List[int] = []
        for _ in range(n):
            try:
                out.append(self.alloc())
            except PageExhausted:
                break
        return out

    def ungrab(self, pages: List[int]) -> None:
        """Release pages held by :meth:`grab` back to the free list."""
        for p in pages:
            self.decref(int(p))

    # -- prompt-prefix sharing -------------------------------------------
    @staticmethod
    def _page_bytes(tokens, i: int, P: int) -> bytes:
        return np.asarray(tokens[i * P:(i + 1) * P], np.int64).tobytes()

    def match_prefix(self, tokens) -> Tuple[List[int], int]:
        """Longest registered page-prefix of ``tokens``; increfs the hits.

        Returns ``(pages, shared_len)``.  ``shared_len`` is capped at
        ``len(tokens) - 1`` — at least one prompt token must run through
        the model to produce the first logits — so a fully registered
        prompt keeps its last matched page mapped but recomputes (and
        copy-on-write rewrites) its final row.
        """
        P = self.page_size
        L_ = len(tokens)
        h = hashlib.sha1()
        pages: List[int] = []
        for i in range(L_ // P):
            h.update(self._page_bytes(tokens, i, P))
            p = self._index.get(h.hexdigest())
            if p is None:
                break
            pages.append(p)
        shared_len = min(len(pages) * P, L_ - 1)
        for p in pages:
            self.rc[p] += 1
        self.hits += len(pages)
        return pages, shared_len

    def register_prefix(self, slot: int, tokens) -> int:
        """Index ``slot``'s full prompt pages for future admissions.

        Called once the prompt is fully stored (final prefill chunk).
        Each newly registered page gains the index pin; already known
        digests keep their page.  Returns the number of pages registered.
        """
        P = self.page_size
        h = hashlib.sha1()
        n = 0
        for i in range(len(tokens) // P):
            h.update(self._page_bytes(tokens, i, P))
            d = h.hexdigest()
            if d in self._index:
                continue
            p = int(self.bt[slot][i])
            if p == 0:
                break
            self._index[d] = p
            self._rev[p] = d
            self._order.append(d)
            self.rc[p] += 1
            n += 1
        return n

    def stats(self) -> dict:
        return {
            "page_cache_hits": self.hits,
            "page_cow_forks": self.cow_forks,
            "page_evictions": self.evictions,
            "pages_allocated": self.allocs,
            "pages_in_use": self.pages_in_use,
            "pages_in_use_peak": self.peak_pages,
            "pages_registered": len(self._index),
        }
