"""Continuous-batching decode engine over a fixed slot array.

The port of ``repro.serve.engine`` for single-device, slot-major serving.
A request's lifecycle:

  queued → admitted into a free slot (prefill) → decoding at its own
  position → finished (EOS or its own ``max_new``) → slot freed →
  next queued request admitted **mid-decode**.

Every device step has fixed shapes:

* decode runs over all ``max_slots`` rows each step with a per-slot
  position vector (``transformer.decode_step`` with ``pos: [B]``).  Free
  slots decode garbage into their own cache rows; rows are independent,
  and admission overwrites the row anyway.
* whole-prompt mode (``prefill_chunk=0``) groups queued requests of equal
  prompt length into one prefill batch — no padding — and inserts the
  fresh cache into pool rows (``kv_pool.insert``, packed in packed mode).
* chunked mode (``prefill_chunk=C > 0``) admits any queued request into
  any free slot immediately, and each engine step runs ONE ``C``-token
  prefill chunk for the oldest prefilling slot, interleaved with the
  decode batch.  While a slot is mid-prefill the decode append is masked
  off for it (``append_mask``), so its pool row and controller state stay
  as a solo run would leave them.

* paged mode (``page_size=P > 0``, :mod:`repro_torch.serve.paged`)
  forces chunked prefill (``C`` defaults to ``P``).  A request's first
  chunk maps its block table, sharing any registered prompt-prefix pages
  (``PageAllocator.match_prefix``); before every chunk and every decode
  append the engine makes the blocks it will write private — a fresh
  page at a block boundary, a copy-on-write fork of a shared page — and
  the final chunk registers the prompt's full pages for later requests.
* **preemption under page exhaustion** (paged mode): when the arena runs
  dry the engine evicts the youngest decoding request (else the youngest
  prefilling one, never the requester), releases its pages, and requeues
  it at the front with its generated tokens carried as prompt suffix
  (``Request.carry``); it re-prefills and resumes where it stopped.  A
  request preempted more than ``max_preempts`` times, or a requester with
  no sibling to evict, resolves ``FAILED``.

Sampling draws from per-request threefry streams keyed ``(seed, uid,
absolute position)`` (:mod:`repro_torch.serve.sampler`), and a
stochastic packed pool (``CacheQuantConfig(stochastic=True)``) seeds
each slot's rounding chains from the same request key, so a request's
tokens do not depend on what else is batched with it.  A paged pool
under stochastic rounding shares no prefix pages: a shared page cannot
replay two requests' rounding streams.

Each step makes one device-to-host transfer: the sampled tokens with
their NaN/Inf flags (``sampler.guard_logits``).  A flagged slot resolves
``FAILED`` with its clean prefix; ``run()`` out of step budget resolves
every in-flight request ``TIMED_OUT`` (a queued preempted one
``PREEMPTED``) with its harvested tokens.

Not in this slice: admission control and deadlines, fault injection,
tracing and numerics logging, meshes.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.scale import ScaleState
from repro_torch.models import transformer as T

from . import kv_pool, metrics, paged, sampler


class RequestStatus(enum.Enum):
    """Terminal state of a request."""

    OK = "ok"                  # finished: EOS or its max_new budget
    TIMED_OUT = "timed_out"    # run() ran out of steps
    PREEMPTED = "preempted"    # evicted for pages, still queued at drain end
    FAILED = "failed"          # quarantined: NaN/Inf logits, or page
    #                            exhaustion with no victim


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens``: 1-D prompt ids.

    ``carry`` holds tokens generated before a preemption (they ride along
    as prompt suffix on requeue and lead the final result); ``n_preempt``
    counts evictions.
    """

    uid: int
    tokens: np.ndarray
    max_new: int = 16
    eos_id: Optional[int] = None
    carry: Tuple[int, ...] = ()
    n_preempt: int = 0


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """:class:`ServeEngine` knobs beyond the model triple and slot geometry.

    ``cache_bits`` 0 → float32 KV pool, 8/16 → DFXP-packed mantissas;
    ``cache_cfg`` overrides the packed pool's controller settings;
    ``sampler_cfg`` is greedy, temperature or top-k; ``seed`` is the
    engine seed that keys every request's sampling and cache-rounding
    streams (with the request's uid); ``init_exp`` is
    every scale group's log2-step; ``prefill_chunk`` is the chunk size
    ``C`` (``None`` takes ``policy.prefill_chunk``, 0 is whole-prompt).
    ``page_size`` ``P > 0`` (``None`` takes ``policy.page_size``) switches
    to the paged pool and forces chunked prefill; ``n_pages`` is its page
    budget (default: full residency plus the null page), below which
    exhaustion preempts; a request evicted ``max_preempts`` times resolves
    ``FAILED`` at the next eviction.
    """

    cache_bits: int = 0
    sampler_cfg: sampler.SamplerConfig = sampler.SamplerConfig()
    cache_cfg: Optional[kv_pool.CacheQuantConfig] = None
    seed: int = 0
    init_exp: float = -6.0
    prefill_chunk: Optional[int] = None
    page_size: Optional[int] = None
    n_pages: Optional[int] = None
    max_preempts: int = 4


class ServeEngine:
    """Continuous-batching engine over ``max_slots`` concurrent sequences.

    ``ServeEngine(cfg, policy, params, max_slots=…, max_len=…,
    options=EngineOptions(…), device=…)``.  ``params`` must already live
    on ``device`` (default ``cuda``); every request needs ``prompt_len +
    max_new <= max_len``.  With ``policy.fused_decode`` the attention runs
    the hand-written flash-decode and flash-prefill kernels on the pool's
    storage (their paged variants on a paged pool).
    """

    def __init__(self, cfg: T.ModelConfig, policy: PrecisionPolicy, params,
                 *, max_slots: int, max_len: int,
                 options: Optional[EngineOptions] = None, device=None):
        opts = options or EngineOptions()
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.device = resolve_device(device)
        leaf = params["final_norm"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine runs "
                             f"on {self.device}")
        self.cfg, self.policy, self.params = cfg, policy, params
        self.max_slots, self.max_len = max_slots, max_len
        self.options = opts
        self.sampler_cfg = opts.sampler_cfg
        self.seed = opts.seed
        gs = T.group_shapes(cfg)
        self.exps = ScaleState.create(gs, opts.init_exp,
                                      device=self.device).exps

        kvp = kv_pool.make_kv_pool(
            cfg, policy, max_slots=max_slots, max_len=max_len,
            cache_bits=opts.cache_bits, cache_cfg=opts.cache_cfg,
            page_size=opts.page_size, n_pages=opts.n_pages,
            device=self.device)
        self.kv = kvp
        self.codec = kvp.codec
        self.cache_cfg = kvp.cache_cfg
        self.page_size = kvp.page_size
        self.max_preempts = opts.max_preempts
        self._packed = kvp.packed
        self._paged = kvp.paged
        self._pool = kvp.pool
        self._stochastic = bool(self._packed and self.cache_cfg.stochastic)
        if self._paged:
            self._alloc = paged.PageAllocator(kvp.total_pages,
                                              self.page_size, kvp.nblocks)
            # a shared page cannot replay two requests' stochastic PRNG
            # chains: sharing off, copy-on-write and paging still on
            self._share_prefix = not self._stochastic

        B = max_slots
        self._tok = np.zeros(B, np.int32)
        self._pos = np.zeros(B, np.int32)
        self._keys = np.zeros((B, 2), np.int64)   # request keys per slot
        self._active = np.zeros(B, bool)
        self._reqs: List[Optional[Request]] = [None] * B
        self._gen: List[List[int]] = [[] for _ in range(B)]
        self._seq = np.zeros(B, np.int64)     # admission order (victim pick)
        self._admit_counter = 0
        self._queue: collections.deque = collections.deque()
        self._results: Dict[int, np.ndarray] = {}
        self._status: Dict[int, RequestStatus] = {}
        self._next_uid = 0
        self._budget = 1 << 62                # run() tightens this
        self._auto_budget = True
        self._ovf = np.zeros(3, np.float64)   # harvested at request finish
        self.metrics = metrics.ServeMetrics()

        pc = opts.prefill_chunk if opts.prefill_chunk is not None else \
            int(getattr(policy, "prefill_chunk", 0))
        if self._paged and not pc:
            pc = self.page_size   # paged mode always prefills in chunks
        self.prefill_chunk = pc
        self._pfill = np.zeros(B, np.int32)       # prefill frontier per slot
        self._pstarted = np.zeros(B, bool)        # paged: block table mapped
        self._prefilling: collections.deque = collections.deque()  # slot FIFO

    # -- device steps --------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _request_key(self, uid: int) -> np.ndarray:
        """The root key of request ``uid``'s streams, computed on the
        host once a request; zeros where nothing draws from it (a greedy
        sampler over a deterministic pool)."""
        if not self._stochastic and self.sampler_cfg.kind == "greedy":
            return np.zeros(2, np.int64)
        return sampler.request_key(self.seed, uid).numpy()

    def _draw(self, keys: np.ndarray, pos) -> dict:
        """:meth:`_sample`'s keyword for rows with request keys ``keys``
        [B, 2] drawing their tokens at absolute positions ``pos`` [B]:
        none for greedy, which draws nothing."""
        if self.sampler_cfg.kind == "greedy":
            return {}
        return {"draw": (keys, pos)}

    def _sample(self, logits, draw=None):
        """Shared tail: sentinel → sample, fetched as one host transfer.
        ``draw`` (from :meth:`_draw`) keys a sampled row's token on its
        request and position."""
        safe, bad = sampler.guard_logits(logits)
        pkeys = None
        if draw is not None:
            pkeys = sampler.position_keys(self._dev(draw[0]),
                                          self._dev(draw[1]))
        tok = sampler.sample(safe, pkeys, self.sampler_cfg)
        out = torch.stack([tok, bad.to(torch.int32)]).cpu().numpy()
        return out[0], out[1].astype(bool)

    @torch.no_grad()
    def _prefill_impl(self, tokens, keys):
        logits, _, cache = T.prefill(self.cfg, self.policy, self.params,
                                     {"tokens": tokens}, self.exps,
                                     max_cache_len=self.max_len)
        # the first generated token sits at absolute position L
        L = np.full(tokens.shape[0], tokens.shape[1], np.int32)
        first, bad = self._sample(logits, **self._draw(keys, L))
        return first, bad, cache

    @torch.no_grad()
    def _insert_impl(self, entry, slots, keys):
        kv_pool.insert(self._pool, entry, slots, self.codec,
                       self._dev(keys) if self._stochastic else None)

    @torch.no_grad()
    def _decode_impl(self, mask=None):
        logits, _, self._pool = T.decode_step(
            self.cfg, self.policy, self.params, self._pool,
            self._dev(self._tok), self._dev(self._pos), self.exps,
            kv_codec=self.codec, append_mask=mask)
        return self._sample(logits, **self._draw(self._keys, self._pos + 1))

    @torch.no_grad()
    def _chunk_impl(self, tokens, slot: int, p0: int, n_valid: int):
        """One prefill chunk for one slot. ``tokens``: [1, C] (padded).

        The slot's rows are views into the pool (a paged pool passes its
        page arenas whole), so the chunk's in-place cache update lands in
        the pool directly."""
        sub = paged.slice_slot(self._pool, slot)
        logits, _, sub = T.prefill_chunk_step(
            self.cfg, self.policy, self.params, sub, self._dev(tokens),
            self._dev([p0]).to(torch.int32),
            self._dev([n_valid]).to(torch.int32), self.exps,
            kv_codec=self.codec)
        paged.merge_slot(self._pool, sub, slot)
        # the chunk's token sits at absolute position p0 + n_valid (the
        # prompt length on the final chunk), as whole-prompt prefill's
        return self._sample(logits, **self._draw(
            self._keys[slot:slot + 1], np.array([p0 + n_valid], np.int32)))

    # -- request lifecycle ---------------------------------------------------
    def submit(self, prompt, max_new: int = 16,
               eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its uid.  Malformed requests (empty
        prompt, zero budget, over capacity) raise."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new {max_new} exceeds "
                f"max_len {self.max_len}")
        uid = self._next_uid
        self._next_uid += 1
        self.metrics.on_submit(uid, prompt.size)
        self._queue.append(Request(uid, prompt, max_new, eos_id))
        self.metrics.observe_queue_depth(len(self._queue))
        return uid

    def status(self, uid: int) -> Optional[RequestStatus]:
        """Terminal status of ``uid`` (None while queued / in flight)."""
        return self._status.get(uid)

    @property
    def statuses(self) -> Dict[int, RequestStatus]:
        return dict(self._status)

    @property
    def results(self) -> Dict[int, np.ndarray]:
        """Generated ids of every resolved request, by uid."""
        return dict(self._results)

    def _release_slot(self, slot: int) -> None:
        """Drop the slot's host state and (paged) its page references."""
        if self._paged:
            # registered prefix pages stay resident for reuse; everything
            # else decrefs back to the free list
            self._alloc.free_slot(slot)
            self._pstarted[slot] = False
        if slot in self._prefilling:
            self._prefilling.remove(slot)
        self._active[slot] = False
        self._reqs[slot] = None
        self._gen[slot] = []

    def _finish(self, slot: int,
                status: RequestStatus = RequestStatus.OK) -> None:
        req = self._reqs[slot]
        self._results[req.uid] = np.asarray(
            list(req.carry) + self._gen[slot], np.int32)
        self._status[req.uid] = status
        self.metrics.on_finish(req.uid, status.value)
        # harvest before the page release makes the reads stale, and only
        # if this request wrote the slot: one resolved before its first
        # chunk would count the previous occupant's counters
        started = not self.prefill_chunk or (
            self._pstarted[slot] if self._paged else self._pfill[slot] > 0)
        if self._packed and started:
            self._ovf += kv_pool.slot_totals(self._pool, slot).cpu().numpy()
        self._release_slot(slot)

    def _finish_queued(self, req: Request, status: RequestStatus) -> None:
        """Resolve a request that never (re)reached a slot."""
        self._results[req.uid] = np.asarray(list(req.carry), np.int32)
        self._status[req.uid] = status
        self.metrics.on_finish(req.uid, status.value)

    def _maybe_finish(self, slot: int, tok: int) -> bool:
        """Finish the slot if its budget is spent or ``tok`` is its EOS."""
        req = self._reqs[slot]
        if len(self._gen[slot]) >= req.max_new or \
                (req.eos_id is not None and tok == req.eos_id):
            self._finish(slot)
            return True
        return False

    # -- preemption ----------------------------------------------------------
    def _preempt(self, victim: int) -> None:
        """Evict ``victim`` to the queue front, tokens-so-far carried.

        The requeued request's prompt is ``original prompt + generated
        tokens``: re-admission chunk-prefills it (sharing any still
        registered prefix pages) and samples its next token at absolute
        position ``len(prompt) + len(carry)``, so a greedy stream resumes
        where it stopped.  A request past ``max_preempts`` resolves FAILED
        instead (the thrash bound).
        """
        req = self._reqs[victim]
        if req.n_preempt >= self.max_preempts:
            self._finish(victim, RequestStatus.FAILED)
            return
        gen = self._gen[victim]
        tokens = np.concatenate(
            [req.tokens, np.asarray(gen, np.int32)]) if gen else req.tokens
        nr = Request(req.uid, tokens, req.max_new - len(gen), req.eos_id,
                     carry=tuple(req.carry) + tuple(gen),
                     n_preempt=req.n_preempt + 1)
        self._release_slot(victim)
        self._queue.appendleft(nr)
        self._status[req.uid] = RequestStatus.PREEMPTED
        self.metrics.on_preempt(req.uid)
        if self._auto_budget:
            # the requeue re-prefills and re-decodes: extend the drain
            # budget so an auto-budgeted run() still ends cleanly
            self._budget += (-(-int(tokens.size) // self.prefill_chunk)
                             + nr.max_new + 2)

    def _handle_exhaustion(self, slot: int) -> bool:
        """Free pages for ``slot`` by preempting a sibling.

        Victim order: the youngest *decoding* request first (least sunk
        cost, shortest re-prefill), then the youngest prefilling one.
        Never the requester itself: its re-admission would need at least
        the pages it holds.  Returns False when no sibling exists.
        """
        cands = [s for s in range(self.max_slots)
                 if s != slot and self._reqs[s] is not None
                 and self._active[s]]
        if not cands:
            cands = [s for s in range(self.max_slots)
                     if s != slot and self._reqs[s] is not None]
        if not cands:
            return False
        self._preempt(max(cands, key=lambda s: self._seq[s]))
        return True

    def _ensure_blocks(self, slot: int, start: int, n: int) -> None:
        """Paged mode: make the blocks covering rows ``[start, start+n)``
        privately writable — allocate fresh pages at block boundaries and
        fork (copy-on-write) shared pages the slot is about to write."""
        P = self.page_size
        for b in range(start // P, (start + n - 1) // P + 1):
            act = self._alloc.ensure_block(slot, b)
            if act is None:
                continue
            kind, src, dst = act
            if kind == "cow":
                paged.cow_page(self._pool, src, dst)
            paged.set_block(self._pool, slot, b, dst)

    def _ensure_blocks_safe(self, slot: int, start: int, n: int) -> bool:
        """:meth:`_ensure_blocks` that answers exhaustion with preemption.

        Retries after each preemption (freed pages recycle at once;
        ``ensure_block`` is idempotent for blocks already made private).
        When no victim remains the requester resolves FAILED with its
        harvested tokens and this returns False.
        """
        while True:
            try:
                self._ensure_blocks(slot, start, n)
                return True
            except paged.PageExhausted:
                if not self._handle_exhaustion(slot):
                    self._finish(slot, RequestStatus.FAILED)
                    return False

    # -- admission -----------------------------------------------------------
    def _mark_admitted(self, slot: int, req: Request) -> None:
        self._admit_counter += 1
        self._seq[slot] = self._admit_counter
        self.metrics.on_admit(req.uid)

    def _admit(self) -> None:
        """Fill free slots from the queue, grouping equal prompt lengths."""
        free = list(np.where(~self._active)[0])
        while self._queue and free:
            plen = self._queue[0].tokens.size
            group: List[Request] = []
            while (self._queue and len(group) < len(free)
                   and self._queue[0].tokens.size == plen):
                group.append(self._queue.popleft())
            slots = [int(free.pop(0)) for _ in group]
            tokens = self._dev(np.stack([r.tokens for r in group]))
            keys = np.stack([self._request_key(r.uid) for r in group])
            first, bad, entry = self._prefill_impl(tokens, keys)
            self._insert_impl(entry, self._dev(slots), keys)
            for r, s, tok, b, key in zip(group, slots, first, bad, keys):
                self._mark_admitted(s, r)
                self._reqs[s], self._gen[s] = r, []
                self._tok[s], self._pos[s] = tok, plen
                self._keys[s] = key
                self._active[s] = True
                if b:   # NaN/Inf prefill logits: quarantine at admission
                    self._finish(s, RequestStatus.FAILED)
                    free.append(s)
                    continue
                self.metrics.on_token(r.uid)
                self._gen[s] = [int(tok)]
                if self._maybe_finish(s, int(tok)):
                    free.append(s)

    def _admit_chunked(self) -> None:
        """Assign queued requests to free slots immediately (no grouping,
        no prefill compute yet — chunks run one per engine step)."""
        free = [s for s in range(self.max_slots) if self._reqs[s] is None]
        while self._queue and free:
            r = self._queue.popleft()
            s = free.pop(0)
            self._reqs[s] = r
            self._pfill[s] = 0
            self._pstarted[s] = False
            self._pos[s] = 0
            self._gen[s] = []
            self._active[s] = False
            self._keys[s] = self._request_key(r.uid)
            if self._stochastic:
                # seed the slot's cache PRNG chains before its first chunk
                kv_pool.seed_slot_keys(self._pool, s,
                                       self._dev(self._keys[s]))
            self._prefilling.append(s)
            self._mark_admitted(s, r)

    def _step_prefill_chunk(self) -> None:
        """Run ONE chunk for the oldest prefilling slot (FIFO)."""
        if not self._prefilling:
            return
        s = self._prefilling[0]
        r = self._reqs[s]
        if self._paged and not self._pstarted[s]:
            # first chunk of this request: map its block table, reusing any
            # registered prefix pages (refcounted, read-only until a write
            # forks them).  FIFO chunk order means an earlier request
            # registers its prefix before a later one's first chunk looks.
            pages, shared = (self._alloc.match_prefix(r.tokens)
                             if self._share_prefix else ([], 0))
            row = self._alloc.new_slot(s, pages)
            paged.reset_slot(self._pool, s, shared, row, float(shared))
            self._pfill[s] = shared   # shared rows are already written
            self._pstarted[s] = True
        f = int(self._pfill[s])
        C = self.prefill_chunk
        n = min(C, r.tokens.size - f)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = r.tokens[f:f + n]
        if self._paged and not self._ensure_blocks_safe(s, f, n):
            return                    # requester failed: no victim left
        first, bad = self._chunk_impl(toks, s, f, n)
        self._pfill[s] = f + n
        self._pos[s] = f + n          # frontier (RoPE-safe while masked)
        self.metrics.on_prefill_chunk(r.uid)
        if f + n == r.tokens.size:    # final chunk: first token sampled
            self._prefilling.popleft()
            if self._paged and self._share_prefix:
                self._alloc.register_prefix(s, r.tokens)
            self._active[s] = True
            if bad[0]:
                self._finish(s, RequestStatus.FAILED)
                return
            tok = int(first[0])
            self.metrics.on_token(r.uid)
            self._gen[s] = [tok]
            self._tok[s] = tok
            self._maybe_finish(s, tok)

    def step(self) -> None:
        """Admit what fits, run one prefill chunk (chunked mode), then
        decode one token on every active slot."""
        if self.prefill_chunk:
            self._admit_chunked()
            self._step_prefill_chunk()
        else:
            self._admit()
        if self._paged:
            # each active slot appends one row at _pos this step: a fresh
            # page at a block boundary, a fork if still shared; exhaustion
            # preempts the youngest sibling and never raises
            for s in np.where(self._active)[0]:
                s = int(s)
                if self._active[s]:   # an earlier preemption may clear it
                    self._ensure_blocks_safe(s, int(self._pos[s]), 1)
        if not self._active.any():
            return
        mask = self._dev(self._active) if self.prefill_chunk else None
        nxt, bad = self._decode_impl(mask)
        self.metrics.on_decode_step()
        for s in np.where(self._active)[0]:
            s = int(s)
            if bad[s]:
                # NaN/Inf decode logits: drop the poisoned token,
                # quarantine the request, keep siblings untouched
                self._finish(s, RequestStatus.FAILED)
                continue
            tok = int(nxt[s])
            self._gen[s].append(tok)
            self._pos[s] += 1
            self._tok[s] = tok
            self.metrics.on_token(self._reqs[s].uid)
            self._maybe_finish(s, tok)

    def _drain_timeout(self) -> None:
        """Out of steps: resolve everything in flight instead of raising.

        In-flight slots resolve TIMED_OUT with every harvested token;
        queued requests resolve TIMED_OUT, except preempted ones, which
        keep PREEMPTED (they had a slot and lost it)."""
        for s in range(self.max_slots):
            if self._reqs[s] is not None:
                self._finish(s, RequestStatus.TIMED_OUT)
        while self._queue:
            r = self._queue.popleft()
            self._finish_queued(r, RequestStatus.PREEMPTED if r.n_preempt
                                else RequestStatus.TIMED_OUT)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive until the queue drains; returns ``{uid: generated ids}``.

        When the step budget runs out (``max_steps``, or the automatic
        budget on a wedged engine) every in-flight request resolves
        ``TIMED_OUT`` with its harvested tokens.
        """
        if max_steps is not None:
            self._budget = max_steps
            self._auto_budget = False
        else:
            pending = list(self._queue) + [r for r in self._reqs
                                           if r is not None]
            chunks = 0
            if self.prefill_chunk:
                chunks = sum(-(-r.tokens.size // self.prefill_chunk)
                             for r in pending)
            self._budget = (sum(r.max_new for r in pending) + chunks
                            + len(self._queue) + self.max_slots + 4)
            self._auto_budget = True
        steps = 0
        while self._queue or self._prefilling or self._active.any():
            if steps >= self._budget:
                self._drain_timeout()
                break
            self.step()
            steps += 1
        return dict(self._results)

    # -- introspection -------------------------------------------------------
    def cache_stats(self) -> dict:
        """Append overflow rate over finished requests + in-flight slots."""
        live = kv_pool.overflow_summary(self._pool, self._active)
        ovf = self._ovf[0] + live["cache_overflow_rate"] * \
            live["cache_appends_quantized"]
        tot = self._ovf[2] + live["cache_appends_quantized"]
        return {"cache_overflow_rate": float(ovf / tot) if tot else 0.0,
                "cache_appends_quantized": float(tot)}

    def stats(self) -> dict:
        extra = self.cache_stats()
        if self._paged:
            extra.update(self._alloc.stats())
        return self.metrics.summary(extra=extra)
