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
* chunked mode (``prefill_chunk=C > 0``; dense attention models only,
  MoE, SSM and hybrid models keep the whole-prompt path) admits any
  queued request into any free slot immediately, and each engine step
  runs ONE ``C``-token prefill chunk for the oldest prefilling slot,
  interleaved with the decode batch.  While a slot is mid-prefill the decode append is masked
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

Robustness layer (admission control, deadlines, quarantine)
------------------------------------------------------------

* **admission control** — ``queue_cap`` bounds the queue: a submit
  beyond it resolves the request ``REJECTED`` with an empty result and
  never raises.  ``deadline_ms`` (the engine's default, overridable per
  submit) expires queued *and* in-flight requests to ``TIMED_OUT`` with
  whatever tokens they harvested.
* **numeric sentinels** — every step guards its logits on the device
  (``sampler.guard_logits``): a NaN/Inf row flags its slot, which
  resolves ``FAILED`` with its clean prefix while its siblings' streams
  go on untouched.  ``runaway_ovf`` adds the §5 runaway threshold: a
  slot whose cumulative cache overflow rate
  (``kv_pool.slot_overflow_rates``) exceeds it quarantines the same way.
* **drain timeout** — ``run()`` out of step budget resolves every
  in-flight request ``TIMED_OUT`` (a queued preempted one ``PREEMPTED``)
  with its harvested tokens.

Each step makes one device-to-host transfer: the sampled tokens with
their NaN/Inf flags and, with ``runaway_ovf`` set, the slots' overflow
rates (one float32 stack: the ids are below 2**24, so float32 holds them
exactly).  The deterministic fault injectors that drive this layer
(:mod:`repro_torch.serve.faults`) hook in through ``faults``; a
``tracer`` (:class:`repro_torch.obs.Tracer`) records the step's phases,
and a ``numerics_log`` the packed pool's §5 timeline.  With none of
``faults``, ``runaway_ovf``, ``tracer`` and ``numerics_log`` set, a step
issues the device operations of an engine without them.

Every request ends in one terminal :class:`RequestStatus`.  The engine
serves token-in decoders; it refuses an encoder-decoder or an
embeds-input model, as the reference's does.

**Sharded serving** (``dist=`` and ``mesh=``, a bound mesh of
:func:`repro_torch.launch.mesh.make_serve_mesh`): one engine per rank,
SPMD.  The weights stay replicated and every rank computes the same
activations; the KV pool is this rank's shard (kv heads over ``model``,
the ring window over ``data`` under CP, see
:func:`repro_torch.serve.kv_pool.make_kv_pool`), the attention layers
gather the heads before ``wo``, CP decode merges its softmax statistics
exactly, and MoE blocks run expert-parallel.  Every rank runs the same
schedule — deadlines read rank 0's clock — and samples
the same tokens: after each sample the ranks gather their tokens and
the engine raises if any differ (one small gather a step).  The results
a caller reads are rank 0's.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.scale import ScaleState
from repro_torch.dist import DistCtx, MeshConfigError, serve_pod_ctx
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import transformer as T

from . import kv_pool, metrics, paged, sampler


class RequestStatus(enum.Enum):
    """Terminal state of a request. The engine resolves every submitted
    uid to exactly one of these instead of raising mid-drain."""

    OK = "ok"                  # finished: EOS or its max_new budget
    REJECTED = "rejected"      # admission control: queue was full
    TIMED_OUT = "timed_out"    # deadline expired / drain ran out of steps
    PREEMPTED = "preempted"    # evicted for pages, still queued at drain end
    FAILED = "failed"          # quarantined: NaN/Inf logits, §5 runaway,
    #                            or page exhaustion with no victim


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens``: 1-D prompt ids.

    ``deadline`` is an absolute ``serve.metrics._now`` stamp (set by the
    engine from ``deadline_ms``); ``carry`` holds tokens generated before
    a preemption (they ride along as prompt suffix on requeue and lead
    the final result); ``n_preempt`` counts evictions.
    """

    uid: int
    tokens: np.ndarray
    max_new: int = 16
    eos_id: Optional[int] = None
    deadline: Optional[float] = None
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

    ``queue_cap`` bounds the waiting queue (a submit finding it full
    resolves ``REJECTED``; ``None`` is unbounded); ``deadline_ms`` is the
    default per-request deadline from submit (``None``: none);
    ``runaway_ovf`` is the §5 runaway threshold on a slot's cumulative
    cache overflow rate (``None`` disables it).  ``faults`` takes a
    :class:`repro_torch.serve.faults.FaultHarness`; ``tracer`` a
    :class:`repro_torch.obs.Tracer`; ``numerics_log`` a
    :class:`repro_torch.obs.NumericsLog` or a path for one (packed pools
    only), sampled every ``numerics_every`` engine steps (default: the
    pool controller's ``update_interval``).  The defaults build the bare
    engine.
    """

    cache_bits: int = 0
    sampler_cfg: sampler.SamplerConfig = sampler.SamplerConfig()
    cache_cfg: Optional[kv_pool.CacheQuantConfig] = None
    seed: int = 0
    init_exp: float = -6.0
    prefill_chunk: Optional[int] = None
    page_size: Optional[int] = None
    n_pages: Optional[int] = None
    queue_cap: Optional[int] = None
    deadline_ms: Optional[float] = None
    runaway_ovf: Optional[float] = None
    max_preempts: int = 4
    faults: object = None
    tracer: object = None
    numerics_log: object = None
    numerics_every: Optional[int] = None


_LEGACY_ENGINE_KWARGS = frozenset(
    f.name for f in dataclasses.fields(EngineOptions))


class ServeEngine:
    """Continuous-batching engine over ``max_slots`` concurrent sequences.

    ``ServeEngine(cfg, policy, params, max_slots=…, max_len=…,
    options=EngineOptions(…), device=…)``.  ``params`` must already live
    on ``device`` (default ``cuda``); every request needs ``prompt_len +
    max_new <= max_len``.  With ``policy.fused_decode`` the attention runs
    the hand-written flash-decode and flash-prefill kernels on the pool's
    storage (their paged variants on a paged pool).  Passing the options'
    fields as loose keyword arguments still works and warns
    (``DeprecationWarning``), as the reference's engine does; unknown
    keywords raise ``TypeError``.
    """

    def __init__(self, cfg: T.ModelConfig, policy: PrecisionPolicy, params,
                 *, max_slots: int, max_len: int,
                 options: Optional[EngineOptions] = None, device=None,
                 dist: Optional[DistCtx] = None, mesh=None, **legacy):
        if legacy:
            unknown = sorted(set(legacy) - _LEGACY_ENGINE_KWARGS)
            if unknown:
                raise TypeError(
                    f"ServeEngine got unexpected keyword arguments "
                    f"{unknown}")
            warnings.warn(
                "passing ServeEngine configuration as loose keyword "
                "arguments is deprecated; pass options=EngineOptions(...)",
                DeprecationWarning, stacklevel=2)
            options = dataclasses.replace(options or EngineOptions(),
                                          **legacy)
        opts = options or EngineOptions()
        if cfg.input_mode != "tokens" or cfg.encoder_layers:
            raise ValueError("ServeEngine serves token-in decoder models")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if dist is None and mesh is not None:
            # derive the serving context from the mesh's axis sizes
            dist = serve_pod_ctx(tp=int(mesh.shape.get("model", 1)),
                                 cp=int(mesh.shape.get("data", 1)))
        self.dist = dist or DistCtx()
        self.mesh = mesh
        if self.dist.active and mesh is None:
            raise MeshConfigError(
                "an active DistCtx needs the mesh it names; pass "
                "mesh=launch.mesh.make_serve_mesh(...)")
        self._check_ranks = mesh is not None and mesh.size > 1
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
        self.queue_cap = opts.queue_cap
        self.deadline_ms = opts.deadline_ms
        self.runaway_ovf = opts.runaway_ovf
        self._faults = opts.faults
        gs = T.group_shapes(cfg)
        self.exps = ScaleState.create(gs, opts.init_exp,
                                      device=self.device).exps

        with use_mesh(mesh):
            kvp = kv_pool.make_kv_pool(
                cfg, policy, self.dist, max_slots=max_slots,
                max_len=max_len, cache_bits=opts.cache_bits,
                cache_cfg=opts.cache_cfg, page_size=opts.page_size,
                n_pages=opts.n_pages, mesh=mesh, device=self.device)
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
        self._step_idx = 0
        self._budget = 1 << 62                # run() tightens this
        self._auto_budget = True
        self._ovf = np.zeros(3, np.float64)   # harvested at request finish
        self.metrics = metrics.ServeMetrics()

        # observability: every hook guards on `is not None`, so with none
        # attached a step records nothing and syncs nothing more
        self._tracer = opts.tracer
        if self._tracer is not None and self._faults is not None and \
                getattr(self._faults, "tracer", None) is None:
            self._faults.tracer = self._tracer  # injections on the trace
        numerics_log = opts.numerics_log
        if isinstance(numerics_log, str):
            from repro_torch.obs import NumericsLog
            numerics_log = NumericsLog(numerics_log)
        self._numerics = numerics_log if self._packed else None
        if opts.numerics_every is not None:
            self._num_every = max(int(opts.numerics_every), 1)
        elif self._packed:
            self._num_every = max(int(self.cache_cfg.update_interval), 1)
        else:
            self._num_every = 1
        self._num_prev: Optional[dict] = None

        pc = opts.prefill_chunk if opts.prefill_chunk is not None else \
            int(getattr(policy, "prefill_chunk", 0))
        if self._paged and not pc:
            pc = self.page_size   # paged mode always prefills in chunks
        # chunked prefill: attention-family only (MoE capacity and SSM
        # state couple a whole prompt; they keep the whole-prompt path,
        # as in the reference, whatever chunk was asked for)
        chunkable = cfg.family == "dense" and not cfg.num_experts
        self.prefill_chunk = pc if chunkable else 0
        # MoE prefill routes with a capacity computed over the whole
        # batch, so batching prompts would couple their routing: admit one
        # at a time, as the reference's engine does
        self._admit_group_cap = 1 if cfg.num_experts else max_slots
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

    def _sample(self, logits, draw=None, rate=None):
        """Shared tail: sentinel → sample, fetched as one host transfer.
        ``draw`` (from :meth:`_draw`) keys a sampled row's token on its
        request and position.  ``rate`` (f32 [B], the slots' overflow
        rates) rides in the same transfer and comes back third."""
        safe, bad = sampler.guard_logits(logits)
        pkeys = None
        if draw is not None:
            pkeys = sampler.position_keys(self._dev(draw[0]),
                                          self._dev(draw[1]))
        tok = sampler.sample(safe, pkeys, self.sampler_cfg)
        if self._check_ranks:
            drawn = self.mesh.gather_list(tok, self.mesh.axis_names)
            if any(not torch.equal(drawn[0], t) for t in drawn[1:]):
                raise RuntimeError(
                    f"ranks sampled different tokens at step "
                    f"{self._step_idx}: {[t.tolist() for t in drawn]}")
        if rate is None:
            out = torch.stack([tok, bad.to(torch.int32)]).cpu().numpy()
            return out[0], out[1].astype(bool)
        out = torch.stack([tok.to(torch.float32), bad.to(torch.float32),
                           rate]).cpu().numpy()
        return out[0].astype(np.int32), out[1] != 0, out[2]

    @torch.no_grad()
    def _prefill_impl(self, tokens, keys):
        logits, _, cache = T.prefill(self.cfg, self.policy, self.params,
                                     {"tokens": tokens}, self.exps,
                                     max_cache_len=self.max_len,
                                     dist=self.dist)
        # the first generated token sits at absolute position L
        L = np.full(tokens.shape[0], tokens.shape[1], np.int32)
        first, bad = self._sample(logits, **self._draw(keys, L))
        return first, bad, cache

    @torch.no_grad()
    def _insert_impl(self, entry, slots, keys):
        kv_pool.insert(self._pool, entry, slots, self.codec,
                       self._dev(keys) if self._stochastic else None,
                       shardings=self.kv.shardings)

    @torch.no_grad()
    def _decode_impl(self, mask=None, nan_mask=None):
        """One decode step over every slot: ``(tokens, bad, rates)``,
        ``rates`` None unless ``runaway_ovf`` is set.  ``nan_mask`` (the
        fault harness's) poisons its rows' logits on the device, before
        the sentinel, as a real blowup would reach it."""
        logits, _, self._pool = T.decode_step(
            self.cfg, self.policy, self.params, self._pool,
            self._dev(self._tok), self._dev(self._pos), self.exps,
            kv_codec=self.codec, append_mask=mask, dist=self.dist)
        if nan_mask is not None:
            logits = torch.where(self._dev(nan_mask)[:, None], torch.nan,
                                 logits)
        draw = self._draw(self._keys, self._pos + 1)
        if self.runaway_ovf is None:
            return (*self._sample(logits, **draw), None)
        rate = kv_pool.slot_overflow_rates(self._pool, self.max_slots)
        return self._sample(logits, rate=rate, **draw)

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
            kv_codec=self.codec, dist=self.dist)
        paged.merge_slot(self._pool, sub, slot)
        # the chunk's token sits at absolute position p0 + n_valid (the
        # prompt length on the final chunk), as whole-prompt prefill's
        return self._sample(logits, **self._draw(
            self._keys[slot:slot + 1], np.array([p0 + n_valid], np.int32)))

    # -- request lifecycle ---------------------------------------------------
    def submit(self, prompt, max_new: int = 16,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Queue one request; returns its uid.

        Malformed requests (empty prompt, zero budget, over capacity)
        raise: those are caller bugs, not load.  A full queue resolves the
        request ``REJECTED`` at once (empty result, no exception);
        ``deadline_ms`` (default: the engine's) stamps an expiry the
        scheduler enforces."""
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
        if self._tracer is not None:
            self._tracer.instant("submit", tid="requests", uid=uid,
                                 prompt_len=int(prompt.size))
        if self.queue_cap is not None and len(self._queue) >= self.queue_cap:
            self._results[uid] = np.zeros(0, np.int32)
            self._status[uid] = RequestStatus.REJECTED
            self.metrics.on_reject(uid)
            if self._tracer is not None:
                self._tracer.instant("reject", tid="requests", uid=uid)
            return uid
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        deadline = self._now() + dl / 1e3 if dl is not None else None
        self._queue.append(Request(uid, prompt, max_new, eos_id,
                                   deadline=deadline))
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
        if self._tracer is not None:
            self._tracer.instant("finish", tid="requests", uid=req.uid,
                                 slot=slot, status=status.value,
                                 new_tokens=len(self._gen[slot]))
        self._release_slot(slot)

    def _finish_queued(self, req: Request, status: RequestStatus) -> None:
        """Resolve a request that never (re)reached a slot."""
        self._results[req.uid] = np.asarray(list(req.carry), np.int32)
        self._status[req.uid] = status
        self.metrics.on_finish(req.uid, status.value)
        if self._tracer is not None:
            self._tracer.instant("finish", tid="requests", uid=req.uid,
                                 status=status.value)

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
        if self._tracer is None:
            self._preempt_impl(victim, req)
            return
        self._tracer.begin("preempt", uid=req.uid, slot=victim,
                           n_preempt=req.n_preempt)
        try:
            self._preempt_impl(victim, req)
        finally:
            self._tracer.end()

    def _preempt_impl(self, victim: int, req: Request) -> None:
        if req.n_preempt >= self.max_preempts:
            self._finish(victim, RequestStatus.FAILED)
            return
        gen = self._gen[victim]
        tokens = np.concatenate(
            [req.tokens, np.asarray(gen, np.int32)]) if gen else req.tokens
        nr = Request(req.uid, tokens, req.max_new - len(gen), req.eos_id,
                     deadline=req.deadline,
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

    # -- deadlines -----------------------------------------------------------
    def _now(self) -> float:
        """The scheduler's clock: on a mesh rank 0's, so every rank stamps
        and expires the same requests."""
        now = metrics._now()
        if self.mesh is None or self.mesh.size == 1:
            return now
        t = torch.tensor([now], dtype=torch.float64)
        return float(self.mesh.gather_list(t, self.mesh.axis_names)[0][0])

    def _expire_queue(self) -> None:
        # the clock is a collective on a mesh: read it only when a queued
        # request has a deadline (the same answer on every rank)
        if not any(r.deadline is not None for r in self._queue):
            return
        now = self._now()
        kept: collections.deque = collections.deque()
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                self._finish_queued(r, RequestStatus.TIMED_OUT)
            else:
                kept.append(r)
        self._queue = kept

    def _expire_inflight(self) -> None:
        stamped = [s for s in range(self.max_slots)
                   if self._reqs[s] is not None
                   and self._reqs[s].deadline is not None]
        if not stamped:
            return
        now = self._now()
        for s in stamped:
            if self._reqs[s] is not None and now > self._reqs[s].deadline:
                self._finish(s, RequestStatus.TIMED_OUT)

    # -- admission -----------------------------------------------------------
    def _mark_admitted(self, slot: int, req: Request) -> None:
        self._admit_counter += 1
        self._seq[slot] = self._admit_counter
        self.metrics.on_admit(req.uid)
        if self._tracer is not None:
            self._tracer.instant("admitted", tid="requests", uid=req.uid,
                                 slot=slot)

    def _admit(self) -> None:
        """Fill free slots from the queue, grouping equal prompt lengths."""
        free = list(np.where(~self._active)[0])
        while self._queue and free:
            if self._faults is not None and not self._faults.admit_ok(
                    self._queue[0].uid, self._step_idx):
                break
            plen = self._queue[0].tokens.size
            cap = min(len(free), self._admit_group_cap)
            group: List[Request] = []
            while (self._queue and len(group) < cap
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
        i = 0
        while self._queue and free and i < len(self._queue):
            r = self._queue[i]
            if self._faults is not None and not self._faults.admit_ok(
                    r.uid, self._step_idx):
                i += 1          # held back: later requests may still admit
                continue
            del self._queue[i]
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
        decode one token on every active slot (under the engine's mesh)."""
        with use_mesh(self.mesh):
            self._step()

    def _step(self) -> None:
        self._step_idx += 1
        tr = self._tracer
        if self._faults is not None:
            self._faults.on_step(self)
        self._expire_queue()
        if tr is not None:
            tr.begin("admit", queued=len(self._queue))
        if self.prefill_chunk:
            self._admit_chunked()
        else:
            self._admit()
        if tr is not None:
            tr.end()
        if self.prefill_chunk:
            if tr is None or not self._prefilling:
                self._step_prefill_chunk()
            else:
                s = self._prefilling[0]
                tr.begin("prefill_chunk", uid=self._reqs[s].uid, slot=int(s),
                         p0=int(self._pfill[s]))
                try:
                    self._step_prefill_chunk()
                finally:
                    tr.end()
        nan_mask = None
        if self._faults is not None and self._active.any():
            nan_mask = self._faults.nan_mask(self)
        if self._paged:
            # each active slot appends one row at _pos this step: a fresh
            # page at a block boundary, a fork if still shared; exhaustion
            # preempts the youngest sibling and never raises
            for s in np.where(self._active)[0]:
                s = int(s)
                if self._active[s]:   # an earlier preemption may clear it
                    self._ensure_blocks_safe(s, int(self._pos[s]), 1)
        if self._active.any():
            self._decode(nan_mask)
        self._expire_inflight()
        if tr is not None:
            tr.counter("queue", {"queue_depth": len(self._queue),
                                 "active_slots": int(self._active.sum())})
        if self._numerics is not None and \
                self._step_idx % self._num_every == 0:
            self._sample_numerics()

    def _decode(self, nan_mask) -> None:
        """Decode one token on every active slot and harvest it."""
        tr = self._tracer
        if tr is not None:
            tr.begin("decode_step", n_active=int(self._active.sum()))
        mask = self._dev(self._active) if self.prefill_chunk else None
        nxt, bad, rate = self._decode_impl(mask, nan_mask)
        self.metrics.on_decode_step()
        for s in np.where(self._active)[0]:
            s = int(s)
            if bad[s]:
                # NaN/Inf decode logits: drop the poisoned token,
                # quarantine the request, keep siblings untouched
                self._finish(s, RequestStatus.FAILED)
                continue
            if rate is not None and rate[s] > self.runaway_ovf:
                # §5 overflow runaway: the controller lost the race
                self._finish(s, RequestStatus.FAILED)
                continue
            tok = int(nxt[s])
            self._gen[s].append(tok)
            self._pos[s] += 1
            self._tok[s] = tok
            self.metrics.on_token(self._reqs[s].uid)
            self._maybe_finish(s, tok)
        if tr is not None:
            tr.end()

    def _sample_numerics(self) -> None:
        """One §5 numeric-health sample: the packed pool's exponents and
        overflow counters (``kv_pool.numerics_snapshot``) fetched in one
        transfer, diffed against the previous sample into per-slot
        records (controller up/down moves).  Runs only on the sampling
        cadence with a ``numerics_log`` attached."""
        from repro_torch.obs import serve_records
        with torch.no_grad():
            snap = kv_pool.numerics_snapshot(self._pool, self.max_slots)
            leaves = [(e, n, t) for e, d in snap.items()
                      for n, t in d.items()]
            flat = torch.cat([t.reshape(-1).to(torch.float32)
                              for _, _, t in leaves]).cpu().numpy()
        host: Dict[str, dict] = {}
        i = 0
        for e, n, t in leaves:
            host.setdefault(e, {})[n] = flat[i:i + t.numel()].reshape(
                tuple(t.shape))
            i += t.numel()
        uids = {s: self._reqs[s].uid for s in range(self.max_slots)
                if self._reqs[s] is not None and self._active[s]}
        if uids:
            recs = serve_records(host, self._num_prev, step=self._step_idx,
                                 t=metrics._now(), slot_uids=uids)
            for rec in recs:
                self._numerics.record(rec)
            if self._tracer is not None and recs:
                rates = [r for rec in recs for r in rec["ovf_rate"]]
                exps = [e for rec in recs for e in rec["k_e"]]
                self._tracer.counter(
                    "numerics", {"ovf_rate_max": max(rates),
                                 "k_e_mean": sum(exps) / len(exps)},
                    tid="numerics")
        self._num_prev = host

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
    def reset_metrics(self) -> None:
        """Start a fresh measurement window (latency, throughput,
        overflow): aggregates otherwise span the engine's lifetime, host
        idle time between ``run()`` calls included."""
        self.metrics = metrics.ServeMetrics()
        self._ovf = np.zeros(3, np.float64)

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
