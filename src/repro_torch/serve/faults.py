"""Deterministic fault injection for the serve engine (chaos testing).

The port of ``repro.serve.faults``.  The robustness layer in
:mod:`repro_torch.serve.engine` — admission control,
preemption under page exhaustion, numeric quarantine — is only worth
trusting if the failure paths actually run.  This module injects the
failures on purpose, deterministically, at the real boundaries:

* :class:`LogitNaN` poisons one decode step's logits for one request
  **on the device** (the engine's NaN mask, applied to the logits before
  ``sampler.guard_logits``), so the sentinel genuinely detects it — the
  fault travels the same path a real numeric blowup would.
* :class:`KVBitFlip` XORs a mantissa bit in the victim's *private* KV
  storage (int8/int16 pools), in place on the pool's own tensor, where
  the flash kernels read it next, modeling a storage upset.  The engine must
  keep draining and sibling streams must be byte-identical — pages are
  refcounted precisely so one request's corruption cannot leak.
* :class:`PageSqueeze` grabs free pages hostage
  (:meth:`PageAllocator.grab`), forcing genuine mid-decode exhaustion —
  the preemption path's trigger — and optionally releases them later.
* :class:`AdmitDelay` holds a request in the queue until a given step,
  exercising deadline expiry and queue-depth accounting.

:class:`FaultHarness` owns a fault list, fires each exactly once at its
trigger, and keeps a structured event log (JSON-serializable) that the
chaos tests assert on and the serve CLI writes to ``--fault-log``.
:func:`chaos_plan` draws a reproducible random fault mix from a seed.

Every injector is a no-op when its precondition fails (victim already
finished, pool is f32, arena already dry) — it logs ``skipped`` instead
of raising, so a chaos sweep never crashes the harness itself.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import numpy as np

__all__ = ["LogitNaN", "KVBitFlip", "PageSqueeze", "AdmitDelay",
           "FaultHarness", "chaos_plan"]


@dataclasses.dataclass
class LogitNaN:
    """Poison the decode logits of ``uid``'s slot once, device-side.

    Fires on the decode step where the request has generated exactly
    ``token_idx`` tokens — so tokens ``0 .. token_idx-1`` stream out
    clean and the poisoned token is the would-be ``token_idx``-th.  The
    engine's sentinel must drop it and quarantine the request FAILED.
    (``token_idx >= 1``: token 0 is sampled from prefill logits, which
    the injection mask doesn't reach.)
    """

    uid: int
    token_idx: int = 1
    fired: bool = False

    def __post_init__(self):
        if self.token_idx < 1:
            raise ValueError("token_idx must be >= 1 (token 0 comes from "
                             "prefill logits)")


@dataclasses.dataclass
class KVBitFlip:
    """XOR bit ``bit`` of one stored K mantissa of ``uid`` at ``step``.

    Only touches storage that is *privately owned* by the victim —
    slot-major rows are private by construction; paged mode picks a
    mapped page with refcount 1 (never a shared/registered prefix page,
    whose corruption would be the allocator's bug, not a fault model).
    Skips (with a logged reason) on f32 pools — there is no mantissa to
    flip — and when the victim has no written private storage yet.
    """

    step: int
    uid: int
    bit: int = 5
    fired: bool = False


@dataclasses.dataclass
class PageSqueeze:
    """Grab up to ``n_pages`` free pages at ``step``; release at
    ``release_step`` (never, if None).  Grabbed pages are allocated but
    unmapped, so the squeeze is invisible except as scarcity — the
    engine's next page demand hits genuine exhaustion and must preempt.
    """

    step: int
    n_pages: int
    release_step: Optional[int] = None
    fired: bool = False
    released: bool = False
    held: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AdmitDelay:
    """Hold ``uid`` in the queue until engine step ``until_step``."""

    uid: int
    until_step: int
    fired: bool = False


class FaultHarness:
    """Drives a fault list against a running engine.

    The engine calls three hooks (all cheap no-ops with no pending
    faults): :meth:`on_step` at the top of every step (bit flips, page
    squeezes), :meth:`admit_ok` per queued request during admission
    (delays), and :meth:`nan_mask` before the decode step (logit
    poisoning).  ``log`` accumulates one JSON-able dict per event.
    """

    def __init__(self, faults, seed: int = 0, tracer=None):
        self.faults = list(faults)
        self.seed = seed
        self.log: List[dict] = []
        # optional repro_torch.obs.Tracer: every injected fault also lands as
        # an instant on the trace's "faults" track (the engine attaches
        # its tracer here when it has one)
        self.tracer = tracer

    def _event(self, kind: str, **kw) -> None:
        self.log.append({"kind": kind, **kw})
        if self.tracer is not None:
            self.tracer.instant(f"fault:{kind}", tid="faults", **kw)

    # -- engine hooks -----------------------------------------------------
    def on_step(self, eng) -> None:
        step = eng._step_idx
        for f in self.faults:
            if isinstance(f, PageSqueeze):
                if not f.fired and step >= f.step:
                    f.fired = True
                    if eng._paged:
                        f.held = eng._alloc.grab(f.n_pages)
                        self._event("page_squeeze", step=step,
                                    requested=f.n_pages, held=len(f.held))
                    else:
                        self._event("page_squeeze_skipped", step=step,
                                    reason="engine is not paged")
                if (f.fired and not f.released and f.release_step is not None
                        and step >= f.release_step):
                    f.released = True
                    eng._alloc.ungrab(f.held)
                    self._event("page_release", step=step,
                                released=len(f.held))
                    f.held = []
            elif isinstance(f, KVBitFlip):
                if not f.fired and step >= f.step:
                    f.fired = True
                    self._flip(eng, f, step)

    def admit_ok(self, uid: int, step: int) -> bool:
        for f in self.faults:
            if isinstance(f, AdmitDelay) and f.uid == uid:
                if step < f.until_step:
                    return False
                if not f.fired:
                    f.fired = True
                    self._event("admit_released", uid=uid, step=step)
        return True

    def nan_mask(self, eng) -> np.ndarray:
        mask = np.zeros(eng.max_slots, bool)
        for f in self.faults:
            if isinstance(f, LogitNaN) and not f.fired:
                s = _slot_of(eng, f.uid)
                if s is not None and eng._active[s] and \
                        len(eng._gen[s]) == f.token_idx:
                    mask[s] = True
                    f.fired = True
                    self._event("logit_nan", uid=f.uid, slot=s,
                                token_idx=f.token_idx, step=eng._step_idx)
        return mask

    # -- bit-flip mechanics ------------------------------------------------
    def _flip(self, eng, f: KVBitFlip, step: int) -> None:
        s = _slot_of(eng, f.uid)
        if s is None:
            self._event("bit_flip_skipped", uid=f.uid, step=step,
                        reason="request not in a slot")
            return
        target = self._flip_target(eng, s)
        if target is None:
            return  # _flip_target logged the reason
        entry, idx = target
        m = entry["k_m"]
        if m.is_floating_point():
            self._event("bit_flip_skipped", uid=f.uid, step=step,
                        reason="f32 pool has no mantissa to flip")
            return
        width = 8 * m.element_size()
        bit = min(f.bit, width - 2)        # keep off the sign bit
        old = int(m[idx])
        m[idx] ^= 1 << bit                 # in place: the pool's own tensor
        self._event("bit_flip", uid=f.uid, slot=s, step=step, bit=bit,
                    index=[int(i) for i in idx], old=old, new=int(m[idx]))

    def _flip_target(self, eng, s: int):
        """Locate (entry, index) of one privately-owned written K row:
        the slot's newest row of the first packed attention entry
        (slot-major ring ``[n, B, W, K, hd]``), or of its newest private
        page (paged arena ``[n, pages, P, K, hd]``)."""
        pos = int(eng._pos[s])
        if pos < 1:
            self._event("bit_flip_skipped", slot=s,
                        reason="no rows written yet")
            return None
        for sc in eng._pool.values():
            for bkey, e in sc.items():
                if not isinstance(e, dict) or "k_m" not in e:
                    continue
                if "bt" in e:              # paged: newest private page
                    P = eng.page_size
                    for b in range((pos - 1) // P, -1, -1):
                        page = int(eng._alloc.bt[s][b])
                        if page == 0 or eng._alloc.rc[page] != 1:
                            continue       # unmapped or shared: hands off
                        off = min(pos - 1 - b * P, P - 1)
                        return e, (0, page, off, 0, 0)
                    self._event("bit_flip_skipped", slot=s,
                                reason="no private page mapped")
                    return None
                W = e["k_m"].shape[2]      # slot-major ring [n, B, W, K, hd]
                return e, (0, s, (pos - 1) % W, 0, 0)
        self._event("bit_flip_skipped", slot=s,
                    reason="no packed attention entry in pool")
        return None

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        counts: dict = {}
        for ev in self.log:
            counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
        return {"seed": self.seed, "n_faults": len(self.faults),
                "events": list(self.log), "event_counts": counts}


def _slot_of(eng, uid: int) -> Optional[int]:
    for s, r in enumerate(eng._reqs):
        if r is not None and r.uid == uid:
            return s
    return None


def chaos_plan(seed: int, uids, *, n_steps: int = 32,
               p_nan: float = 0.25, p_flip: float = 0.25,
               p_delay: float = 0.25, squeeze_pages: int = 0) -> list:
    """Reproducible random fault mix over ``uids`` for a chaos sweep.

    Same seed → same plan (``random.Random(seed)``, no global state).
    Each uid independently draws a logit-NaN, a KV bit flip, and/or an
    admission delay; ``squeeze_pages > 0`` adds one mid-run PageSqueeze
    with a later release, so the run exercises exhaustion-preemption AND
    recovery in the same drain.
    """
    rng = random.Random(seed)
    faults: list = []
    for uid in uids:
        if rng.random() < p_nan:
            faults.append(LogitNaN(uid, token_idx=rng.randint(1, 4)))
        if rng.random() < p_flip:
            faults.append(KVBitFlip(step=rng.randint(2, max(3, n_steps // 2)),
                                    uid=uid, bit=rng.randint(0, 5)))
        if rng.random() < p_delay:
            faults.append(AdmitDelay(uid,
                                     until_step=rng.randint(2, n_steps // 2)))
    if squeeze_pages > 0:
        t = rng.randint(3, max(4, n_steps // 2))
        faults.append(PageSqueeze(step=t, n_pages=squeeze_pages,
                                  release_step=t + rng.randint(3, 8)))
    return faults
