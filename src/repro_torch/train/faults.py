"""Deterministic fault injection for the training loop — ``repro.train.faults``.

The resilience layer of :mod:`repro_torch.train.resilience` — device-side
sentinels, the skip budget, rollback to the last committed checkpoint —
is only worth trusting if its failure paths run.  Each injector fires at
the boundary the matching production fault would cross:

* :class:`GradNaN` poisons the gradients **inside the train step** (the
  step's ``inj`` input adds ``where(flag, nan, 0)`` to every leaf), so
  the non-finite-gradient sentinel detects it on the device.
* :class:`LossSpike` scales the loss *before* autograd, so the spike
  propagates through the backward pass like a real blowup.
* :class:`CkptTear` attacks the checkpoint pipeline: ``writer`` kills the
  background save mid-write (:meth:`CheckpointManager.inject_failure`,
  surfacing on the next ``wait()``), ``strip`` deletes the newest
  ``_COMMITTED`` marker, ``corrupt`` flips a byte of a committed leaf
  file against its manifest CRC32.
* :class:`ParamBitFlip` XORs a mantissa bit of one packed parameter leaf
  between steps (a storage upset in DFXP weight memory); in sim storage
  there is no mantissa, and it logs a skip.
* :class:`Kill` SIGKILLs the process at a step — the crash of the
  train-resume check.

:class:`FaultHarness` fires each fault once (or for its ``count``
window), keeps a JSON-able event log, and mirrors every event into a
:class:`repro_torch.obs.Tracer` and the ``train_faults_injected`` counter
when attached.  :func:`chaos_plan` draws a reproducible fault mix from a
seed with ``random.Random(seed)``, so one seed gives one plan in both
packages.
"""
from __future__ import annotations

import dataclasses
import os
import random
import signal
from typing import List

import torch

from repro_torch.core.packed import PackedArray

from .step import benign_injection

__all__ = ["GradNaN", "LossSpike", "CkptTear", "ParamBitFlip", "Kill",
           "FaultHarness", "chaos_plan"]


@dataclasses.dataclass
class GradNaN:
    """Poison the gradients at data cursor ``step`` for ``count``
    consecutive attempts — ``count > skip_budget`` forces a rollback."""

    step: int
    count: int = 1
    fired: bool = False


@dataclasses.dataclass
class LossSpike:
    """Multiply the loss by ``factor`` at cursor ``step`` for ``count``
    attempts (``inf`` trips the sentinels; a merely large factor must
    not: sentinels are for non-finites, §5 handles scale)."""

    step: int
    factor: float = float("inf")
    count: int = 1
    fired: bool = False


@dataclasses.dataclass
class CkptTear:
    """Tear the checkpoint pipeline at cursor ``step`` (``mode``:
    ``writer``, ``strip`` or ``corrupt``; see the module docstring)."""

    step: int
    mode: str = "corrupt"
    fired: bool = False

    def __post_init__(self):
        if self.mode not in ("writer", "strip", "corrupt"):
            raise ValueError(f"unknown CkptTear mode {self.mode!r}")


@dataclasses.dataclass
class ParamBitFlip:
    """XOR bit ``bit`` of one packed-param mantissa at cursor ``step``."""

    step: int
    bit: int = 5
    fired: bool = False


@dataclasses.dataclass
class Kill:
    """SIGKILL the process at cursor ``step``."""

    step: int
    fired: bool = False


class FaultHarness:
    """Drives a fault list against a :class:`TrainSupervisor`.

    The supervisor calls :meth:`on_step` (host-side surgery: tears, bit
    flips, kills) before building the batch, and :meth:`injection` for
    the step's ``inj`` input.  ``log`` holds one JSON-able dict per
    event."""

    def __init__(self, faults, seed: int = 0, tracer=None, metrics=None):
        self.faults = list(faults)
        self.seed = seed
        self.log: List[dict] = []
        self.tracer = tracer
        self._c_injected = (metrics.counter("train_faults_injected")
                            if metrics is not None else None)

    def _event(self, kind: str, **kw) -> None:
        self.log.append({"kind": kind, **kw})
        if self.tracer is not None:
            self.tracer.instant(f"fault:{kind}", tid="faults", **kw)
        if self._c_injected is not None and not kind.endswith("_skipped"):
            self._c_injected.inc()

    def log_supervisor_event(self, kind: str, **kw) -> None:
        """Supervisor outcomes (rollbacks, halts) land in the same log,
        tagged ``sup:``."""
        self.log.append({"kind": f"sup:{kind}", **kw})
        if self.tracer is not None:
            self.tracer.instant(f"train:{kind}", tid="train", **kw)

    # -- supervisor hooks --------------------------------------------------
    def on_step(self, sup) -> None:
        cursor = sup.cursor
        for f in self.faults:
            if isinstance(f, CkptTear) and not f.fired and cursor >= f.step:
                f.fired = True
                self._tear(sup, f, cursor)
            elif isinstance(f, ParamBitFlip) and not f.fired and \
                    cursor >= f.step:
                f.fired = True
                self._flip(sup, f, cursor)
            elif isinstance(f, Kill) and not f.fired and cursor >= f.step:
                f.fired = True
                self._event("kill", cursor=cursor, pid=os.getpid())
                os.kill(os.getpid(), signal.SIGKILL)

    def injection(self, sup) -> dict:
        inj = benign_injection()
        cursor = sup.cursor
        for f in self.faults:
            if isinstance(f, GradNaN) and \
                    f.step <= cursor < f.step + f.count:
                inj["grad_nan"] = torch.tensor(True)
                f.fired = True
                self._event("grad_nan", cursor=cursor,
                            window=[f.step, f.step + f.count])
            elif isinstance(f, LossSpike) and \
                    f.step <= cursor < f.step + f.count:
                inj["loss_scale"] = torch.tensor(f.factor,
                                                 dtype=torch.float32)
                f.fired = True
                self._event("loss_spike", cursor=cursor, factor=f.factor)
        return inj

    # -- host-side surgery -------------------------------------------------
    def _tear(self, sup, f: CkptTear, cursor: int) -> None:
        mgr = sup.manager
        if mgr is None:
            self._event("ckpt_tear_skipped", cursor=cursor,
                        reason="no checkpoint manager attached")
            return
        if f.mode == "writer":
            mgr.inject_failure()
            self._event("ckpt_tear", mode="writer", cursor=cursor)
            return
        try:
            mgr.wait()
        except Exception:
            pass                            # surfaced later by supervisor
        committed = mgr.all_steps()
        if not committed:
            self._event("ckpt_tear_skipped", cursor=cursor, mode=f.mode,
                        reason="no committed checkpoint to tear")
            return
        path = os.path.join(mgr.dir, f"step_{max(committed):08d}")
        if f.mode == "strip":
            os.remove(os.path.join(path, "_COMMITTED"))
            self._event("ckpt_tear", mode="strip", cursor=cursor,
                        victim=os.path.basename(path))
            return
        leaves = sorted(n for n in os.listdir(path) if n.endswith(".npy"))
        if not leaves:
            self._event("ckpt_tear_skipped", cursor=cursor, mode=f.mode,
                        reason="committed dir has no leaf files")
            return
        victim = os.path.join(path, leaves[len(leaves) // 2])
        with open(victim, "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([b[0] ^ 0xFF]))
        self._event("ckpt_tear", mode="corrupt", cursor=cursor,
                    victim=os.path.relpath(victim, mgr.dir))

    def _flip(self, sup, f: ParamBitFlip, cursor: int) -> None:
        # the reference's leaf order: the packed leaves in sorted-key order
        leaves = [x for _, x in _packed_leaves(sup.state.params)]
        if not leaves:
            self._event("bit_flip_skipped", cursor=cursor,
                        reason="params are not in packed storage")
            return
        target = leaves[len(leaves) // 2]
        m = target.mantissa
        idx = tuple(d // 2 for d in m.shape)
        width = 8 * m.element_size()
        bit = min(f.bit, width - 2)         # keep off the sign bit
        old = int(m[idx])
        new_m = m.clone()
        new_m[idx] = m[idx] ^ (1 << bit)
        sup.state = dataclasses.replace(
            sup.state, params=_replace_leaf(
                sup.state.params, target,
                dataclasses.replace(target, mantissa=new_m)))
        self._event("bit_flip", cursor=cursor, bit=bit,
                    index=[int(i) for i in idx], old=old,
                    new=int(new_m[idx]))

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        counts: dict = {}
        for ev in self.log:
            counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
        return {"seed": self.seed, "n_faults": len(self.faults),
                "events": list(self.log), "event_counts": counts}


def _packed_leaves(params):
    """``(name, PackedArray)`` of a parameter tree, in sorted-key order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, PackedArray):
            out.append(("/".join(path), t))

    walk(params, ())
    return out


def _replace_leaf(tree, victim, new):
    """``tree`` with the leaf object ``victim`` replaced by ``new``."""
    if isinstance(tree, dict):
        return {k: _replace_leaf(v, victim, new) for k, v in tree.items()}
    return new if tree is victim else tree


def chaos_plan(seed: int, *, n_steps: int = 24, p_nan: float = 0.5,
               p_spike: float = 0.5, p_tear: float = 0.5,
               p_flip: float = 0.5, burst: int = 0) -> list:
    """Reproducible random fault mix for a train chaos sweep.

    Same seed → same plan (``random.Random(seed)``, the reference's draws
    in the reference's order).  Each class draws independently; ``burst
    > 0`` adds one GradNaN run of that length (longer than the skip
    budget → the rollback path, not just lone skips)."""
    rng = random.Random(seed)
    faults: list = []
    hi = max(3, n_steps - 2)
    if rng.random() < p_nan:
        faults.append(GradNaN(step=rng.randint(2, hi)))
    if rng.random() < p_spike:
        faults.append(LossSpike(step=rng.randint(2, hi),
                                factor=float("inf")))
    if rng.random() < p_tear:
        faults.append(CkptTear(step=rng.randint(3, hi),
                               mode=rng.choice(["writer", "strip",
                                                "corrupt"])))
    if rng.random() < p_flip:
        faults.append(ParamBitFlip(step=rng.randint(2, hi),
                                   bit=rng.randint(0, 6)))
    if burst > 0:
        faults.append(GradNaN(step=rng.randint(2, hi), count=burst))
    return faults
