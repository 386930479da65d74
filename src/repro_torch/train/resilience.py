"""Fault-tolerant training: the supervised step loop — ``repro.train.resilience``.

:class:`TrainSupervisor` wraps :func:`repro_torch.train.step.make_train_step`
(``supervise=True``) and resolves every step attempt to a
:class:`StepOutcome`:

* ``OK`` — sentinels clean, update committed on the device;
* ``SKIPPED`` — a device-side sentinel tripped (non-finite loss or
  gradient, or a §5 runaway-overflow rate per tensor class): the step
  discarded its update on the device, the data cursor moves past the
  batch;
* ``ROLLED_BACK`` — ``skip_budget`` consecutive skips exhausted: restore
  the last committed checkpoint (walking past corrupt ones) and go on
  with the *advanced* data cursor, so the poisoned window is not
  replayed;
* ``HALTED`` — rollback failed twice: a diagnostic bundle (outcome log,
  summary, fault log, Chrome trace, numerics JSONL tail) is written and
  the run stops resolving instead of raising.

Bit-exact resume is the checkpoint contract: the saved tree holds the
:class:`~repro_torch.train.state.TrainState` (parameters, optimizer
state, DFXP exponents and the pre-reset §5 ``acc`` windows, step), the
error-feedback state (the residuals of ``compress_bits`` gradient
compression, :func:`repro_torch.dist.compress.ef_init`; ``{}`` without
it), the base threefry key and the data cursor.  Train N steps solo ==
train K, crash, restore, train N - K, bit for bit: the per-step key is
``fold_in(base, cursor)``, both checkpointed.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.numerics import train_records
from repro_torch.optim.opt import OptConfig

from .state import TrainState
from .step import (FLAG_GRAD_NONFINITE, FLAG_LOSS_NONFINITE,
                   FLAG_RUNAWAY_OVF, benign_injection, make_train_step)

Tensor = torch.Tensor


class StepOutcome(enum.Enum):
    OK = "ok"
    SKIPPED = "skipped"
    ROLLED_BACK = "rolled_back"
    HALTED = "halted"


@dataclasses.dataclass
class StepRecord:
    cursor: int                 # data cursor of the attempt
    outcome: StepOutcome
    flags: int                  # sentinel bitmask (step.FLAG_*)
    loss: float
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"cursor": self.cursor, "outcome": self.outcome.value,
                "flags": self.flags, "loss": self.loss, **self.info}


def flag_names(flags: int) -> List[str]:
    out = []
    if flags & FLAG_LOSS_NONFINITE:
        out.append("loss_nonfinite")
    if flags & FLAG_GRAD_NONFINITE:
        out.append("grad_nonfinite")
    if flags & FLAG_RUNAWAY_OVF:
        out.append("runaway_ovf")
    return out


class TrainSupervisor:
    """Supervised train loop: sentinels, skip budget, rollback, resume.

    Parameters mirror :func:`make_train_step` plus:

    * ``batch_fn(cursor) -> batch`` — the deterministic data pipeline (a
      pure function of the checkpointed cursor, as
      :class:`repro_torch.data.SyntheticLM` is of its step);
    * ``rng`` — the base threefry key (an int is ``PRNGKey(int)``); the
      step's key is ``fold_in(rng, cursor)``.  Checkpointed, so a resume
      does not need the original seed;
    * ``manager``/``ckpt_every`` — checkpoint cadence, keyed by the data
      cursor (asynchronous writes; the final :meth:`commit` is
      synchronous);
    * ``skip_budget`` — consecutive SKIPPED attempts tolerated before a
      rollback;
    * ``faults`` — a :class:`repro_torch.train.faults.FaultHarness`;
    * ``tracer``/``metrics`` — a :class:`repro_torch.obs.Tracer` and a
      :class:`repro_torch.obs.MetricsRegistry` (``train_steps_<outcome>``,
      ``train_ckpt_commits``, ``train_ckpt_errors``,
      ``train_rollback_failures``);
    * ``numerics_log`` — a :class:`repro_torch.obs.NumericsLog`: every
      ``numerics_every`` committed steps (default the controller's
      ``update_interval``) the step's numerics tap becomes per-class
      records (:func:`repro_torch.obs.train_records`), one read-back of
      the exponents and windows each time;
    * ``bundle_dir`` — where the HALTED diagnostic bundle lands.
    """

    def __init__(self, loss_fn: Callable, group_shapes: Dict[str, tuple],
                 policy: PrecisionPolicy, opt_cfg: OptConfig,
                 state: TrainState, *,
                 batch_fn: Callable[[int], dict],
                 rng,
                 manager: Optional[CheckpointManager] = None,
                 ckpt_every: int = 0,
                 skip_budget: int = 3,
                 runaway_ovf: Optional[float] = None,
                 compress_bits: Optional[int] = None,
                 microbatches: int = 1,
                 grad_transform: Optional[Callable] = None,
                 faults=None, tracer=None, metrics=None,
                 numerics_log=None, numerics_every: int = 0,
                 bundle_dir: Optional[str] = None):
        self.state = state
        self.batch_fn = batch_fn
        self.rng = prng.as_key(rng, state.step.device)
        self.manager = manager
        self.ckpt_every = ckpt_every
        self.skip_budget = skip_budget
        self.policy = policy
        self.faults = faults
        self.tracer = tracer
        self.numerics_log = numerics_log
        self.numerics_every = numerics_every or policy.update_interval
        self.bundle_dir = bundle_dir
        ef_transform = None
        if compress_bits is not None:
            from repro_torch.dist.compress import compress_tree, ef_init

            def ef_transform(grads, ef):
                # the reference's trainer compresses without an
                # all-reduce (one process: axis_name=None)
                return compress_tree(grads, ef, compress_bits)

            self.ef = ef_init(state.params)
        else:
            self.ef = {}
        self._step_fn = make_train_step(
            loss_fn, group_shapes, policy, opt_cfg,
            microbatches=microbatches, grad_transform=grad_transform,
            numerics_tap=numerics_log is not None,
            ef_transform=ef_transform, supervise=True,
            runaway_ovf=runaway_ovf)

        self.cursor = 0                     # next data position
        self.outcomes: List[StepRecord] = []
        self.losses: List[float] = []       # committed (OK) losses
        self.halted = False
        self._consec_skips = 0
        self._rollback_failures = 0
        self._last_commit: Optional[int] = None

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {o: self.metrics.counter(f"train_steps_{o.value}")
                   for o in StepOutcome}
        self._c_ckpt = self.metrics.counter("train_ckpt_commits")
        self._c_ckpt_err = self.metrics.counter("train_ckpt_errors")
        self._c_rollback_fail = self.metrics.counter(
            "train_rollback_failures")

    # -- checkpoint tree ---------------------------------------------------
    def ckpt_tree(self) -> dict:
        """Everything bit-exact resume needs, as one tree."""
        return {"train": self.state, "ef": self.ef, "rng": self.rng,
                "cursor": torch.tensor(self.cursor, dtype=torch.int32)}

    def ckpt_template(self) -> dict:
        """The restore template: the live tree (restore reads its
        shapes, dtypes and devices)."""
        return self.ckpt_tree()

    def _adopt(self, tree: dict) -> None:
        self.state = tree["train"]
        self.ef = tree["ef"]
        self.rng = tree["rng"]

    def resume(self) -> Optional[int]:
        """Restore the newest clean committed checkpoint, if any.

        Returns the restored cursor (None when starting fresh).  Raises
        :class:`CheckpointError` only when checkpoints exist but every
        one fails verification — starting silently from step 0 then
        would *look* like a resume."""
        if self.manager is None:
            return None
        try:
            tree, step = self.manager.restore_latest(self.ckpt_template())
        except FileNotFoundError:
            return None
        self._adopt(tree)
        self.cursor = int(tree["cursor"])
        self._last_commit = step
        self._event("resumed", step=step, cursor=self.cursor)
        return self.cursor

    def commit(self, *, sync: bool = True) -> bool:
        """Write a checkpoint now.  Never raises: a failed write logs an
        event, bumps ``train_ckpt_errors`` and returns False."""
        if self.manager is None:
            return False
        try:
            self.manager.wait()
        except Exception as e:               # surfaced background failure
            self._c_ckpt_err.inc()
            self._event("ckpt_async_error", error=str(e))
        try:
            if sync:
                self.manager.save(self.cursor, self.ckpt_tree())
            else:
                self.manager.save_async(self.cursor, self.ckpt_tree())
        except Exception as e:
            self._c_ckpt_err.inc()
            self._event("ckpt_write_error", cursor=self.cursor,
                        error=str(e))
            return False
        self._last_commit = self.cursor
        self._c_ckpt.inc()
        return True

    # -- the supervised step ----------------------------------------------
    def step_once(self) -> StepRecord:
        """One supervised step attempt; resolves to a StepRecord."""
        if self.halted:
            raise RuntimeError("supervisor is HALTED; inspect the bundle "
                               f"at {self.bundle_dir!r}")
        if self.faults is not None:
            self.faults.on_step(self)
        inj = (self.faults.injection(self) if self.faults is not None
               else benign_injection())
        batch = self.batch_fn(self.cursor)
        rng = prng.fold_in(self.rng, self.cursor)
        span = (self.tracer.span("train_step", tid="train")
                if self.tracer is not None else None)
        new_state, metrics, new_ef = self._step_fn(
            self.state, batch, rng, self.ef, inj)
        # the one read-back of the step: flags and loss together
        flags, loss = torch.stack([metrics["flags"].to(torch.float32),
                                   metrics["loss"].detach()]).tolist()
        flags = int(flags)
        if span is not None:
            span.__exit__(None, None, None)

        cursor = self.cursor
        self.cursor += 1
        self.state, self.ef = new_state, new_ef     # select ran on device
        if flags == 0:
            self._consec_skips = 0
            self.losses.append(loss)
            rec = StepRecord(cursor, StepOutcome.OK, flags, loss)
            self._log_numerics(metrics)
            if (self.manager is not None and self.ckpt_every
                    and self.cursor % self.ckpt_every == 0):
                self.commit(sync=False)
        else:
            self._consec_skips += 1
            rec = StepRecord(cursor, StepOutcome.SKIPPED, flags, loss,
                             {"sentinels": flag_names(flags),
                              "consec": self._consec_skips})
            self._event("sentinel_skip", cursor=cursor, flags=flags,
                        sentinels=flag_names(flags))
            if self._consec_skips > self.skip_budget:
                rec = self._rollback(rec)
        self.outcomes.append(rec)
        self._c[rec.outcome].inc()
        if rec.outcome is StepOutcome.HALTED:
            bundle = self.write_bundle()
            self._event("halted", cursor=rec.cursor, bundle=bundle)
        if self.tracer is not None and rec.outcome is not StepOutcome.OK:
            self.tracer.instant(f"train:{rec.outcome.value}", tid="train",
                                cursor=cursor, flags=flags)
        return rec

    def _rollback(self, rec: StepRecord) -> StepRecord:
        """Skip budget exhausted: restore the last committed checkpoint.

        The data cursor keeps its *advanced* value — the restored state
        goes on with fresh batches instead of replaying the window that
        tripped the sentinels.  Two failed rollbacks escalate to HALTED
        and the diagnostic bundle."""
        self._consec_skips = 0
        restored = None
        if self.manager is not None:
            try:
                self.manager.wait()
            except Exception as e:
                self._event("ckpt_async_error", error=str(e))
            try:
                restored = self.manager.restore_latest(self.ckpt_template())
            except (FileNotFoundError, CheckpointError) as e:
                self._event("rollback_restore_failed", error=str(e))
        if restored is None:
            self._rollback_failures += 1
            self._c_rollback_fail.inc()
            if self._rollback_failures >= 2:
                self.halted = True
                # step_once writes the bundle after this record lands in
                # the outcome log, so the bundle includes it
                return StepRecord(rec.cursor, StepOutcome.HALTED, rec.flags,
                                  rec.loss,
                                  {**rec.info, "bundle": self.bundle_dir})
            self._event("rollback_failed", cursor=rec.cursor,
                        failures=self._rollback_failures)
            return StepRecord(rec.cursor, StepOutcome.ROLLED_BACK, rec.flags,
                              rec.loss, {**rec.info, "restored": None})
        tree, step = restored
        self._adopt(tree)
        # the cursor stays advanced: do NOT replay the poisoned window
        self.cursor = max(self.cursor, int(tree["cursor"]))
        self._last_commit = step
        self._event("rolled_back", to_step=step, cursor=self.cursor)
        return StepRecord(rec.cursor, StepOutcome.ROLLED_BACK, rec.flags,
                          rec.loss, {**rec.info, "restored": step})

    def run(self, num_steps: int, *, stop: Optional[Callable[[], bool]] = None,
            log_every: int = 0) -> dict:
        """Drive ``num_steps`` attempts (or until HALTED / ``stop()``).

        Never raises for faults — every attempt lands in
        :attr:`outcomes`; returns :meth:`summary`."""
        for _ in range(num_steps):
            if self.halted or (stop is not None and stop()):
                break
            rec = self.step_once()
            if log_every and rec.outcome is StepOutcome.OK and \
                    len(self.losses) % log_every == 0:
                print(f"step {int(self.state.step)}: loss={rec.loss:.4f}",
                      flush=True)
        if not self.halted:
            self.commit(sync=True)
        return self.summary()

    # -- reporting ---------------------------------------------------------
    def outcome_counts(self) -> Dict[str, int]:
        counts = {o.value: 0 for o in StepOutcome}
        for r in self.outcomes:
            counts[r.outcome.value] += 1
        return counts

    def summary(self) -> dict:
        return {
            "attempts": len(self.outcomes),
            "outcomes": self.outcome_counts(),
            "steps_committed": int(self.state.step),
            "cursor": self.cursor,
            "final_loss": self.losses[-1] if self.losses else None,
            "halted": self.halted,
            "rollback_failures": self._rollback_failures,
            "last_checkpoint": self._last_commit,
            "faults": (self.faults.summary()["event_counts"]
                       if self.faults is not None else {}),
        }

    def write_bundle(self, path: Optional[str] = None,
                     numerics_tail: int = 50) -> Optional[str]:
        """Write the diagnostic bundle: outcome log, summary, fault log,
        the Chrome trace and the numerics JSONL tail."""
        path = path or self.bundle_dir
        if path is None:
            return None
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "outcomes.json"), "w") as f:
            json.dump([r.to_json() for r in self.outcomes], f, indent=2)
        with open(os.path.join(path, "summary.json"), "w") as f:
            json.dump(self.summary(), f, indent=2)
        if self.faults is not None:
            with open(os.path.join(path, "faults.json"), "w") as f:
                json.dump(self.faults.summary(), f, indent=2)
        if self.tracer is not None:
            self.tracer.export(os.path.join(path, "trace.json"))
        if self.numerics_log is not None:
            with open(os.path.join(path, "numerics_tail.jsonl"), "w") as f:
                for r in self.numerics_log.tail(numerics_tail):
                    f.write(json.dumps(r) + "\n")
        return path

    # -- internals ---------------------------------------------------------
    def _event(self, kind: str, **kw) -> None:
        if self.faults is not None:
            self.faults.log_supervisor_event(kind, **kw)
        elif self.tracer is not None:
            self.tracer.instant(f"train:{kind}", tid="train", **kw)

    def _log_numerics(self, metrics) -> None:
        if self.numerics_log is None:
            return
        if len(self.losses) % self.numerics_every:
            return
        # one read-back: every exponent and window, flattened together
        tap = metrics["numerics"]
        parts = [(part, g, t) for part in ("prev_exps", "exps", "acc")
                 for g, t in tap[part].items()]
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for _, _, t in parts]).tolist() if parts else []
        host: Dict[str, dict] = {"prev_exps": {}, "exps": {}, "acc": {}}
        i = 0
        for part, g, t in parts:
            host[part][g] = flat[i:i + t.numel()]
            i += t.numel()
        for rec in train_records(host["prev_exps"], host["exps"],
                                 host["acc"], step=int(self.state.step),
                                 t=time.perf_counter()):
            self.numerics_log.record(rec)
