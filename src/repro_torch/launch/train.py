"""Training driver: calibrate → supervised DFXP train, fault-tolerant —
``repro.launch.train`` on the card.

Fault-tolerance contract (the reference's):
  * every step resolves to an outcome — OK / SKIPPED (device-side
    sentinel tripped, update discarded on the device) / ROLLED_BACK (skip
    budget exhausted → restore the last committed checkpoint, keep the
    advanced data cursor) / HALTED (rollback failed twice → diagnostic
    bundle) — and a per-run outcome table prints at exit;
  * checkpoint every ``--ckpt-every`` steps (async, atomic, CRC32'd,
    fsync'd, keeps ``--keep``); the saved tree covers parameters,
    optimizer state, DFXP scales and §5 windows, the base threefry key
    and the data cursor — resume is bit-exact;
  * SIGTERM/SIGINT (preemption) → synchronous final checkpoint → 143;
  * restart with the same ``--ckpt-dir`` resumes from the latest clean
    committed step, walking past (and quarantining) corrupt ones;
  * ``--chaos [SEED]`` runs a seeded fault plan (NaN gradients, loss
    spikes, checkpoint tears, parameter bit flips) through the harness;
    the run must still resolve every step and exit 0.

Exit codes: 0; 2 for ``--resume must`` with nothing to restore; 3 when
HALTED; 143 after SIGTERM/SIGINT; ``--kill-at`` dies by SIGKILL (137).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --smoke --steps 20 --global-batch 4 --seq-len 32 --arithmetic dfxp \\
      --device cpu

Weights are the reference's from ``--seed`` (threefry), data
:class:`repro_torch.data.SyntheticLM`.  ``--fused-matmul`` routes every
``tape.dot`` through the quantized matmul K2; K1 takes the large rounding
sites under :func:`repro_torch.core.quant.enable_pallas_quantize`, as in
the reference.  Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim.opt import OptConfig, adamw_init, sgd_init
from repro_torch.train import (FaultHarness, Kill, StepOutcome,
                               TrainSupervisor, chaos_plan, init_train_state)
from repro_torch.train.calibrate import calibrate


def build_policy(args) -> PrecisionPolicy:
    return PrecisionPolicy(
        arithmetic=args.arithmetic, comp_width=args.comp_width,
        update_width=args.update_width, update_interval=args.update_interval,
        storage=args.storage,
        max_overflow_rate=args.max_overflow_rate,
        fused_matmul=getattr(args, "fused_matmul", False))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_moe_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--arithmetic", default="dfxp",
                    choices=["float32", "float16", "bfloat16", "fixed",
                             "dfxp"])
    ap.add_argument("--comp-width", type=int, default=10)
    ap.add_argument("--update-width", type=int, default=12)
    ap.add_argument("--update-interval", type=int, default=20)
    ap.add_argument("--max-overflow-rate", type=float, default=1e-4)
    ap.add_argument("--storage", default="sim", choices=["sim", "packed"])
    ap.add_argument("--fused-matmul", action="store_true",
                    help="route QTape.dot through the quantized matmul "
                         "kernel K2 (forward, dgrad and wgrad)")
    ap.add_argument("--calibrate-steps", type=int, default=5)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    # -- resilience ---------------------------------------------------------
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3,
                    help="retained committed checkpoints (newest never GC'd)")
    ap.add_argument("--resume", default="auto",
                    choices=["auto", "never", "must"],
                    help="auto: resume when a committed checkpoint exists; "
                         "never: start fresh; must: fail fast if nothing "
                         "committed is restorable")
    ap.add_argument("--skip-budget", type=int, default=3,
                    help="consecutive sentinel-skipped steps tolerated "
                         "before rolling back to the last checkpoint")
    ap.add_argument("--runaway-ovf", type=float, default=0.0,
                    help="per-tensor-class §5 overflow-rate sentinel "
                         "threshold (0 disables)")
    ap.add_argument("--grad-compress-bits", type=int, default=0,
                    help="error-feedback gradient compression (not ported "
                         "yet: ROADMAP module item 22)")
    ap.add_argument("--chaos", nargs="?", type=int, const=0, default=None,
                    metavar="SEED",
                    help="run a seeded fault plan through the train harness "
                         "and print the fault log at exit")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="SIGKILL the process at this data cursor (the "
                         "train-resume check's crash injection)")
    ap.add_argument("--fault-log", default="",
                    help="write the harness fault/event log as JSON here")
    ap.add_argument("--bundle-dir", default="",
                    help="where a HALTED run writes its diagnostic bundle "
                         "(default: <ckpt-dir>/bundle)")
    # -- observability ------------------------------------------------------
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--numerics-log", default="",
                    help="the §5 numeric-health timeline (not ported yet: "
                         "ROADMAP module item 19)")
    ap.add_argument("--numerics-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.grad_compress_bits:
        raise NotImplementedError(
            "--grad-compress-bits is not ported yet (ROADMAP module item 22)")
    if args.numerics_log:
        raise NotImplementedError(
            "--numerics-log is not ported yet (ROADMAP module item 19)")
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    policy = build_policy(args)
    gs = T.group_shapes(cfg)
    opt_cfg = OptConfig(kind=args.optimizer, lr=args.lr,
                        lr_decay_steps=max(args.steps, 1000))
    key = prng.PRNGKey(args.seed, device)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch,
                       seed=args.seed)

    def batch_fn(cursor):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch(cursor).items()}

    def loss_fn(p, b, s, exps):
        return T.loss_fn(cfg, policy, p, b, exps, s)

    # --- calibration (paper §9.3), then reinitialize ------------------------
    init_exp = -8.0
    if policy.dynamic and args.calibrate_steps:
        obs_policy = dataclasses.replace(policy, arithmetic="observe",
                                         storage="sim")

        def obs_loss(p, b, s, exps):
            return T.loss_fn(cfg, obs_policy, p, b, exps, s)

        params0 = T.init_params(cfg, key, device=device)
        batches = (batch_fn(i) for i in range(args.calibrate_steps))
        init_exp = calibrate(obs_loss, params0, gs, policy, opt_cfg,
                             batches, steps=args.calibrate_steps)
        del params0
        print(f"calibrated {len(init_exp)} scale groups")

    params = T.init_params(cfg, prng.fold_in(key, 1), device=device)
    state = init_train_state(params, sgd_init(params) if
                             args.optimizer == "sgd" else adamw_init(params),
                             gs, policy, init_exp=init_exp)
    tracer = Tracer()
    metrics = MetricsRegistry()

    # --- fault harness ------------------------------------------------------
    faults = []
    if args.chaos is not None:
        faults = chaos_plan(args.chaos, n_steps=args.steps,
                            burst=args.skip_budget + 1)
        print(f"chaos plan (seed {args.chaos}): "
              f"{[type(f).__name__ for f in faults]}")
    if args.kill_at:
        faults.append(Kill(step=args.kill_at))
    harness = (FaultHarness(faults, seed=args.chaos or 0, tracer=tracer,
                            metrics=metrics) if faults else None)

    mgr = (CheckpointManager(args.ckpt_dir, keep=args.keep)
           if args.ckpt_dir else None)
    bundle_dir = args.bundle_dir or (
        args.ckpt_dir + "/bundle" if args.ckpt_dir else "train_bundle")

    sup = TrainSupervisor(
        loss_fn, gs, policy, opt_cfg, state,
        batch_fn=batch_fn, rng=key,
        manager=mgr, ckpt_every=args.ckpt_every,
        skip_budget=args.skip_budget,
        runaway_ovf=args.runaway_ovf or None,
        microbatches=args.microbatches,
        faults=harness, tracer=tracer, metrics=metrics,
        bundle_dir=bundle_dir)

    # --- resume -------------------------------------------------------------
    if args.resume != "never" and mgr is not None:
        at = sup.resume()
        if at is not None:
            print(f"resumed from cursor {at}")
        elif args.resume == "must":
            print("error: --resume must, but nothing restorable",
                  file=sys.stderr)
            return sys.exit(2)

    stop = {"now": False}

    def _preempt(signum, frame):
        stop["now"] = True

    signal.signal(signal.SIGTERM, _preempt)
    signal.signal(signal.SIGINT, _preempt)

    # --- supervised loop ----------------------------------------------------
    t0 = time.perf_counter()
    remaining = max(args.steps - sup.cursor, 0)
    summary = sup.run(remaining, stop=lambda: stop["now"],
                      log_every=args.log_every)
    dt = time.perf_counter() - t0

    if stop["now"] and not sup.halted:
        print(f"preempted at cursor {sup.cursor}: final checkpoint written")

    # --- per-run outcome table ----------------------------------------------
    print(f"trained {summary['steps_committed']} steps in {dt:.1f}s "
          f"({summary['attempts']} attempts)")
    print(f"{'outcome':>12} {'count':>6}")
    for o in StepOutcome:
        print(f"{o.value:>12} {summary['outcomes'][o.value]:>6}")
    if summary["final_loss"] is not None:
        print(f"final loss: {summary['final_loss']:.4f}")
    print("summary:", json.dumps(
        {k: v for k, v in summary.items() if k != "outcomes"}, default=str))
    if harness is not None:
        print("faults:", json.dumps(harness.summary()["event_counts"]))
        if args.fault_log:
            with open(args.fault_log, "w") as f:
                json.dump({"harness": harness.summary(),
                           "run": summary}, f, indent=2, default=str)
            print(f"fault log written to {args.fault_log}")
    if sup.halted:
        print(f"HALTED: diagnostic bundle at {bundle_dir}", file=sys.stderr)
        return sys.exit(3)
    if stop["now"]:
        return sys.exit(143)
    print("done")
    return sup.state


if __name__ == "__main__":
    main()
