"""Driver of a training mix: the program's supervised trainer
(``repro_torch.train.TrainSupervisor``) built as ``repro_torch.launch.train``
builds it, from the configuration's weights and the mix's rows.

Set-up: weights and rows from the seed, calibration (paper §9.3), the
train state, then the first ``followed_steps`` steps through the
supervisor's own ``step_once`` on rows of their own; they warm up every
kernel and plan and are what the plain reference follows.  The window
then calls ``step_once`` until ``--seconds`` have passed; the rate counts
the tokens of the steps whose outcome is ``OK`` over the whole window,
which ends on ``torch.cuda.synchronize()``.  A traced run adds
``trace_steps`` steps under the profiler after the window, twice: the
card alone, then host and card (:mod:`harness.profile`).  Once the
memory peak is read and the program's state is freed, the reference
follows the set-up's steps, and the two are compared.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

from harness.core import mix_params
from harness.program import port_config
from harness import traffic as tr
from harness.profile import Traced, span


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Per leaf, the gap between the program's and the reference's norm as
    a share of the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        den = max(ref[n], med)
        out[n] = abs(prog[n] - ref[n]) / den if den > 0 else (
            0.0 if prog[n] == ref[n] else float("inf"))
    return out


def compare(prog: dict, ref: dict, limits: dict) -> tuple:
    """The compared numbers, each with its limit, and what they were
    taken over: the widest gap of a step's loss, the worst leaf's gap of
    the first gradient's norm, and the gap of the whole parameters'
    change after the followed steps, as a share of the reference's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    names = list(ref["grad_norm"])
    gmed = statistics.median(ref["grad_norm"].values())
    moved = [n for n in names if ref["grad_norm"][n] >= 1e-3 * gmed]
    loss_gap = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    g = leaf_gaps(prog["grad_norm"], ref["grad_norm"], names)
    u = leaf_gaps(prog["update_norm"], ref["update_norm"], moved)
    g_at, u_at = max(g, key=g.get), max(u, key=u.get)

    def whole(d):
        return math.sqrt(sum(d[n] ** 2 for n in moved))

    total = whole(ref["update_norm"])
    change = abs(whole(prog["update_norm"]) - total) / total if total \
        else float("inf")
    checks = {
        "loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
        "grad_norm_gap": {"value": g[g_at], "limit": limits["grad_norm_gap"]},
        "update_norm_gap": {"value": change,
                            "limit": limits["update_norm_gap"]}}
    info = {"grad_worst_leaf": [g_at, g[g_at]],
            "update_worst_leaf": [u_at, u[u_at], prog["update_moved"][u_at],
                                  ref["update_moved"][u_at]],
            "left_out": sorted(set(names) - set(moved)),
            "leaf_norms": {n: [prog["grad_norm"][n], ref["grad_norm"][n],
                               prog["update_norm"][n], ref["update_norm"][n]]
                           for n in names}}
    return checks, info


def _norms(torch, tree) -> dict:
    from repro_torch.train.state import leaves_with_path
    return {"/".join(p): float(torch.linalg.vector_norm(t.double()))
            for p, t in leaves_with_path(tree)}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, smoke: bool = False, fault: str = "") -> dict:
    import torch
    from repro_torch.core import prng
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig, sgd_init
    from repro_torch.train import (StepOutcome, TrainSupervisor,
                                   init_train_state)
    from repro_torch.train.calibrate import calibrate, observe_policy
    from repro_torch.train.state import leaves_with_path

    cuda = device.startswith("cuda")
    t = mix_params(cell, smoke)
    model = cell.model()
    S = model.sizes(cell.config, smoke)
    mcfg = port_config(cell, smoke)
    policy = PrecisionPolicy(**t["policy"])
    opt_cfg = OptConfig(kind="sgd", **t["optimizer"])
    vocab = S["published_vocab_size"]
    B, L = int(t["batch"]), int(t["seq_len"])

    def rows(stream, i):
        return tr.lm_batch(torch, t, vocab, seed, stream, i, device)

    def train_rows(cursor):
        b = rows("train", cursor)
        if fault == "half_batch":          # the harness's own tests only
            b = {k: v[:B // 2] for k, v in b.items()}
        return b

    def loss_fn(pol):
        return lambda p, b, s, e: T.loss_fn(mcfg, pol, p, b, e, s)

    gs = T.group_shapes(mcfg)
    enable_pallas_quantize(bool(t.get("k1", False)))
    phases = {"start": time.perf_counter() - t_start}
    weights = model.make_weights(S, seed, device)
    phases["weights"] = time.perf_counter() - t_start
    n_cal = int(t["calibrate_steps"])
    init_exp = calibrate(loss_fn(observe_policy(policy)), weights, gs, policy,
                         opt_cfg, (rows("calibrate", i) for i in range(n_cal)),
                         steps=n_cal)
    phases["calibrate"] = time.perf_counter() - t_start
    state = init_train_state(weights, sgd_init(weights), gs, policy,
                             init_exp=init_exp)
    del weights
    sup = TrainSupervisor(loss_fn(policy), gs, policy, opt_cfg, state,
                          batch_fn=train_rows,
                          rng=prng.PRNGKey(seed % (1 << 31), device),
                          skip_budget=int(t.get("skip_budget", 3)))
    del state
    if fault == "frozen":
        step = sup._step_fn

        def frozen(state, batch, rng, ef, inj):
            _, metrics, ef2 = step(state, batch, rng, ef, inj)
            return state, metrics, ef2
        sup._step_fn = frozen

    # -- set-up: the steps the reference follows -----------------------------
    n_follow = int(t["followed_steps"])
    p0 = {"/".join(p): x for p, x in leaves_with_path(sup.state.params)}
    prog = {"loss": []}
    setup_records = []
    for i in range(n_follow):
        rec = sup.step_once()
        setup_records.append(rec)
        prog["loss"].append(rec.loss)
        if i == 0:
            prog["grad_norm"] = _norms(torch, sup.state.opt["momentum"])
    delta = {"/".join(p): x - p0["/".join(p)]
             for p, x in leaves_with_path(sup.state.params)}
    prog["update_norm"] = {n: float(torch.linalg.vector_norm(d.double()))
                           for n, d in delta.items()}
    prog["update_moved"] = {n: int(torch.count_nonzero(d))
                            for n, d in delta.items()}
    del delta
    del p0
    phases["followed_steps"] = time.perf_counter() - t_start
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # -- the window ------------------------------------------------------------
    t0 = time.perf_counter()
    records, step_ms = [], []
    while True:
        ts = time.perf_counter()
        records.append(sup.step_once())
        te = time.perf_counter()
        step_ms.append((te - ts) * 1e3)
        if te - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    traced = Traced(torch, trace and cuda)
    traced_records = []
    if trace:
        with traced.device_pass():
            for _ in range(int(t["trace_steps"])):
                traced_records.append(sup.step_once())
        with traced.host_pass():
            for _ in range(int(t["trace_steps"])):
                with span(torch, "supervisor_step", True):
                    sup.step_once()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    enable_pallas_quantize(False)
    del sup
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the plain reference ---------------------------------------------------
    ref = model.train_reference(
        S, seed, {"calibrate": [rows("calibrate", i) for i in range(n_cal)],
                  "train": [rows("train", i) for i in range(n_follow)]},
        t["optimizer"], t["policy"], n_follow, device)
    checks, info = compare(prog, ref, cell.limits)

    ok = [r for r in records if r.outcome is StepOutcome.OK]
    window = t1 - t0
    return {
        "kind": "train",
        "seconds": window,
        "setup_s": t0 - t_start,
        "attempted": len(records),
        "failed": len(records) - len(ok),
        "e2e": {"train_tokens_per_s": len(ok) * B * L / window},
        "memory_peak_bytes": peak,
        "checks": checks,
        "info": dict(info, setup_ends_s=phases, setup_outcomes=[r.outcome.value
                                           for r in setup_records],
                     program_loss=prog["loss"], reference_loss=ref["loss"]),
        "outcomes": [r.outcome.value for r in records],
        "step_ms": step_ms,
        "traced": traced,
        "ok_steps": len(ok),
        "traced_steps": len(traced_records),
        "traced_ok_steps": sum(r.outcome is StepOutcome.OK
                               for r in traced_records),
        "flops_per_step": model.train_flops(S, B, L),
        "gemm_least_s_per_step": model.train_gemm_least_s(S, B, L),
    }
