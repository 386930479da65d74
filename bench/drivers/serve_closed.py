"""Driver of a closed loop of chat clients on the program's continuous
batching engine (``repro_torch.serve.ServeEngine``), one slot a client.

Set-up: weights from the seed, the engine, every client's first request
submitted and prefilled (its budget the residual of its drawn length),
then ``warmup_steps`` engine steps.  The window calls
``ServeEngine.step()`` until ``--seconds`` have passed; after each step a
client whose request has resolved sends its next one at once.  The rate
counts the output tokens produced in the window over its seconds.  The
benchmark's own clock stamps each request when it was due and when the
step after which its first token is visible ended, and each step's
duration.  A traced run adds ``trace_steps`` steps under the profiler
after the window, twice: the card alone, then host and card
(:mod:`harness.profile`).  Once the program is freed, the plain reference runs
over a sample of the finished requests, drawn from the seed with the
longest among them, and reads how far each served token's logit lies
below the reference's best.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from harness.core import mix_params
from harness.program import port_config
from harness import traffic as tr
from harness.profile import Traced, span


def sample_requests(done: list, seed: int, want_tokens: int) -> list:
    """Finished requests to check: the one with the most tokens, then
    others in an order drawn from the seed until ``want_tokens`` served
    tokens are in."""
    if not done:
        return []
    longest = max(done, key=lambda d: len(d["prompt"]) + len(d["served"]))
    rest = [d for d in done if d is not longest]
    rng = np.random.Generator(np.random.PCG64(tr.mix(seed, "check")))
    picked, n = [longest], len(longest["served"])
    for i in rng.permutation(len(rest)):
        if n >= want_tokens:
            break
        picked.append(rest[i])
        n += len(rest[i]["served"])
    return picked


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, smoke: bool = False, fault: str = "") -> dict:
    import torch
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.serve import EngineOptions, RequestStatus, ServeEngine

    cuda = device.startswith("cuda")
    t = mix_params(cell, smoke)
    model = cell.model()
    S = model.sizes(cell.config, smoke)
    mcfg = port_config(cell, smoke)
    pol = t["policy"]
    policy = PrecisionPolicy(pol["arithmetic"], comp_width=pol["comp_width"],
                             update_width=pol["update_width"])
    plan = tr.chat_plan(t, S["published_vocab_size"], seed)
    C = int(t["clients"])
    phases = {"start": time.perf_counter() - t_start}
    weights = model.make_weights(S, seed, device)
    eng = ServeEngine(mcfg, policy, weights, max_slots=C,
                      max_len=t["prompt"]["max"] + t["output"]["max"],
                      options=EngineOptions(init_exp=float(pol["init_exp"])),
                      device=device)
    del weights
    phases["engine"] = time.perf_counter() - t_start
    restore = _plant(eng, fault)
    traces = eng.metrics.traces
    nxt = [0] * C
    owner, due, pending, inflight = {}, {}, set(), set()

    def submit(c: int, now: float) -> None:
        if nxt[c] >= len(plan[c]):
            raise RuntimeError(f"client {c} ran out of requests: raise "
                               "requests_per_client in the mix")
        r = plan[c][nxt[c]]
        uid = eng.submit(r["prompt"], max_new=r["max_new"])
        owner[uid] = (c, nxt[c])
        nxt[c] += 1
        due[uid] = now
        pending.add(uid)
        inflight.add(uid)

    done, ttft_ms, step_ms = [], [], []
    work = {"prefill": 0.0, "first_tokens": 0}

    def settle(now: float, record: bool, on: bool = False) -> None:
        """After a step: first tokens, resolved requests, next requests."""
        for uid in [u for u in pending if traces[u].new_tokens > 0]:
            pending.discard(uid)
            if record:
                ttft_ms.append((now - due[uid]) * 1e3)
                c, i = owner[uid]
                work["prefill"] += model.prefill_flops(
                    S, len(plan[c][i]["prompt"]))
                work["first_tokens"] += 1
        with span(torch, "admission", on):
            for uid in [u for u in inflight if eng.status(u) is not None]:
                inflight.discard(uid)
                pending.discard(uid)
                c, i = owner[uid]
                if record:
                    done.append({"uid": uid, "status": eng.status(uid),
                                 "prompt": plan[c][i]["prompt"],
                                 "served": eng.results[uid]})
                submit(c, now)

    # -- set-up: every client's first request in flight ----------------------
    now = time.perf_counter()
    for c in range(C):
        submit(c, now)
    while pending:
        eng.step()
        settle(time.perf_counter(), record=False)
    phases["first_requests"] = time.perf_counter() - t_start
    for _ in range(int(t["warmup_steps"])):
        eng.step()
        settle(time.perf_counter(), record=False)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # -- the window ------------------------------------------------------------
    base = {u: tr_.new_tokens for u, tr_ in traces.items()}
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        eng.step()
        te = time.perf_counter()
        step_ms.append((te - ts) * 1e3)
        settle(te, record=True)
        if te - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    produced = sum(x.new_tokens - base.get(u, 0) for u, x in traces.items())

    window_flops = work["prefill"] + (produced - work["first_tokens"]) \
        * model.decode_flops(S)

    traced = Traced(torch, trace and cuda)
    if trace:
        with traced.device_pass():
            for _ in range(int(t["trace_steps"])):
                eng.step()
                settle(time.perf_counter(), record=False)
        with traced.host_pass():
            for _ in range(int(t["trace_steps"])):
                with span(torch, "engine_step", True):
                    eng.step()
                settle(time.perf_counter(), record=False, on=True)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    restore()
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the plain reference ---------------------------------------------------
    ok = [d for d in done if d["status"] is RequestStatus.OK]
    picked = sample_requests(ok, seed, int(t["check_tokens"]))
    ref = model.Reference(model.make_weights(S, seed, device), S, pol)
    widest, checked = float("inf"), 0
    if picked:
        widest = 0.0
        for d in picked:
            g = model.gaps(ref.logits(d["prompt"], d["served"]), d["served"])
            widest = max(widest, float(g.max()))
            checked += len(d["served"])
    checks = {"logit_gap": {"value": widest,
                            "limit": cell.limits["logit_gap"]}}
    window = t1 - t0
    return {
        "kind": "serve",
        "seconds": window,
        "setup_s": t0 - t_start,
        "attempted": len(done),
        "failed": len(done) - len(ok),
        "e2e": {"serve_tokens_per_s": produced / window},
        "memory_peak_bytes": peak,
        "checks": checks,
        "info": {"setup_ends_s": phases, "checked_requests": len(picked),
                 "checked_tokens": checked,
                 "ttft_samples": len(ttft_ms), "steps": len(step_ms)},
        "ttft_ms": ttft_ms,
        "step_ms": step_ms,
        "traced": traced,
        "window_flops": window_flops,
    }


def _plant(eng, fault: str):
    """A fault under the timed path, for the harness's own tests: every
    produced token altered (``token``), or the SSM decode step returning
    the state it was given, conv window and SSM state (``frozen_state``).
    Returns the undo."""
    if fault == "token":
        sample = eng._sample
        V = eng.cfg.vocab_size

        def altered(*a, **k):
            tok, *rest = sample(*a, **k)
            return ((np.asarray(tok) + 1) % V, *rest)
        eng._sample = altered
        return lambda: None
    if fault == "frozen_state":
        from repro_torch.models import transformer
        ssm = transformer.S
        decode = ssm.ssm_decode

        def frozen(params, spec, u, cache, tape, prefix):
            y, _ = decode(params, spec, u, cache, tape, prefix)
            return y, {"conv": cache["conv"], "state": cache["state"]}
        ssm.ssm_decode = frozen
        return lambda: setattr(ssm, "ssm_decode", decode)
    return lambda: None
