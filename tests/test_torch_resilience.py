"""The port's fault-tolerant training (``repro_torch.train.resilience``,
``.faults``, supervised ``make_train_step``) on the CPU.

The cases of ``tests/test_train_resilience.py`` on the port, on the same
maxout config and recipe: sentinels, "skipped = never poisoned", the
runaway-overflow sentinel, rollback, HALTED with a bundle whose trace
passes ``validate_trace``, bit-exact resume (deterministic, stochastic
rounding with fused matmul, packed storage), bit flips, checkpoint tears,
chaos sweeps and the outcome counters.  Across the packages: for one
``chaos_plan(seed)`` the port's and the reference's supervisors resolve
the same outcome sequence.  And the step is functional: it never writes
the state it was given (an asynchronous checkpoint relies on that).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import PrecisionPolicy as JPolicy
from repro.models import maxout as JMX
from repro.optim.opt import OptConfig as JOpt
from repro.optim.opt import sgd_init as j_sgd_init
from repro.train import FaultHarness as JHarness
from repro.train import TrainSupervisor as JSup
from repro.train import chaos_plan as j_chaos_plan
from repro.train import init_train_state as j_init_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data import SyntheticImages
from repro_torch.models import maxout as MX
from repro_torch.obs import MetricsRegistry, Tracer, validate_trace
from repro_torch.optim.opt import OptConfig, sgd_init
from repro_torch.train import (FaultHarness, GradNaN, LossSpike, ParamBitFlip,
                               StepOutcome, TrainSupervisor, benign_injection,
                               chaos_plan, init_train_state, make_train_step)
from repro_torch.train.faults import CkptTear

CFG = MX.MaxoutConfig(hidden=(48, 48), pieces=3)
GS = MX.group_shapes(CFG)
OPT = dict(kind="sgd", lr=0.1, lr_decay_steps=2000, max_col_norm=1.9365)
DATA = SyntheticImages()
DFXP = PrecisionPolicy("dfxp", comp_width=10, update_width=12,
                       update_interval=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small tensors: the suite runs
    several test processes at once, and torch's thread pools in each of
    them would otherwise wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_fn(policy):
    def loss_fn(p, b, s, exps):
        return MX.loss_fn(CFG, policy, p, b, exps, s, rng=prng.PRNGKey(1))
    return loss_fn


def _batch_fn(cursor):
    return {k: torch.from_numpy(v) for k, v in DATA.batch(cursor, 64).items()}


def _state(policy, seed=7):
    params = MX.init_params(CFG, seed, device="cpu")
    return init_train_state(params, sgd_init(params), GS, policy,
                            init_exp=-8.0)


def _sup(policy=DFXP, **kw):
    kw.setdefault("batch_fn", _batch_fn)
    kw.setdefault("rng", prng.PRNGKey(0))
    return TrainSupervisor(_loss_fn(policy), GS, policy, OptConfig(**OPT),
                           _state(policy), **kw)


def _leaves(tree):
    return [x for _, x in flatten(tree)]


# ---------------------------------------------------------------- sentinels

def test_sentinel_skips_and_preserves_state():
    h = FaultHarness([GradNaN(step=2), LossSpike(step=5)])
    sup = _sup(faults=h, skip_budget=10)
    summary = sup.run(8)
    outs = [r.outcome for r in sup.outcomes]
    assert outs[2] is StepOutcome.SKIPPED
    assert outs[5] is StepOutcome.SKIPPED
    assert summary["outcomes"]["ok"] == 6
    assert summary["steps_committed"] == 6      # skips never hit the state
    assert summary["cursor"] == 8               # but the cursor moved on
    assert all(np.isfinite(loss) for loss in sup.losses)
    assert sup.outcomes[2].info["sentinels"] == ["grad_nonfinite"]
    assert "loss_nonfinite" in sup.outcomes[5].info["sentinels"]
    kinds = {e["kind"] for e in h.log}
    assert "grad_nan" in kinds and "loss_spike" in kinds


def test_skipped_step_is_identical_to_never_poisoned():
    h = FaultHarness([GradNaN(step=3)])
    a = _sup(faults=h, skip_budget=10)
    a.run(6)
    c = _sup(skip_budget=10,
             batch_fn=lambda i: _batch_fn(i if i < 3 else i + 1))
    c.run(5)
    for x, y in zip(_leaves(a.state), _leaves(c.state)):
        assert torch.equal(x, y)


def test_runaway_overflow_sentinel_fires():
    sup = _sup(runaway_ovf=1e-12, skip_budget=1000)
    sup.run(3)
    skipped = [r for r in sup.outcomes if r.outcome is StepOutcome.SKIPPED]
    assert skipped, [r.outcome for r in sup.outcomes]
    assert any("runaway_ovf" in r.info.get("sentinels", ())
               for r in skipped)
    # a runaway-only trip keeps params and step but adopts the new scale
    assert int(sup.state.step) == 0
    assert any(float(v.sum()) > 0 for v in sup.state.scale.acc.values())


def test_step_is_functional():
    """A supervised step returns a new state and leaves the one it was
    given as it was (``save_async`` may still be copying it)."""
    state = _state(DFXP)
    before = [x.clone() for x in _leaves(state)]
    step = make_train_step(_loss_fn(DFXP), GS, DFXP, OptConfig(**OPT),
                           supervise=True)
    new, metrics, ef = step(state, _batch_fn(0), prng.PRNGKey(0), {},
                            benign_injection())
    assert int(metrics["flags"]) == 0 and ef == {}
    assert int(new.step) == 1
    for x, b in zip(_leaves(state), before):
        assert torch.equal(x, b)
    assert any(not torch.equal(x, y)
               for x, y in zip(_leaves(state.params), _leaves(new.params)))


# ---------------------------------------------------------------- rollback

def test_skip_budget_exhaustion_rolls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    h = FaultHarness([GradNaN(step=4, count=4)])
    sup = _sup(manager=mgr, ckpt_every=2, skip_budget=2, faults=h)
    summary = sup.run(12)
    outs = [r.outcome for r in sup.outcomes]
    assert StepOutcome.ROLLED_BACK in outs
    rb = outs.index(StepOutcome.ROLLED_BACK)
    assert sup.outcomes[rb].info["restored"] == 4   # ckpt at cursor 4
    assert outs[-1] is StepOutcome.OK
    assert not summary["halted"]
    assert summary["cursor"] == 12      # the poisoned window not replayed


def test_double_rollback_failure_halts_with_bundle(tmp_path):
    bundle = str(tmp_path / "bundle")
    h = FaultHarness([GradNaN(step=0, count=100)], tracer=Tracer())
    sup = _sup(manager=None, skip_budget=1, faults=h, tracer=h.tracer,
               bundle_dir=bundle)
    summary = sup.run(50)
    assert summary["halted"]
    outs = [r.outcome for r in sup.outcomes]
    assert outs[-1] is StepOutcome.HALTED
    assert outs.count(StepOutcome.ROLLED_BACK) == 1
    assert summary["attempts"] < 50
    for fname in ("outcomes.json", "summary.json", "faults.json",
                  "trace.json"):
        assert os.path.exists(os.path.join(bundle, fname)), fname
    with open(os.path.join(bundle, "outcomes.json")) as f:
        assert json.load(f)[-1]["outcome"] == "halted"
    with open(os.path.join(bundle, "trace.json")) as f:
        trace = json.load(f)
    validate_trace(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train_step", "fault:grad_nan", "train:sentinel_skip",
            "train:rollback_failed"} <= names
    with pytest.raises(RuntimeError):
        sup.step_once()


# ---------------------------------------------------------- bit-exact resume

def _resume_pair(policy, *, tmp_path, n=10, k=6):
    solo = _sup(policy)
    solo.run(n)
    d = str(tmp_path / "ck")
    first = _sup(policy, manager=CheckpointManager(d))
    first.run(k)                         # run() commits synchronously
    del first                            # the "crash"
    second = _sup(policy, rng=prng.PRNGKey(4242),   # the checkpoint must
                  manager=CheckpointManager(d))     # carry the key
    assert second.resume() == k
    second.run(n - k)
    return solo, second


def _assert_bit_identical(solo, resumed, k):
    assert solo.losses[k:] == resumed.losses
    a, b = flatten(solo.ckpt_tree()), flatten(resumed.ckpt_tree())
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("policy,n,k", [
    (DFXP, 10, 6),
    (dataclasses.replace(DFXP, stochastic_rounding=True, fused_matmul=True),
     9, 5),
    (dataclasses.replace(DFXP, storage="packed"), 8, 5)],
    ids=["deterministic", "stochastic_fused", "packed"])
def test_bit_exact_resume(tmp_path, policy, n, k):
    """K lands mid-§5-window (interval 4): the pre-reset ``acc`` windows,
    the base key and the cursor are checkpointed."""
    solo, resumed = _resume_pair(policy, tmp_path=tmp_path, n=n, k=k)
    _assert_bit_identical(solo, resumed, k)


# -------------------------------------------------------------- host faults

def test_param_bit_flip_packed_and_sim_skip():
    pol = dataclasses.replace(DFXP, storage="packed")
    h = FaultHarness([ParamBitFlip(step=2, bit=6)])
    sup = _sup(pol, faults=h, skip_budget=100)
    sup.run(5)
    flip = [e for e in h.log if e["kind"] == "bit_flip"]
    assert flip and flip[0]["new"] == flip[0]["old"] ^ (1 << 6)
    h2 = FaultHarness([ParamBitFlip(step=2)])
    _sup(DFXP, faults=h2, skip_budget=100).run(4)
    assert any(e["kind"] == "bit_flip_skipped" for e in h2.log)


@pytest.mark.parametrize("mode", ["strip", "corrupt"])
def test_ckpt_tear_falls_back_to_previous_commit(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path))
    sup = _sup(manager=mgr, ckpt_every=2)
    sup.run(6)                       # commits at 2, 4, 6
    mgr.wait()
    h = FaultHarness([CkptTear(step=0, mode=mode)])
    h._tear(sup, h.faults[0], 0)
    assert any(e["kind"] == "ckpt_tear" for e in h.log)
    tree, step = mgr.restore_latest(sup.ckpt_template())
    assert step == 4                 # newest (6) torn -> previous commit
    assert int(tree["cursor"]) == 4


def test_ckpt_tear_writer_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=0, backoff_s=0.0)
    h = FaultHarness([CkptTear(step=1, mode="writer")])
    sup = _sup(manager=mgr, ckpt_every=2, faults=h)
    summary = sup.run(6)
    assert not summary["halted"]
    assert summary["outcomes"]["ok"] == 6
    kinds = [e["kind"] for e in h.log]
    assert "ckpt_tear" in kinds
    assert any(k in ("sup:ckpt_async_error", "sup:ckpt_write_error")
               for k in kinds), kinds
    assert mgr.latest() is not None


# -------------------------------------------------------------------- chaos

@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_sweep_every_step_resolves(tmp_path, seed):
    pol = dataclasses.replace(DFXP, storage="packed")
    faults = chaos_plan(seed, n_steps=14, burst=4)
    assert faults
    mgr = CheckpointManager(str(tmp_path), retries=0, backoff_s=0.0)
    h = FaultHarness(faults, seed=seed, tracer=Tracer(),
                     metrics=MetricsRegistry())
    sup = _sup(pol, manager=mgr, ckpt_every=2, skip_budget=2, faults=h,
               bundle_dir=str(tmp_path / "bundle"))
    summary = sup.run(14)
    assert summary["attempts"] == len(sup.outcomes) == 14
    assert sum(summary["outcomes"].values()) == summary["attempts"]
    again = chaos_plan(seed, n_steps=14, burst=4)
    assert [type(f).__name__ for f in again] == \
           [type(f).__name__ for f in faults]
    json.dumps(h.summary())


def test_chaos_outcomes_match_reference(tmp_path):
    """One ``chaos_plan(0)`` (a corrupt tear, a bit flip, a 4-step NaN
    burst) through the reference's and the port's supervisors on the
    reference's test config: the same outcome, flags and cursor at every
    attempt, and the same fault-log kinds."""
    seed, n = 0, 14
    assert [type(f) for f in chaos_plan(seed, n_steps=n, burst=4)] == \
        [CkptTear, ParamBitFlip, GradNaN]
    assert [dataclasses.astuple(f) for f in
            j_chaos_plan(seed, n_steps=n, burst=4)] == \
        [dataclasses.astuple(f) for f in chaos_plan(seed, n_steps=n,
                                                    burst=4)]
    pol = dataclasses.replace(DFXP, storage="packed")
    h = FaultHarness(chaos_plan(seed, n_steps=n, burst=4), seed=seed)
    sup = _sup(pol, manager=CheckpointManager(str(tmp_path / "port"),
                                              retries=0, backoff_s=0.0),
               ckpt_every=2, skip_budget=2, faults=h)
    sup.run(n)

    jpol = JPolicy("dfxp", comp_width=10, update_width=12, update_interval=4,
                   storage="packed")
    jparams = JMX.init_params(JMX.MaxoutConfig(hidden=(48, 48), pieces=3),
                              jax.random.PRNGKey(7))
    jh = JHarness(j_chaos_plan(seed, n_steps=n, burst=4), seed=seed)
    jsup = JSup(
        lambda p, b, s, e: JMX.loss_fn(
            JMX.MaxoutConfig(hidden=(48, 48), pieces=3), jpol, p, b, e, s,
            rng=jax.random.PRNGKey(1)),
        GS, jpol, JOpt(**OPT),
        j_init_state(jparams, j_sgd_init(jparams), GS, jpol, init_exp=-8.0),
        batch_fn=lambda c: {k: jnp.asarray(v)
                            for k, v in DATA.batch(c, 64).items()},
        rng=jax.random.PRNGKey(0),
        manager=JManager(str(tmp_path / "ref"), retries=0, backoff_s=0.0),
        ckpt_every=2, skip_budget=2, faults=jh)
    jsup.run(n)

    def seq(s):
        return [(r.cursor, r.outcome.value, r.flags) for r in s.outcomes]

    assert seq(sup) == seq(jsup)
    assert StepOutcome.ROLLED_BACK in [r.outcome for r in sup.outcomes]
    assert [e["kind"] for e in h.log] == [e["kind"] for e in jh.log]


def test_supervisor_outcome_counters_in_metrics():
    reg = MetricsRegistry()
    h = FaultHarness([GradNaN(step=1)], metrics=reg)
    sup = _sup(faults=h, skip_budget=10, metrics=reg)
    sup.run(4)
    assert reg.counter("train_steps_ok").value == 3
    assert reg.counter("train_steps_skipped").value == 1
    assert reg.counter("train_faults_injected").value == 1
    assert reg.counter("train_ckpt_commits").value == 0     # no manager


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="item 22"):
        _sup(compress_bits=8)
    with pytest.raises(NotImplementedError, match="item 19"):
        _sup(numerics_log=object())


def test_packed_adamw_under_supervise_raises():
    """adamw's moments come back in f32 where the state held them packed,
    and the discard's select needs one structure (the reference fails on
    the same mismatch at its first step)."""
    pol = dataclasses.replace(DFXP, storage="packed")
    with pytest.raises(ValueError, match="takes SGD"):
        make_train_step(_loss_fn(pol), GS, pol,
                        OptConfig(kind="adamw", lr=1e-3), supervise=True)
