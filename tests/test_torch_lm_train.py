"""The dense LM's training half in the port against the reference, on the CPU.

Two smoke configs: llama3's (untied head) and a tied 2-layer LM (the
shape of the example's LM_100M).  Same numpy batches through ``repro``
(JAX) and ``repro_torch`` (torch, plain kernel versions):

  * ``init_params`` from one key: bit for bit, and a draw in row blocks
    equals the whole draw;
  * ``loss_fn``: loss within 1e-6 relative (float32, DFXP), forward and
    backward statistics exactly equal; gradients within 1e-5 of each
    leaf's largest value in float32 (f32 sums in another order) and
    exactly equal under DFXP (every product's inputs on the grid);
  * ``ce_chunk > 0`` equals ``ce_chunk = 0`` within 1e-6 (loss) and 1e-5
    (gradients), and matches the reference's chunked loss;
  * ``calibrate``: the initial exponents exactly equal;
  * three supervised DFXP 10/12 steps (adamw, the LM recipe) through
    each package's ``TrainSupervisor``: exponents and ``acc`` windows
    exactly equal, losses within 1e-4, fused matmul (K2's plain version)
    included.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data import synthetic as jdata
from repro.models import transformer as JT
from repro.optim import opt as jopt
from repro.train import TrainSupervisor as JSup
from repro.train import init_train_state as j_init_state
from repro.train.calibrate import calibrate as j_calibrate
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.train import TrainSupervisor as TSup
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train.calibrate import calibrate as t_calibrate
from repro_torch.train.step import loss_and_grads

TIED = dict(name="lm-tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=256, tie_embeddings=True)
CFGS = {"llama3_smoke": (jconfigs.get_smoke("llama3_8b"),
                         tconfigs.get_smoke("llama3_8b")),
        "tied": (JT.ModelConfig(**TIED), TT.ModelConfig(**TIED))}
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small tensors: the suite runs
    several test processes at once, and torch's thread pools in each of
    them would otherwise wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, step=0):
    return jdata.SyntheticLM(cfg.vocab_size, S, B, seed=0).batch(step)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


def _np(d):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


@pytest.mark.parametrize("name", list(CFGS))
def test_init_params_match_reference(name):
    jcfg, tcfg = CFGS[name]
    jp = _flat(JT.init_params(jcfg, jax.random.PRNGKey(5)))
    tp = _flat(TT.init_params(tcfg, 5, device="cpu"))
    tk = _flat(TT.init_params(tcfg, prng.PRNGKey(5), device="cpu"))
    assert set(jp) == set(tp) and ("head" in jp) == (not jcfg.tie_embeddings)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        np.testing.assert_array_equal(tk[k], jp[k], err_msg=k)


def test_normal_row_blocks_equal_the_whole_draw():
    key = prng.PRNGKey(11)
    whole = prng.normal(key, (37, 19))
    for block in (19, 50, 37 * 19, 1 << 24):
        assert torch.equal(prng.normal_blocked(key, (37, 19),
                                               max_block=block), whole)
    keys = prng.split(key, 3)
    got = prng.normal_blocked(keys, (5, 7), max_block=14)
    for i in range(3):
        assert torch.equal(got[i], prng.normal(keys[i], (5, 7)))
    want = np.asarray(jax.random.normal(
        jax.random.PRNGKey(11), (37, 19)))
    np.testing.assert_array_equal(
        prng.normal_blocked(key, (37, 19), max_block=40).numpy(), want)


def _losses(name, arith, ce_chunk=0, reference=True):
    jcfg, tcfg = CFGS[name]
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    gs = JT.group_shapes(jcfg)
    b = _batch(jcfg)
    jexps = {n: jnp.full(s, -6.0) for n, s in gs.items()}
    texps = {n: torch.full(s, -6.0) for n, s in gs.items()}
    jsinks = {n: jnp.zeros(s + (3,)) for n, s in gs.items()
              if n.startswith("g:")}
    tsinks = {n: torch.zeros(s + (3,), requires_grad=True)
              for n, s in gs.items() if n.startswith("g:")}
    jpol, tpol = JPolicy(arith), TPolicy(arith)

    def jl(p, s):
        return JT.loss_fn(jcfg, jpol, p, {k: jnp.asarray(v)
                                          for k, v in b.items()},
                          jexps, s, ce_chunk=ce_chunk)

    ref = None
    if reference:
        (jloss, jst), (jg, jsg) = jax.jit(jax.value_and_grad(
            jl, argnums=(0, 1), has_aux=True))(jp, jsinks)
        ref = (float(jloss), jst, jg, jsg)
    t = loss_and_grads(
        lambda p, bb, s, e: TT.loss_fn(tcfg, tpol, p, bb, e, s,
                                       ce_chunk=ce_chunk),
        tp, {k: torch.from_numpy(v) for k, v in b.items()}, tsinks, texps)
    return ref, t


@pytest.mark.parametrize("arith", ["float32", "dfxp"])
@pytest.mark.parametrize("name", list(CFGS))
def test_loss_fn_matches_reference(name, arith):
    (jloss, jst, jg, jsg), (tloss, tst, tg, tsg) = _losses(name, arith)
    assert abs(float(tloss) - jloss) <= 1e-6 * abs(jloss)
    assert set(jst) == set(tst) and set(jsg) == set(tsg)
    for want, got in ((jst, tst), (jsg, tsg)):
        for k in want:
            np.testing.assert_array_equal(_np(got)[k], np.asarray(want[k]),
                                          err_msg=k)
    jgf, tgf = _flat(jg), _flat(tg)
    assert set(jgf) == set(tgf)
    for k in jgf:
        if arith == "dfxp":
            np.testing.assert_array_equal(tgf[k], jgf[k], err_msg=k)
        else:
            top = float(np.abs(jgf[k]).max())
            np.testing.assert_allclose(tgf[k], jgf[k], rtol=0,
                                       atol=1e-5 * top, err_msg=k)


@pytest.mark.parametrize("name", list(CFGS))
def test_chunked_ce_equals_whole(name):
    _, (l0, st0, g0, sg0) = _losses(name, "dfxp", reference=False)
    (jlc, jstc, _, _), (lc, stc, gc, sgc) = _losses(name, "dfxp",
                                                    ce_chunk=S // 4)
    assert abs(float(lc) - float(l0)) <= 1e-6 * abs(float(l0))
    assert abs(float(lc) - jlc) <= 1e-6 * abs(jlc)
    for k in st0:
        np.testing.assert_array_equal(stc[k].numpy(), st0[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(stc[k].numpy(),
                                      np.asarray(jstc[k]), err_msg=k)
    for k in sg0:
        np.testing.assert_array_equal(sgc[k].numpy(), sg0[k].numpy(),
                                      err_msg=k)
    g0f, gcf = _flat(g0), _flat(gc)
    for k in g0f:
        top = float(np.abs(g0f[k]).max())
        np.testing.assert_allclose(gcf[k], g0f[k], rtol=0, atol=1e-5 * top,
                                   err_msg=k)


OPT = dict(kind="adamw", lr=3e-3, lr_decay_steps=1000)


@functools.lru_cache(maxsize=None)
def _calibrated(name, steps=2):
    jcfg, tcfg = CFGS[name]
    gs = JT.group_shapes(jcfg)
    jpol, tpol = JPolicy("dfxp"), TPolicy("dfxp")
    jobs = dataclasses.replace(jpol, arithmetic="observe", storage="sim")
    tobs = dataclasses.replace(tpol, arithmetic="observe", storage="sim")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, 0, device="cpu")
    batches = [_batch(jcfg, i) for i in range(steps)]
    je = j_calibrate(
        lambda p, b, s, e: JT.loss_fn(jcfg, jobs, p, b, e, s), jp, gs, jpol,
        jopt.OptConfig(**OPT),
        ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
        steps=steps)
    te = t_calibrate(
        lambda p, b, s, e: TT.loss_fn(tcfg, tobs, p, b, e, s), tp, gs, tpol,
        topt.OptConfig(**OPT),
        ({k: torch.from_numpy(v) for k, v in b.items()} for b in batches),
        steps=steps)
    return je, te


@pytest.mark.parametrize("name", list(CFGS))
def test_calibrate_exponents_match_reference(name):
    je, te = _calibrated(name)
    assert set(je) == set(te)
    for k in je:
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]),
                                      err_msg=k)


@functools.lru_cache(maxsize=None)
def _reference_supervised(steps=3):
    """The reference's side of the supervised test: its unfused DFXP
    10/12 steps (its fused path gives the same numbers)."""
    jcfg, _ = CFGS["tied"]
    je, _ = _calibrated("tied")
    gs = JT.group_shapes(jcfg)
    jpol = JPolicy("dfxp", comp_width=10, update_width=12, update_interval=2)
    jp = JT.init_params(jcfg, jax.random.fold_in(jax.random.PRNGKey(0), 1))
    data = jdata.SyntheticLM(jcfg.vocab_size, S, B, seed=0)
    jsup = JSup(lambda p, b, s, e: JT.loss_fn(jcfg, jpol, p, b, e, s), gs,
                jpol, jopt.OptConfig(**OPT),
                j_init_state(jp, jopt.adamw_init(jp), gs, jpol, init_exp=je),
                batch_fn=lambda c: {k: jnp.asarray(v)
                                    for k, v in data.batch(c).items()},
                rng=jax.random.PRNGKey(0))
    jsup.run(steps)
    return (jsup.losses, {k: np.asarray(v) for k, v in
                          jsup.state.scale.exps.items()},
            {k: np.asarray(v) for k, v in jsup.state.scale.acc.items()})


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_supervised_dfxp_steps_match_reference(fused):
    """Three supervised DFXP 10/12 steps on the tied LM from calibrated
    exponents, controller interval 2 (so it both accumulates and
    applies): exponents and ``acc`` windows exact, losses within 1e-4.
    The port's fused path runs K2's plain version; the reference runs
    its unfused composite (its fused one is the same numbers)."""
    jcfg, tcfg = CFGS["tied"]
    _, te = _calibrated("tied")
    jlosses, jexps, jacc = _reference_supervised()
    gs = JT.group_shapes(jcfg)
    tpol = TPolicy("dfxp", comp_width=10, update_width=12, update_interval=2,
                   fused_matmul=fused)
    tp = TT.init_params(tcfg, prng.fold_in(prng.PRNGKey(0), 1), device="cpu")
    data = jdata.SyntheticLM(jcfg.vocab_size, S, B, seed=0)
    tsup = TSup(lambda p, b, s, e: TT.loss_fn(tcfg, tpol, p, b, e, s), gs,
                tpol, topt.OptConfig(**OPT),
                t_init_state(tp, topt.adamw_init(tp), gs, tpol, init_exp=te),
                batch_fn=lambda c: {k: torch.from_numpy(v)
                                    for k, v in data.batch(c).items()},
                rng=0)
    tsup.run(3)
    assert [r.outcome.value for r in tsup.outcomes] == ["ok"] * 3
    np.testing.assert_allclose(tsup.losses, jlosses, rtol=0, atol=1e-4)
    for what, want in (("exps", jexps), ("acc", jacc)):
        got = getattr(tsup.state.scale, what)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("storage", ["sim", "packed"])
def test_num_params_matches_reference(storage):
    """``TrainState.num_params`` counts what the reference's counts: every
    parameter element, a packed leaf by its mantissa's elements."""
    jcfg, tcfg = CFGS["tied"]
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    js = j_init_state(jp, jopt.sgd_init(jp), JT.group_shapes(jcfg),
                      JPolicy("dfxp", storage=storage))
    ts = t_init_state(tp, topt.sgd_init(tp), TT.group_shapes(tcfg),
                      TPolicy("dfxp", storage=storage))
    from repro_torch.core.packed import PackedArray
    packed = [x for x in jax.tree.leaves(
        ts.params, is_leaf=lambda n: isinstance(n, PackedArray))
        if isinstance(x, PackedArray)]
    assert bool(packed) == (storage == "packed")
    assert ts.num_params() == js.num_params() == sum(
        x.size for x in jax.tree.leaves(jp))
