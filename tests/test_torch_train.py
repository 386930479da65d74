"""Parity of the port's training slice with the reference, on the CPU.

Same numpy inputs and the reference's own parameters (carried across by
``maxout_params_from_jax``) through ``repro`` (JAX) and ``repro_torch``
(torch, plain kernel versions), dropout off (the reference's ``rng=None``
path) and deterministic rounding:

  * ``SyntheticImages``/``SyntheticLM`` batches: bit-equal.
  * maxout forward, PI and conv: logits within ``rtol=1e-5`` (f32 products
    summed in different orders), forward statistics exactly equal.
  * one train step (two, so the controller both accumulates and applies)
    for float32, float16, fixed 20/20 and DFXP 10/12 fused and unfused, in
    sim and packed storage: loss within 1e-5 relative (1e-4 under rounded
    arithmetic, where one flipped activation tie moves it by ~3e-5);
    exponents and ``acc`` windows exactly equal; parameters and momentum
    ≥ 99.9% of elements equal and the rest one flipped rounding apart
    (:func:`_assert_grid_close`).  The only allowed cause of a difference
    is a rounding tie flipped by an ulp of an f32 product or sum, whose
    order differs between XLA and PyTorch.
  * ``calibrate``: initial exponents exactly equal.

The 50-step Table-3 gate is in ``test_torch_train_gate.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packed import PackedArray as JPacked
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data import synthetic as jdata
from repro.models import maxout as JMX
from repro.optim import opt as jopt
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train.calibrate import calibrate as j_calibrate
from repro_torch.core.packed import PackedArray as TPacked
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.data import synthetic as tdata
from repro_torch.models import maxout as TMX
from repro_torch.models.convert import maxout_params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from repro_torch.train.calibrate import calibrate as t_calibrate

PI = dict(hidden=(32, 24), pieces=3)
OPT = dict(kind="sgd", lr=0.1, lr_decay_steps=2000, max_col_norm=1.9365)


def _tcfg(jcfg):
    return TMX.MaxoutConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    """Nested dict of numpy arrays; packed leaves as their values."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, JPacked):
        return (np.asarray(tree.mantissa, np.float32)
                * np.exp2(np.asarray(tree.exp, np.float32)))
    if isinstance(tree, TPacked):
        return (tree.mantissa.to(torch.float32).numpy()
                * np.exp2(tree.exp.numpy()))
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _exps_np(d):
    return {k: np.array(v, np.float32) for k, v in d.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(image_shape=(1, 28, 28)),
                                dict(hard=True), dict(num_hosts=2, host_id=1,
                                                      seed=3)],
                         ids=["pi", "conv", "hard", "sharded"])
def test_synthetic_images_batches_bit_equal(kw):
    kw = dict(kw)
    if kw.pop("hard", False):
        j, t = jdata.SyntheticImages.hard(**kw), tdata.SyntheticImages.hard(**kw)
    else:
        j, t = jdata.SyntheticImages(**kw), tdata.SyntheticImages(**kw)
    for step in (0, 7, 123):
        jb, tb = j.batch(step, 32), t.batch(step, 32)
        for k in ("x", "y"):
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    np.testing.assert_array_equal(j.eval_set(64)["x"], t.eval_set(64)["x"])


def test_synthetic_lm_batches_bit_equal():
    j = jdata.SyntheticLM(vocab_size=97, seq_len=16, global_batch=4, seed=2)
    t = tdata.SyntheticLM(vocab_size=97, seq_len=16, global_batch=4, seed=2)
    for step in (0, 5):
        jb, tb = j.batch(step), t.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(jb[k], tb[k])


# ---------------------------------------------------------------------------
# the maxout model
# ---------------------------------------------------------------------------

CONV = dict(conv=True, conv_channels=(4, 6), image_shape=(1, 12, 12),
            input_dim=144, pieces=2)


@pytest.mark.parametrize("kw", [PI, CONV, dict(CONV, conv_kernel=4)],
                         ids=["pi", "conv5", "conv4"])
@pytest.mark.parametrize("arith", ["dfxp", "fixed", "observe", "float32"])
def test_maxout_forward_matches_reference(kw, arith):
    jcfg = JMX.MaxoutConfig(**kw)
    tcfg = _tcfg(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(3))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    shape = tcfg.image_shape if tcfg.conv else ()
    b = tdata.SyntheticImages(input_dim=tcfg.input_dim,
                              image_shape=shape).batch(0, 16)
    gs = JMX.group_shapes(jcfg)
    assert gs == TMX.group_shapes(tcfg)
    exps = {k: np.float32(-8.0 if k.startswith("a:") else -10.0) for k in gs}
    jl, js = JMX.forward(jcfg, JPolicy(arith), jp, jnp.asarray(b["x"]),
                         {k: jnp.asarray(v) for k, v in exps.items()}, {})
    tl, ts = TMX.forward(tcfg, TPolicy(arith), tp, torch.from_numpy(b["x"]),
                         {k: torch.tensor(v) for k, v in exps.items()}, {})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-6)
    assert set(js) == set(ts)
    for k in js:
        if arith == "observe":       # max|x| of f32 values: to their ulps
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, err_msg=k)
        else:                        # overflow counts: exact
            np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                          err_msg=k)
    if arith == "dfxp":
        assert sum(float(v[0]) for v in ts.values()) > 0   # some overflow


def test_maxout_dropout_with_a_generator_raises():
    """Dropout draws from threefry keys, as the reference's: a
    ``torch.Generator`` is refused, and a key gives the reference's
    compiled training forward (its masks, its ``x * (1 / (1 - rate))``)."""
    jcfg = JMX.MaxoutConfig(**PI)
    cfg = _tcfg(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(0))
    p = maxout_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    x = tdata.SyntheticImages().batch(0, 8)["x"]
    with pytest.raises(TypeError, match="Generator"):
        TMX.forward(cfg, TPolicy("float32"), p, torch.from_numpy(x), {}, {},
                    rng=torch.Generator())
    key = jax.random.PRNGKey(1)
    for c in (jcfg, dataclasses.replace(jcfg, dropout_input=0.0,
                                        dropout_hidden=0.0)):
        jl, _ = jax.jit(lambda q, xx: JMX.forward(
            c, JPolicy("float32"), q, xx, {}, {}, rng=key))(jp, x)
        tl, _ = TMX.forward(_tcfg(c), TPolicy("float32"), p,
                            torch.from_numpy(x), {}, {},
                            rng=torch.from_numpy(np.asarray(key).astype(
                                np.int64)))
        # atol 1e-5 against logits of size ~5: f32 products summed in
        # another order, over inputs the masks scale by 1.25 and 2
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5)


def test_maxout_params_from_jax_checks_shapes():
    cfg = TMX.MaxoutConfig(**PI)
    bad = {"fc0": {"w": np.zeros((784, 3)), "b": np.zeros(96)}}
    with pytest.raises(ValueError, match="does not match"):
        maxout_params_from_jax(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _policies():
    return {
        "float32": dict(arithmetic="float32"),
        "float16": dict(arithmetic="float16"),
        "fixed20": dict(arithmetic="fixed", comp_width=20, update_width=20),
        "fixed20-packed": dict(arithmetic="fixed", comp_width=20,
                               update_width=20, storage="packed"),
        "dfxp": dict(arithmetic="dfxp"),
        "dfxp-fused": dict(arithmetic="dfxp", fused_matmul=True),
        "dfxp-packed": dict(arithmetic="dfxp", storage="packed"),
        "dfxp-packed-fused": dict(arithmetic="dfxp", storage="packed",
                                  fused_matmul=True),
    }


def _assert_grid_close(got, want, exps, prefix, what):
    """Parameters or momentum of the two packages, leaf by leaf.

    DFXP/fixed storage: ≥ 99.9% of the elements equal; the rest differ by
    a rounding tie flipped by an ulp of a product somewhere upstream, so
    by at most one step of each grid that feeds the value — the momentum
    by one ``pm:`` plus one ``pg:`` step, a parameter by one ``p:`` step
    plus ``lr`` times those two.  float16: activations, cotangents and
    parameters are all rounded to an 11-bit mantissa, whose ties an ulp
    flips ~30x more often than those of a 10-bit DFXP grid at the same
    magnitudes (a few percent of parameters differ after two steps); every
    element within one fp16 ulp of the leaf's largest value, and ≥ 90% of
    the parameters equal.  float32: nothing is rounded onto a grid; the
    gradients' f32 sums differ by their order: 1e-5 of the leaf's largest
    value."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    lr = OPT["lr"]
    n = same = 0
    for k in w:
        a, b = g[k], w[k]
        assert a.shape == b.shape, k
        eq = a == b
        n, same = n + a.size, same + int(eq.sum())
        top = float(np.abs(b).max()) + 1e-30
        if exps is not None:
            step = {q: 2.0 ** float(exps[f"{q}:{k}"]) for q in ("p", "pg", "pm")}
            feed = step["pm"] + step["pg"]
            tol = feed if prefix == "pm:" else step["p"] + lr * feed
        elif what == "float16":
            tol = 2.0 ** -10 * top
        else:
            tol = 1e-5 * top
        assert np.all(np.abs(a - b)[~eq] <= tol * (1 + 1e-6)), k
    if what == "float16" and prefix == "p:":
        assert same >= 0.9 * n, f"{same}/{n} equal"
    elif what not in ("float32", "float16"):
        assert same >= 0.999 * n, f"{same}/{n} equal"


def _loss_rtol(kw):
    """float32: 1e-5.  Rounded arithmetic: 1e-4 — one activation on a
    rounding tie of the 10-bit grid, flipped by an ulp of the first
    layer's f32 product, moves a batch's loss by ~3e-5."""
    return 1e-5 if kw["arithmetic"] == "float32" else 1e-4


def _setup(kw, seed=7, calib_steps=3, **pol):
    """Reference and port maxout (``PI``) from the same reference weights,
    their train steps, and initial exponents: calibrated by the reference
    for DFXP, -8.0 otherwise (as ``benchmarks/_common.train_once``)."""
    jpol, tpol = JPolicy(**kw, **pol), TPolicy(**kw, **pol)
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = _tcfg(jcfg)
    gs = JMX.group_shapes(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    init = -8.0
    if jpol.dynamic:
        jobs = dataclasses.replace(jpol, arithmetic="observe", storage="sim")
        data = tdata.SyntheticImages()
        init = _exps_np(j_calibrate(
            lambda p, b, s, e: JMX.loss_fn(jcfg, jobs, p, b, e, s), jp, gs,
            jpol, jopt.OptConfig(**OPT),
            (_jbatch(data.batch(100 + i, 32)) for i in range(calib_steps)),
            steps=calib_steps))
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=init)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=init)
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JMX.loss_fn(jcfg, jpol, p, b, e, s), gs, jpol,
        jopt.OptConfig(**OPT)))
    tstep = t_make_step(lambda p, b, s, e: TMX.loss_fn(tcfg, tpol, p, b, e, s),
                        gs, tpol, topt.OptConfig(**OPT))
    return jpol, jstate, tstate, jstep, tstep


def _assert_states_match(jstate, tstate, kw, exps_before):
    """``exps_before``: the exponents the step rounded with."""
    for d in ("exps", "acc"):
        jd, td = getattr(jstate.scale, d), getattr(tstate.scale, d)
        assert set(jd) == set(td)
        for k in jd:
            np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy(),
                                          err_msg=k)
    quantized = kw["arithmetic"] in ("fixed", "dfxp")
    exps = exps_before if quantized else None
    _assert_grid_close(_np(tstate.params), _np(jstate.params), exps, "p:",
                       kw["arithmetic"])
    _assert_grid_close(_np(tstate.opt["momentum"]),
                       _np(jstate.opt["momentum"]), exps, "pm:",
                       kw["arithmetic"])
    assert int(tstate.step) == int(jstate.step)


@pytest.mark.parametrize("name", list(_policies()))
def test_train_step_matches_reference(name):
    kw = _policies()[name]
    jpol, jstate, tstate, jstep, tstep = _setup(kw, update_interval=2)
    init = _exps_np(jstate.scale.exps)
    data = tdata.SyntheticImages()
    for i in range(2):           # step 1 accumulates, step 2 applies
        b = data.batch(i, 32)
        before = _exps_np(jstate.scale.exps)
        jstate, jm = jstep(jstate, _jbatch(b), jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, _tbatch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=_loss_rtol(kw))
        _assert_states_match(jstate, tstate, kw, before)
    if jpol.dynamic:       # the controller moved some exponent
        assert any(float(tstate.scale.exps[k]) != float(v)
                   for k, v in init.items())


def test_train_step_raises_on_what_is_not_ported():
    """``grad_transform`` and ``ef_transform`` (ROADMAP item 22, ported):
    a step halving the gradients and compressing them with error
    feedback (8-bit :func:`compress_tree`, the ``ef`` state in and out)
    against the reference's jitted one — the loss, the residuals, the
    controller's windows and the stored parameters."""
    from repro.dist.compress import compress_tree as j_compress_tree
    from repro.dist.compress import ef_init as j_ef_init
    from repro_torch.dist.compress import compress_tree, ef_init
    jpol, tpol = JPolicy("dfxp"), TPolicy("dfxp")
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = _tcfg(jcfg)
    gs = JMX.group_shapes(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(9))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=-7.0)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=-7.0)
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JMX.loss_fn(jcfg, jpol, p, b, e, s), gs, jpol,
        jopt.OptConfig(**OPT), grad_transform=lambda g: jax.tree.map(
            lambda x: x * 0.5, g),
        ef_transform=lambda g, ef: j_compress_tree(g, ef, 8)))
    tstep = t_make_step(
        lambda p, b, s, e: TMX.loss_fn(tcfg, tpol, p, b, e, s), gs, tpol,
        topt.OptConfig(**OPT), grad_transform=lambda g: topt.tree_map(
            lambda x: x * 0.5, g),
        ef_transform=lambda g, ef: compress_tree(g, ef, 8))
    jef, tef = j_ef_init(jstate.params), ef_init(tstate.params)
    for i in range(2):
        b = tdata.SyntheticImages().batch(i, 32)
        jstate, jm, jef = jstep(jstate, _jbatch(b), jax.random.PRNGKey(0),
                                jef)
        tstate, tm, tef = tstep(tstate, _tbatch(b), None, tef)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for k, v in _flat(_np(jef)).items():
        np.testing.assert_array_equal(_flat(_np(tef))[k], v, err_msg=k)
    for k in jstate.scale.acc:
        np.testing.assert_array_equal(np.asarray(jstate.scale.acc[k]),
                                      tstate.scale.acc[k].numpy(), err_msg=k)
    _assert_grid_close(_np(tstate.params), _np(jstate.params),
                       _exps_np(tstate.scale.exps), "p:", "dfxp")
    pol, cfg = TPolicy("dfxp"), topt.OptConfig()
    # the supervised step is ported (tests/test_torch_resilience.py)
    assert callable(t_make_step(lambda *a: None, {}, pol, cfg,
                                supervise=True, runaway_ovf=1e-3))
    # stochastic rounding is ported (the PRNG): the policy builds as the
    # reference's does, and its step rounds from the step's key
    spol = TPolicy("dfxp", stochastic_rounding=True)
    assert dataclasses.asdict(spol) == {
        k: v for k, v in dataclasses.asdict(
            JPolicy("dfxp", stochastic_rounding=True)).items()
        if k in dataclasses.asdict(spol)}
    step = t_make_step(lambda *a: None, {}, spol, cfg)
    with pytest.raises(ValueError, match="key"):
        step(None, {})


def test_microbatched_step_matches_reference():
    jpol, tpol = JPolicy("dfxp"), TPolicy("dfxp")
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = _tcfg(jcfg)
    gs = JMX.group_shapes(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(9))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=-7.0)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=-7.0)
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JMX.loss_fn(jcfg, jpol, p, b, e, s), gs, jpol,
        jopt.OptConfig(**OPT), microbatches=4))
    tstep = t_make_step(lambda p, b, s, e: TMX.loss_fn(tcfg, tpol, p, b, e, s),
                        gs, tpol, topt.OptConfig(**OPT), microbatches=4)
    b = tdata.SyntheticImages().batch(0, 32)
    jstate, jm = jstep(jstate, _jbatch(b), jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, _tbatch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for k in jstate.scale.acc:
        np.testing.assert_array_equal(np.asarray(jstate.scale.acc[k]),
                                      tstate.scale.acc[k].numpy(), err_msg=k)
    _assert_grid_close(_np(tstate.params), _np(jstate.params),
                       _exps_np(tstate.scale.exps), "p:", "dfxp")


def test_calibrate_init_exponents_exact():
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = _tcfg(jcfg)
    gs = JMX.group_shapes(jcfg)
    jpol = JPolicy("dfxp", update_interval=10)
    tpol = TPolicy("dfxp", update_interval=10)
    jobs = dataclasses.replace(jpol, arithmetic="observe")
    tobs = dataclasses.replace(tpol, arithmetic="observe")
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(0))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    data = tdata.SyntheticImages()
    bs = [data.batch(i, 32) for i in range(4)]
    je = j_calibrate(lambda p, b, s, e: JMX.loss_fn(jcfg, jobs, p, b, e, s),
                     jp, gs, jpol, jopt.OptConfig(**OPT),
                     (_jbatch(b) for b in bs), steps=4)
    te = t_calibrate(lambda p, b, s, e: TMX.loss_fn(tcfg, tobs, p, b, e, s),
                     tp, gs, tpol, topt.OptConfig(**OPT),
                     (_tbatch(b) for b in bs), steps=4)
    assert set(je) == set(te)
    for k in je:
        np.testing.assert_array_equal(np.asarray(je[k]), te[k].numpy(),
                                      err_msg=k)
    assert len({float(v) for v in te.values()}) > 3
