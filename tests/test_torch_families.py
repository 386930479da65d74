"""The eight token-in decoder families of the port against the reference,
on the CPU, at their smoke configs: llama3, qwen3 (qk-norm), phi3,
gemma3 (windows of 16 in a 2:1 local:global pattern, a ``dec_tail``
stage, per-block RoPE theta, qk-norm, embed scale), granite (MoE every
layer), llama4 (MoE every 2nd layer, top-1, shared expert), mamba2 (SSM)
and zamba2 (hybrid: shared attention and FFN, a ``dec_tail`` stage).

* ``init_params`` from one key equals the reference's bit for bit (the
  ``"shared"`` subtrees included); ``group_shapes`` (names and shapes:
  ``()`` for a shared block) and the parameter groups equal the
  reference's; ``params_from_jax`` takes the reference's trees.
* One SGD train step under ``float32`` (here, every arch) and DFXP
  10/12 (``test_torch_families_train.py``, the same case; controller
  interval 1, so the step both records and applies), from the same
  weights, data and initial exponents: the loss within 1e-5 relative
  (float32) and 2e-4 (DFXP: a rounding tie that an ulp of an f32 product
  flips moves a 10-bit activation by a grid step, and the shift spreads
  through the residual stream; ``rmsnorm``'s mean and ``rsqrt`` differ
  from XLA's by ulps, and qk-norm puts one before every RoPE); the
  exponents exactly equal; the ``acc`` windows exactly equal under
  float32 and within 1e-3 of each group's element count under DFXP;
  parameters and momentum as ``test_torch_train.py`` holds them
  (float32 within 1e-5 of each leaf's largest value; DFXP ≥ 99.9% of
  the elements equal, the rest within the grid steps that feed them).
  The shared groups' statistics are summed over their repetitions, and
  their exponents — what calibration and the controller compute from
  those sums — come out equal.
* Whole-prompt ``prefill`` then 4 teacher-forced ``decode_step`` calls
  under ``float32``: logits within 1e-4 (gemma3's prompt of 40 is past
  its window of 16, so the local rings have wrapped).
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
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train.state import param_group_shapes as j_param_groups
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from repro_torch.train.state import param_group_shapes as t_param_groups

ARCHS = tuple(a for a in tconfigs.ARCHS     # the token-in decoders
              if a not in ("seamless_m4t_medium", "qwen2_vl_72b"))
B, S = 2, 32
OPT = dict(kind="sgd", lr=0.01, lr_decay_steps=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_groups_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = _flat(JT.init_params(jcfg, jax.random.PRNGKey(5)))
    tp = _flat(TT.init_params(tcfg, 5, device="cpu"))
    tk = _flat(TT.init_params(tcfg, prng.PRNGKey(5), device="cpu"))
    assert set(jp) == set(tp) == set(tk)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        np.testing.assert_array_equal(tk[k], jp[k], err_msg=k)
    shared = [k for k in jp if k.split("/")[2:3] == ["shared"]]
    assert bool(shared) == (jcfg.family == "hybrid")
    assert TT.group_shapes(tcfg) == JT.group_shapes(jcfg)
    jpar, tpar = _params(arch)
    assert t_param_groups(tpar) == j_param_groups(jpar)


def _tree_np(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(tree).items()}


def _assert_grid_close(got, want, exps, prefix, quantized, top1=False):
    """As ``test_torch_train.py``'s: DFXP leaves ≥ 99.9% equal, the rest
    within the grid steps that feed them; float32 within 1e-5 of each
    leaf's largest value (a top-1 router's gradient is zero but for f32
    noise, its gates renormalised to 1: its leaves are held to 1e-5 of
    the largest value of any leaf)."""
    n = same = 0
    top_all = max(float(np.abs(b).max()) for b in want.values())
    for k, b in want.items():
        a = got[k]
        eq = a == b
        n, same = n + a.size, same + int(eq.sum())
        if quantized:
            step = {q: 2.0 ** float(np.max(exps[f"{q}:{k}"]))
                    for q in ("p", "pg", "pm")}
            feed = step["pm"] + step["pg"]
            tol = feed if prefix == "pm:" else step["p"] + OPT["lr"] * feed
        elif top1 and k.endswith("/router"):
            tol = 1e-5 * top_all
        else:
            tol = 1e-5 * (float(np.abs(b).max()) + 1e-30)
        assert np.all(np.abs(a - b)[~eq] <= tol * (1 + 1e-6)), k
    if quantized:
        assert same >= 0.999 * n, f"{same}/{n} equal"


def train_step_case(arch, arith):
    """One train step of both packages from the same state; see the
    module docstring for what is held and how closely."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    gs = JT.group_shapes(jcfg)
    kw = dict(arithmetic=arith, comp_width=10, update_width=12,
              update_interval=1)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=-6.0)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=-6.0)
    before = {k: np.asarray(v) for k, v in jstate.scale.exps.items()}
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JT.loss_fn(jcfg, jpol, p, b, e, s), gs, jpol,
        jopt.OptConfig(**OPT)))
    tstep = t_make_step(lambda p, b, s, e: TT.loss_fn(tcfg, tpol, p, b, e, s),
                        gs, tpol, topt.OptConfig(**OPT))
    b = jdata.SyntheticLM(jcfg.vocab_size, S, B, seed=0).batch(0)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                       jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    quantized = arith == "dfxp"
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4 if quantized else 1e-5)
    for k, v in jstate.scale.exps.items():
        np.testing.assert_array_equal(tstate.scale.exps[k].numpy(),
                                      np.asarray(v), err_msg=k)
    for k, v in jstate.scale.acc.items():
        want, got = np.asarray(v), tstate.scale.acc[k].numpy()
        if quantized:
            np.testing.assert_array_equal(got[..., 2], want[..., 2], k)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-3 * float(want[..., 2].max()),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    if quantized:   # the controller moved some exponent
        assert any(not np.array_equal(np.asarray(v), before[k])
                   for k, v in jstate.scale.exps.items())
    top1 = jcfg.top_k == 1
    _assert_grid_close(_tree_np(tstate.params), _tree_np(jstate.params),
                       before, "p:", quantized, top1)
    _assert_grid_close(_tree_np(tstate.opt["momentum"]),
                       _tree_np(jstate.opt["momentum"]), before, "pm:",
                       quantized, top1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """float32 here; DFXP 10/12 in ``test_torch_families_train.py``."""
    train_step_case(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    gs = JT.group_shapes(jcfg)
    jex = {n: jnp.full(s, -6.0) for n, s in gs.items()}
    tex = {n: torch.full(s, -6.0) for n, s in gs.items()}
    jpol, tpol = JPolicy("float32"), TPolicy("float32")
    S0 = 40 if jcfg.window else 20
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, S0 + 4)).astype(np.int32)
    jl, _, jc = JT.prefill(jcfg, jpol, jp, {"tokens": jnp.asarray(
        toks[:, :S0])}, jex, {}, max_cache_len=S0 + 8)
    tl, _, tc = TT.prefill(tcfg, tpol, tp, {"tokens": torch.from_numpy(
        toks[:, :S0])}, tex, max_cache_len=S0 + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for s in range(4):
        pos = np.full(2, S0 + s, np.int32)
        jl, _, jc = JT.decode_step(jcfg, jpol, jp, jc, jnp.asarray(
            toks[:, S0 + s]), jnp.asarray(pos), jex, {})
        tl, _, tc = TT.decode_step(tcfg, tpol, tp, tc, torch.from_numpy(
            toks[:, S0 + s]), torch.from_numpy(pos), tex)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4, err_msg=f"decode {s}")
    if jcfg.window:   # the local rings hold the last `window` positions
        ring = tc["dec"]["0:attn"]["pos"]
        assert ring.shape[-1] == jcfg.window
        assert int(ring.min()) == S0 + 4 - jcfg.window


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "qwen2_vl_72b"])
def test_the_other_two_archs_raise(arch):
    """The encoder-decoder and the embeds-input model build (their own
    tests: ``test_torch_encdec.py``, ``test_torch_mrope.py``), but the
    engine serves token-in decoders only and refuses them with the
    reference's ``ValueError``, before it touches the weights."""
    from repro_torch.serve import ServeEngine as TEngine
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _, smoke = _cfgs(arch)
    with pytest.raises(ValueError, match="token-in decoder models"):
        TEngine(smoke, TPolicy("float32"), {}, max_slots=2, max_len=16,
                device="cpu")


@pytest.mark.parametrize("kind", ["gelu", "maxout"])
def test_gelu_and_maxout_ffns_match_reference(kind):
    """The FFN kinds no token-in config uses yet (seamless takes gelu):
    init bit for bit, output within 1e-5 under float32, the statistics
    equal under DFXP.  ``jax.nn.gelu`` is the tanh approximation
    (``F.gelu`` defaults to erf); the port's ``layers.gelu`` computes
    jax's formula."""
    from repro.core.tape import QTape as JTape
    from repro.models import layers as JL
    from repro_torch.core.tape import QTape as TTape
    from repro_torch.models import layers as TL
    d, f, k = 32, 48, 3
    if kind == "gelu":
        jp = JL.init_gelu_ffn(jax.random.PRNGKey(4), d, f)
        tp = TL.init_gelu_ffn(prng.PRNGKey(4), d, f)
        jfn, tfn = JL.gelu_ffn, TL.gelu_ffn
    else:
        jp = JL.init_maxout(jax.random.PRNGKey(4), d, f, k)
        tp = TL.init_maxout(prng.PRNGKey(4), d, f, k)
        jfn, tfn = JL.maxout, TL.maxout
    for name, v in jp.items():
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(v), name)
    x = np.random.default_rng(2).standard_normal((2, 5, d)).astype(
        np.float32) * 2
    for arith in ("float32", "dfxp"):
        jt = JTape(JPolicy(arith), {}, {})
        tt = TTape(TPolicy(arith), {})
        jy = jfn(jp, jnp.asarray(x), jt, "f")
        ty = tfn(tp, torch.from_numpy(x), tt, "f")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        assert set(tt.stats) == set(jt.stats)
        for n in jt.stats:
            np.testing.assert_array_equal(tt.stats[n].numpy(),
                                          np.asarray(jt.stats[n]), n)
