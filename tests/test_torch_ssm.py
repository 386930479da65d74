"""The port's Mamba2 block (``repro_torch.models.ssm``) against the
reference's, on the CPU, at the mamba2-smoke spec (chunk 16, 8 heads of
32, state 16).

* ``init_ssm`` from one key equals the reference's bit for bit, its
  ``dt_bias`` (``log(expm1(exp(u)))``) and ``A_log`` through XLA's CPU
  ``exp``/``expm1``/``log`` evaluations; those (and ``tanh``, which
  ``expm1`` takes) equal ``jax.numpy``'s bit for bit on 2**16 inputs
  each, where their results are normal floats.
* ``ssm_forward`` at S a multiple of the chunk and ragged (padded, the
  pad's ``dt`` masked): output within 1e-5 (f32: the causal convolution
  as shifted multiply-adds against ``lax.conv``, the chunk products in
  ``einsum``s, and ``exp``/``log1p`` of the softplus, all in another
  order or another library: ulps), the returned conv window (the
  in-projection's output) and the final state within 1e-5; the sites' statistics exactly equal
  under float32 and DFXP 10/12, the state's among them (rounded at the
  update width at every chunk boundary, its statistics taken over the
  stacked carries); the gradients within 1e-5 of each leaf's largest
  (a whole sequence under float32, a ragged one under DFXP).
* ``ssm_decode`` continuing from the prefix's ``return_cache`` gives the
  forward over the longer sequence, in the port, and the reference's
  decode steps, within 1e-5 (outputs, conv window and state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.tape import QTape as JTape
from repro.models import ssm as JS
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.core.tape import QTape as TTape
from repro_torch.models import ssm as TS

JSPEC = jconfigs.get_smoke("mamba2_370m").ssm_spec
TSPEC = tconfigs.get_smoke("mamba2_370m").ssm_spec
PFX = "s"
SITES = ("x", "y", "out", "state")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small tensors: the suite runs
    several test processes at once, and torch's thread pools in each of
    them would otherwise wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


def _params():
    jp = JS.init_ssm(jax.random.PRNGKey(6), JSPEC)
    return jax.tree_util.tree_map(np.asarray, jp)


def _exps(mod):
    names = [f"a:{PFX}/{s}" for s in SITES] + [f"w:{PFX}/in_proj",
                                               f"w:{PFX}/out_proj"]
    if mod == "jax":
        return {n: jnp.float32(-6.0) for n in names}
    return {n: torch.tensor(-6.0) for n in names}


def _u(S, B=2, seed=8):
    return np.random.default_rng(seed).standard_normal(
        (B, S, JSPEC.d_model)).astype(np.float32)


WEIGHT = np.random.default_rng(9).standard_normal(1 << 14).astype(np.float32)


def _reference(params, u, arith, return_cache=False):
    pol = JPolicy(arith)
    sinks = {f"g:{PFX}/{s}": jnp.zeros((3,)) for s in SITES}

    def f(p, uu):
        tape = JTape(pol, _exps("jax"), sinks)
        y, cache = JS.ssm_forward(p, JSPEC, uu, tape, PFX,
                                  return_cache=return_cache)
        w = jnp.asarray(WEIGHT[:y.size].reshape(y.shape))
        return jnp.sum(y * w), (y, cache, tape.stats)

    (_, (y, cache, stats)), grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(u))
    return y, cache, stats, grads


def _port(params, u, arith, return_cache=False):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in params.items()}
    uu = torch.from_numpy(np.array(u)).requires_grad_(True)
    tape = TTape(TPolicy(arith), _exps("torch"), {})
    y, cache = TS.ssm_forward(p, TSPEC, uu, tape, PFX,
                              return_cache=return_cache)
    w = torch.from_numpy(WEIGHT[:y.numel()].reshape(y.shape))
    gu, *gp = torch.autograd.grad((y * w).sum(), [uu, *p.values()])
    return y.detach(), cache, tape.stats, dict(zip(p, gp)), gu


def test_init_ssm_matches_reference():
    want = _flat(JS.init_ssm(jax.random.PRNGKey(6), JSPEC))
    got = _flat(TS.init_ssm(prng.PRNGKey(6), TSPEC))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fn,lo,hi", [("exp", -87.3, 88.3),
                                      ("expm1", -2.0, 2.0),
                                      ("tanh", -4.0, 4.0),
                                      ("log", 1e-30, 1e30)])
def test_xla_elementwise_evaluations(fn, lo, hi):
    if fn == "log":
        x = np.exp(np.random.default_rng(1).uniform(
            np.log(lo), np.log(hi), 1 << 16)).astype(np.float32)
    else:
        x = np.random.default_rng(1).uniform(lo, hi, 1 << 16).astype(
            np.float32)
    want = np.asarray(getattr(jnp, fn)(jnp.asarray(x)))
    got = getattr(prng, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H", [8, 32, 64])
def test_a_log_matches_reference(H):
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, H, dtype=jnp.float32)))
    got = prng.log(TS._linspace(1.0, 16.0, H, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S,arith", [(32, "float32"), (27, "dfxp")],
                         ids=["whole-float32", "ragged-dfxp"])
def test_ssm_forward_matches_reference(S, arith):
    params = _params()
    jy, jc, jst, (jgp, jgu) = _reference(params, _u(S), arith,
                                         return_cache=True)
    ty, tc, tst, tgp, tgu = _port(params, _u(S), arith, return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(tc["conv"].detach().numpy(),
                               np.asarray(jc["conv"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(tc["state"].detach().numpy(),
                               np.asarray(jc["state"]), rtol=0, atol=TOL)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    top = float(np.abs(np.asarray(jgu)).max())
    np.testing.assert_allclose(tgu.numpy(), np.asarray(jgu), rtol=0,
                               atol=TOL * top)
    for k, g in tgp.items():
        want = np.asarray(jgp[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=k)


def test_ssm_decode_continues_the_forward():
    """Prefix of 21 (ragged), then 5 decode steps: the port's outputs
    equal its forward over all 26 positions, and the reference's decode
    outputs, within 1e-5; the final states likewise."""
    params = _params()
    u = _u(26)
    pol = TPolicy("float32")
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tu = torch.from_numpy(u)
    full, full_cache = TS.ssm_forward(tp, TSPEC, tu, TTape(pol, {}), PFX,
                                      return_cache=True)
    _, cache = TS.ssm_forward(tp, TSPEC, tu[:, :21], TTape(pol, {}), PFX,
                              return_cache=True)
    jpol = JPolicy("float32")
    _, jcache = JS.ssm_forward(params, JSPEC, jnp.asarray(u[:, :21]),
                               JTape(jpol, {}, {}), PFX, return_cache=True)
    for t in range(21, 26):
        y, cache = TS.ssm_decode(tp, TSPEC, tu[:, t:t + 1], cache,
                                 TTape(pol, {}), PFX)
        jy, jcache = JS.ssm_decode(params, JSPEC, jnp.asarray(u[:, t:t + 1]),
                                   jcache, JTape(jpol, {}, {}), PFX)
        np.testing.assert_allclose(y.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(cache["state"].numpy(),
                               full_cache["state"].numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(cache["conv"].numpy(),
                               full_cache["conv"].numpy(), rtol=0, atol=TOL)
