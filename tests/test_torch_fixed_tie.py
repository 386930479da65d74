"""Why ``test_torch_stochastic.py``'s ``fixed20_stochastic`` case fails
in a few processes: an f32 summation order landing on a rounding tie.

The case keys each leaf's stochastic storage rounding on
``hash(name) % 2**31``, as the reference does, and Python salts
``hash`` per process.  Under ``PYTHONHASHSEED=22`` (and 41) the case
sees 99.87-99.89% of the parameters and momentum equal after two steps,
against the 99.9% it holds.  This test replays the seed-22 keys in any
process (the names' seed-22 hashes, read from a child interpreter, stand
in for ``hash`` in both packages' step modules) and isolates the cause:

* step 0 (the stochastic storage rounding under these keys) leaves both
  packages' parameters and momentum equal, bit for bit;
* at the step-1 parameters, fc0's pre-activation (the fixed 2^-8 grid
  of fixed 20/20) differs between the reference's XLA dot and torch's
  matmul only by summation-order ulps (within 16 ulps of its largest
  value), and one of its values sits within those ulps of a half grid
  step: the two round it to neighbouring grid points;
* that one flipped activation moves a whole row of fc0's gradients by a
  fraction of a grid step, and the step-1 momentum differs in those
  leaves only, each differing element by exactly one grid step.

Neither package is at fault: the 784-term dot products are summed in
another order by XLA's CPU dot and by torch's; a DFXP or fixed-point
run leaves any other implementation of itself at its first flipped tie
(ROADMAP §3, "Found against the reference").
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import tape as jtape_mod
from repro.data import synthetic as jdata
from repro.models import maxout as JMX
from repro.train import step as jstep_mod
from repro_torch.core import prng
from repro_torch.core import tape as ttape_mod
from repro_torch.models import maxout as TMX
from repro_torch.train import step as tstep_mod
from test_torch_stochastic import PI, STOCHASTIC, _stochastic_setup
from test_torch_train import _jbatch, _np, _tbatch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _hashes(names, seed: int) -> dict:
    """``hash(name)`` of each name in an interpreter with
    ``PYTHONHASHSEED=seed``."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; print(*[hash(n) for n in sys.argv[1:]])", *names],
        env={**os.environ, "PYTHONHASHSEED": str(seed)}, check=True,
        capture_output=True, text=True).stdout.split()
    return dict(zip(names, map(int, out)))


def _pre_activations(monkeypatch, state_j, state_t, x):
    """fc0's pre-activation (before its rounding) of both packages'
    training forward (dropout keyed ``PRNGKey(1)``, as in the case; the
    reference's compiled, whose dropout scales by the reciprocal)."""
    seen = {}
    j_act, t_act = jtape_mod.QTape.act, ttape_mod.QTape.act

    def j_rec(self, name, v):
        seen.setdefault(("j", name), v)
        return j_act(self, name, v)

    def t_rec(self, name, v):
        seen.setdefault(("t", name), v.detach().numpy().copy())
        return t_act(self, name, v)

    monkeypatch.setattr(jtape_mod.QTape, "act", j_rec)
    monkeypatch.setattr(ttape_mod.QTape, "act", t_rec)
    from repro.core.policy import PrecisionPolicy as JPolicy
    from repro_torch.core.policy import PrecisionPolicy as TPolicy
    kw = STOCHASTIC["fixed20_stochastic"]
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = TMX.MaxoutConfig(**PI)

    def j_pre(params, xx, exps):     # compiled, as the step's forward is
        JMX.forward(jcfg, JPolicy(**kw), params, xx, exps, {},
                    rng=jax.random.PRNGKey(1))
        return seen.pop(("j", "fc0/pre"))

    zj = np.asarray(jax.jit(j_pre)(state_j.params, jax.numpy.asarray(x),
                                   state_j.scale.exps))
    TMX.forward(tcfg, TPolicy(**kw), state_t.params, torch.from_numpy(x),
                state_t.scale.exps, {}, rng=prng.PRNGKey(1))
    monkeypatch.undo()
    return zj, seen[("t", "fc0/pre")]


def test_fixed20_stochastic_tie_flip_at_seed_22(monkeypatch):
    kw = STOCHASTIC["fixed20_stochastic"]
    names = list(_flat(JMX.init_params(JMX.MaxoutConfig(**PI),
                                       jax.random.PRNGKey(7))))
    table = _hashes(names, 22)
    for mod in (jstep_mod, tstep_mod):
        monkeypatch.setattr(mod, "hash", table.__getitem__, raising=False)
    jstate, tstate, jstep, tstep = _stochastic_setup(kw)
    data = jdata.SyntheticImages()
    b = data.batch(0, 32)
    jstate, _ = jstep(jstate, _jbatch(b), jax.random.PRNGKey(0))
    tstate, _ = tstep(tstate, _tbatch(b), prng.PRNGKey(0))
    # step 0: the storage rounding under the seed-22 keys agrees exactly
    for part in ("params", "opt"):
        want = _flat(_np(getattr(jstate, part)))
        got = _flat(_np(getattr(tstate, part)))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the step-1 forward: one pre-activation on a tie of the 2^-8 grid
    x = data.batch(1, 32)["x"]
    zj, zt = _pre_activations(monkeypatch, jstate, tstate, x)
    e = float(np.asarray(jstate.scale.exps["a:fc0/pre"]))
    step = 2.0 ** e
    # summation order only: within 16 ulps of the largest value (7.6e-6
    # here, against a grid step of 3.9e-3)
    tol = 16 * float(np.spacing(np.abs(zj).max()))
    assert np.all(np.abs(zt - zj) <= tol)
    flipped = np.flatnonzero(np.round(zj / step) != np.round(zt / step))
    assert flipped.size == 1
    i = flipped[0]
    half = np.floor(zj.flat[i] / step) + 0.5
    assert abs(zj.flat[i] / step - half) <= tol / step
    assert abs(zt.flat[i] / step - half) <= tol / step

    # step 1: the momentum leaves that differ, differ by one grid step each
    for mod in (jstep_mod, tstep_mod):
        monkeypatch.setattr(mod, "hash", table.__getitem__, raising=False)
    b = data.batch(1, 32)
    jstate, _ = jstep(jstate, _jbatch(b), jax.random.PRNGKey(1))
    tstate, _ = tstep(tstate, _tbatch(b), prng.PRNGKey(1))
    want = _flat(_np(jstate.opt["momentum"]))
    got = _flat(_np(tstate.opt["momentum"]))
    n = same = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        n, same = n + d.size, same + int((d == 0).sum())
        e = float(np.asarray(jstate.scale.exps[f"pm:{k}"]))
        assert np.all((d == 0) | (d == 2.0 ** e)), k
    assert same < 0.999 * n           # what the 99.9% band sees at seed 22
    assert same >= 0.998 * n
