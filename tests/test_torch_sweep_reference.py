"""The precision sweep's DFXP exponents against the reference's.

A DFXP row's exponents follow its widths: calibration and the §5
controller keep each group's largest values near the top of a
``width``-bit range, so a row that ran at another width ends with other
exponents.  ``chip_smoke.py`` holds the card's final exponents of every
DFXP row of Figures 2-4 (``repro_torch.examples.precision_sweep``) to the
reference's (``benchmarks/_common.py``'s harness on the CPU).

As a test (the CPU): after 10 steps (one controller update) two DFXP
rows' exponents equal the reference's, group by group.

As a script, the reference's final exponents of every DFXP row at the
harness's 120 steps, beside the port's on the CPU::

    PYTHONPATH=src:. JAX_PLATFORMS=cpu \
        python tests/test_torch_sweep_reference.py

It prints, per row, the groups whose exponents differ and by how much,
and last a JSON line of the reference's exponents by row.
"""
import json
import sys

import jax
import jax.numpy as jnp
import pytest

from benchmarks import _common as bench
from repro.core import PrecisionPolicy as JPolicy
from repro.models import maxout as JMX
from repro.optim.opt import sgd_init
from repro.train import init_train_state, make_train_step
from repro_torch.examples import precision_sweep as sweep


def _jpolicy(pol) -> JPolicy:
    return JPolicy(**{f: getattr(pol, f) for f in JPolicy.__dataclass_fields__
                      if hasattr(pol, f)})


def reference_exps(pol: JPolicy, steps: int = bench.STEPS) -> dict:
    """The reference harness's ``train_once`` run, returning the final
    exponents by group."""
    init = dict(bench.calibrated_exps_cached(pol))
    params = JMX.init_params(bench.CFG, jax.random.PRNGKey(7))
    state = init_train_state(params, sgd_init(params), bench.GS, pol,
                             init_exp=init)
    step = jax.jit(make_train_step(
        lambda p, b, s, e: JMX.loss_fn(bench.CFG, pol, p, b, e, s,
                                       rng=jax.random.PRNGKey(1)),
        bench.GS, pol, bench.OPT))
    for i, b in enumerate(bench._batches(steps)):
        state, _ = step(state, b, jax.random.PRNGKey(i))
    return {k: float(jnp.ravel(v)[0]) for k, v in state.scale.exps.items()}


def dfxp_rows():
    return [(n, p) for n, p in sweep.fig_rows() if p.dynamic]


@pytest.mark.parametrize("name", ["fig2/dfxp_comp_8", "fig3/dfxp_update_10"])
def test_sweep_exponents_match_reference(name):
    pol = dict(sweep.fig_rows())[name]
    got = sweep.train_row(sweep.CFG, pol, "cpu", steps=10)["exps"]
    want = reference_exps(_jpolicy(pol), steps=10)
    assert got == want


def main() -> int:
    ref = {}
    for name, pol in dfxp_rows():
        want = reference_exps(_jpolicy(pol))
        got = sweep.train_row(sweep.CFG, pol, "cpu")["exps"]
        diff = {k: got[k] - want[k] for k in want if got[k] != want[k]}
        print(f"{name:28s} {len(want)} groups, differ: {diff}", flush=True)
        ref[name] = want
    print(json.dumps(ref, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
