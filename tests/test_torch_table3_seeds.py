"""The Table-3 recipe over other init and dropout seeds: the port
(``repro_torch.examples.quickstart.train``) against the reference
(``repro``'s train step on ``tools/reference_table3.py``'s recipe).

As a test (the CPU, small width): a few steps from the weights of
``PRNGKey(8)`` with dropout keyed by ``PRNGKey(2)`` give the reference's
losses, at ``test_torch_train.py``'s tolerances, so the port's seed
arguments draw the reference's weights and masks.

As a script, the spread of a row's eval accuracy over seed pairs at the
paper's full PI width, the reference's and the port's, on the CPU::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_table3_seeds.py \
        --row "fixed 20/20" --pairs 8

``chip_smoke.py`` runs the port's side on the card over the same pairs
(:data:`SEED_PAIRS`, from ``repro_torch.examples.quickstart``).
"""
import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import PrecisionPolicy as JPolicy
from repro.data import SyntheticImages as JData
from repro.models import maxout as JMX
from repro.optim.opt import OptConfig as JOpt, sgd_init as j_sgd_init
from repro.train import init_train_state as j_init_state, \
    make_train_step as j_make_step
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.examples import quickstart as qs
from repro_torch.models import maxout as TMX

ROWS = {
    "float32": dict(arithmetic="float32"),
    "fixed 20/20": dict(arithmetic="fixed", comp_width=20, update_width=20),
}


def reference_run(cfg_kw: dict, pol_kw: dict, seed: int, dropout_seed: int,
                  steps: int, eval_n: int = 1024):
    """The reference's training losses and eval accuracy on the recipe
    (SGD lr 0.1, max-norm 1.9365, batch 64), exponents -8."""
    cfg = JMX.MaxoutConfig(**cfg_kw)
    pol = JPolicy(**pol_kw)
    o = qs.OPT
    opt = JOpt(kind=o.kind, lr=o.lr, lr_decay_steps=o.lr_decay_steps,
               max_col_norm=o.max_col_norm)
    data, gs = JData(), JMX.group_shapes(cfg)
    rng = jax.random.PRNGKey(dropout_seed)

    def batch(b):
        return {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])}

    params = JMX.init_params(cfg, jax.random.PRNGKey(seed))
    state = j_init_state(params, j_sgd_init(params), gs, pol, init_exp=-8.0)
    step = jax.jit(j_make_step(
        lambda p, b, s, e: JMX.loss_fn(cfg, pol, p, b, e, s, rng=rng),
        gs, pol, opt))
    losses = []
    for i in range(steps):
        state, m = step(state, batch(data.batch(i, qs.BATCH)),
                        jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    ev = batch(data.eval_set(eval_n))
    acc = JMX.accuracy(cfg, pol, state.params, ev, state.scale.exps, {})
    return losses, float(acc)


def port_run(cfg_kw: dict, pol_kw: dict, seed: int, dropout_seed: int,
             steps: int, device: str = "cpu", eval_n: int = 1024):
    r = qs.train(TMX.MaxoutConfig(**cfg_kw), TPolicy(**pol_kw), device,
                 steps=steps, seed=seed, dropout_seed=dropout_seed,
                 eval_n=eval_n)
    return r["losses"], r["acc"]


@pytest.mark.parametrize("row", list(ROWS))
def test_other_seeds_match_reference(row):
    kw = dict(hidden=(48, 48), pieces=3)
    jl, _ = reference_run(kw, ROWS[row], 8, 2, steps=3, eval_n=64)
    tl, _ = port_run(kw, ROWS[row], 8, 2, steps=3, eval_n=64)
    rtol = 1e-5 if row == "float32" else 1e-4
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    # and they are not the recipe's own seeds' losses
    tl0, _ = port_run(kw, ROWS[row], 7, 1, steps=1, eval_n=64)
    assert tl0[0] != tl[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--row", default="fixed 20/20", choices=list(ROWS))
    ap.add_argument("--pairs", type=int, default=len(qs.SEED_PAIRS))
    ap.add_argument("--steps", type=int, default=qs.STEPS)
    args = ap.parse_args(argv)
    pol = ROWS[args.row]
    print(f"{args.row}, MaxoutConfig(), {args.steps} steps, eval on 1024")
    print(f"{'init':>4s} {'drop':>4s} {'ref acc':>8s} {'port acc':>8s} "
          f"{'ref last10':>10s} {'port last10':>11s} {'s':>5s}")
    accs = {"ref": [], "port": []}
    for seed, dseed in qs.SEED_PAIRS[:args.pairs]:
        t0 = time.perf_counter()
        jl, ja = reference_run({}, pol, seed, dseed, args.steps)
        tl, ta = port_run({}, pol, seed, dseed, args.steps)
        accs["ref"].append(ja)
        accs["port"].append(ta)
        print(f"{seed:4d} {dseed:4d} {ja:8.4f} {ta:8.4f} "
              f"{np.mean(jl[-10:]):10.5f} {np.mean(tl[-10:]):11.5f} "
              f"{time.perf_counter() - t0:5.0f}", flush=True)
    for k, v in accs.items():
        v = np.array(v)
        print(f"{k}: mean {v.mean():.4f} min {v.min():.4f} max {v.max():.4f} "
              f"below 0.99: {int((v < 0.99).sum())} of {v.size}")


if __name__ == "__main__":
    sys.exit(main())
