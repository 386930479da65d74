r"""The reference's Table-3 quickstart recipe at a chosen maxout width,
with dropout on or off — the JAX side of the port's
``python -m repro_torch.examples.quickstart``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_table3.py \
        --full --no-dropout

``examples/quickstart.py``'s recipe (SGD lr 0.1, max-norm 1.9365, batch
64, 150 steps, DFXP 10/12 calibrated for 8 steps with
``update_interval=10``) on ``MaxoutConfig()`` (``--full``: 784 → 240×5 →
240×5 → 10) or the quickstart's (64, 64) × 3 net.  Prints each row's
final loss, mean loss of the last 10 steps, eval loss and eval accuracy
on ``eval_set(1024)``.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import PrecisionPolicy
from repro.data import SyntheticImages
from repro.models import maxout as MX
from repro.optim.opt import OptConfig, sgd_init
from repro.train import init_train_state, make_train_step
from repro.train.calibrate import calibrate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's PI width, MaxoutConfig()")
    ap.add_argument("--no-dropout", action="store_true",
                    help="rng=None: the port's training path")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    cfg = (MX.MaxoutConfig() if args.full
           else MX.MaxoutConfig(hidden=(64, 64), pieces=3))
    opt = OptConfig(kind="sgd", lr=0.1, lr_decay_steps=2000,
                    max_col_norm=1.9365)
    data, gs = SyntheticImages(), MX.group_shapes(cfg)
    rng = None if args.no_dropout else jax.random.PRNGKey(1)

    def batch(b):
        return {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])}

    def run(policy, init_exp):
        params = MX.init_params(cfg, jax.random.PRNGKey(7))
        state = init_train_state(params, sgd_init(params), gs, policy,
                                 init_exp=init_exp)
        step = jax.jit(make_train_step(
            lambda p, b, s, e: MX.loss_fn(cfg, policy, p, b, e, s, rng=rng),
            gs, policy, opt))
        losses = []
        for i in range(args.steps):
            state, m = step(state, batch(data.batch(i, 64)),
                            jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
        ev = batch(data.eval_set(1024))
        acc = MX.accuracy(cfg, policy, state.params, ev, state.scale.exps, {})
        ev_loss = MX.loss_fn(cfg, policy, state.params, ev, state.scale.exps,
                             {})[0]
        return losses, float(acc), float(ev_loss)

    dfxp = PrecisionPolicy("dfxp", comp_width=10, update_width=12,
                           update_interval=10)
    obs = dataclasses.replace(dfxp, arithmetic="observe")
    init_exp = calibrate(
        lambda p, b, s, e: MX.loss_fn(cfg, obs, p, b, e, s, rng=rng),
        MX.init_params(cfg, jax.random.PRNGKey(0)), gs, dfxp, opt,
        (batch(data.batch(i, 64)) for i in range(10)), steps=8)
    rows = [("float32", PrecisionPolicy("float32"), -8.0),
            ("float16", PrecisionPolicy("float16"), -8.0),
            ("fixed 20/20", PrecisionPolicy("fixed", comp_width=20,
                                            update_width=20), -8.0),
            ("dfxp 10/12", dfxp, init_exp)]
    print(f"{cfg.hidden} x {cfg.pieces}, dropout "
          f"{'off' if rng is None else 'on'}, {args.steps} steps")
    print(f"{'format':12s} {'final':>9s} {'last10':>9s} {'eval loss':>9s} "
          f"{'eval acc':>8s}")
    for name, pol, ie in rows:
        losses, acc, ev_loss = run(pol, ie)
        print(f"{name:12s} {losses[-1]:9.5f} {np.mean(losses[-10:]):9.5f} "
              f"{ev_loss:9.5f} {acc:8.4f}", flush=True)


if __name__ == "__main__":
    main()
