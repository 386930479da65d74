"""How far two implementations of the same DFXP training run agree, step
by step: the reference's jitted step against (a) the same step run eagerly
(``jax.disable_jit``, where XLA fuses no multiply-add) and (b) the port's
step on the CPU, from the same weights and calibrated exponents.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/dfxp_divergence.py

``benchmarks/_common.py``'s ``CFG`` on ``SyntheticImages.hard()``, batch
64, DFXP 10/12 with ``update_interval=10`` (the Table-3 row), dropout
off.  Prints, per step and per pairing, the loss's relative difference,
the number of parameter elements that differ and whether every exponent
agrees.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks import _common as bench
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import maxout as JMX
from repro.optim import opt as jopt
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train.calibrate import calibrate as j_calibrate
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models import maxout as TMX
from repro_torch.models.convert import maxout_params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step

STEPS = 50


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


def main():
    kw = dict(arithmetic="dfxp", comp_width=10, update_width=12,
              update_interval=10)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    jcfg = bench.CFG
    tcfg = TMX.MaxoutConfig(**dataclasses.asdict(jcfg))
    gs = JMX.group_shapes(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(7))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    obs = dataclasses.replace(jpol, arithmetic="observe")
    init = j_calibrate(
        lambda p, b, s, e: JMX.loss_fn(jcfg, obs, p, b, e, s), jp, gs, jpol,
        bench.OPT, ({k: jnp.asarray(v) for k, v in
                     bench.DATA.batch(i, bench.BATCH).items()}
                    for i in range(10)), steps=6)
    init_np = {k: np.array(v, np.float32) for k, v in init.items()}
    f = j_make_step(lambda p, b, s, e: JMX.loss_fn(jcfg, jpol, p, b, e, s),
                    gs, jpol, bench.OPT)
    jit = jax.jit(f)
    tstep = t_make_step(lambda p, b, s, e: TMX.loss_fn(tcfg, tpol, p, b, e, s),
                        gs, tpol, topt.OptConfig(**dataclasses.asdict(
                            bench.OPT)))
    ref = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=init)
    eager = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=init)
    port = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=init_np)
    data = bench.DATA
    print("step | eager vs jit: loss rel diff, params differing, exps equal"
          " | port vs jit: the same")
    for i in range(STEPS):
        b = data.batch(i, bench.BATCH)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        ref, mr = jit(ref, jb, jax.random.PRNGKey(i))
        with jax.disable_jit():
            eager, me = f(eager, jb, jax.random.PRNGKey(i))
        port, mp = tstep(port, {k: torch.from_numpy(v) for k, v in b.items()})
        pr = _flat(ref.params)
        row = [f"{i:4d}"]
        for state, m in ((eager, me), (port, mp)):
            loss = float(m["loss"])
            other = _flat(state.params)
            n = sum(int((pr[k] != other[k]).sum()) for k in pr)
            same = all(float(np.asarray(v)) == float(np.asarray(
                state.scale.exps[k])) for k, v in ref.scale.exps.items())
            row.append(f"{abs(loss / float(mr['loss']) - 1):.2e} {n:6d} "
                       f"{same}")
        print(" | ".join(row), flush=True)


if __name__ == "__main__":
    main()
