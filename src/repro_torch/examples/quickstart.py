"""Quickstart on the port: the paper in one file — train the same maxout
network under fp32 / fp16 / fixed-20 / DFXP-10/12 and watch low precision
match fp32.  The counterpart of ``examples/quickstart.py`` and of
``benchmarks/paper_tables.py::table3_formats``, on the reference's recipe:
weights from ``PRNGKey(7)`` (calibration from ``PRNGKey(0)``), dropout on
with the loss's ``rng=PRNGKey(1)``, and step ``i`` keyed ``PRNGKey(i)``
(which only stochastic storage rounding reads).

    python -m repro_torch.examples.quickstart                # the card
    python -m repro_torch.examples.quickstart --device cpu --smoke

The default model is the paper's PI-MNIST maxout at full width
(``MaxoutConfig()``: 784 → 240×5 → 240×5 → 10); ``--smoke`` trains the
reference quickstart's narrower net (64×3, 64×3).  ``CONV`` and
``CONV_OPT`` are the conv branch at its defaults and the learning rate it
trains at, for :func:`train` (``chip_smoke.py`` runs them).
``--fused-matmul`` runs the DFXP row's matmuls through the quantized
matmul kernel K2 and ``--kernel-quantize`` routes large rounding sites to
the fused quantize kernel K1 (on the CPU both compute their plain
versions).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quant import enable_pallas_quantize
from repro_torch.data import SyntheticImages
from repro_torch.kernels.dfxp import ops as k1
from repro_torch.kernels.qmatmul import ops as k2
from repro_torch.models import maxout as MX
from repro_torch.optim.opt import OptConfig, sgd_init
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.calibrate import calibrate
from repro_torch.train.state import unpack_tree

STEPS = 150
BATCH = 64
OPT = OptConfig(kind="sgd", lr=0.1, lr_decay_steps=2000, max_col_norm=1.9365)
SMOKE = MX.MaxoutConfig(hidden=(64, 64), pieces=3)
CONV = MX.MaxoutConfig(name="maxout_conv", conv=True)
# No reference run trains the conv branch.  At the PI net's lr 0.1 it
# diverges in float32 even with max-norm, and calibration's observe steps
# (plain SGD, no max-norm, as the reference's) diverge from lr 0.01; at
# 0.005 both stay finite.
CONV_OPT = dataclasses.replace(OPT, lr=0.005)
DROPOUT_SEED = 1          # the loss's rng=PRNGKey(1), fixed at every step
# (init seed, dropout seed) pairs for a row's spread over seeds: the
# recipe's own first (``tests/test_torch_table3_seeds.py``, ``chip_smoke.py``)
SEED_PAIRS = tuple((7 + k, DROPOUT_SEED + k) for k in range(8))


def dfxp_policy(fused_matmul: bool = False) -> PrecisionPolicy:
    return PrecisionPolicy("dfxp", comp_width=10, update_width=12,
                           update_interval=10, fused_matmul=fused_matmul)


def data_for(cfg: MX.MaxoutConfig) -> SyntheticImages:
    return SyntheticImages(image_shape=cfg.image_shape if cfg.conv else ())


def batches(data: SyntheticImages, n: int, device, batch: int = BATCH):
    for i in range(n):
        b = data.batch(i, batch)
        yield {"x": torch.from_numpy(b["x"]).to(device),
               "y": torch.from_numpy(b["y"]).to(device)}


def launch_counts() -> dict:
    return {"dfxp_quantize": k1.LAUNCHES["dfxp_quantize"],
            "qmatmul": k2.launches()}


def loss_fn(cfg: MX.MaxoutConfig, policy: PrecisionPolicy, device,
            dropout_seed: int = DROPOUT_SEED):
    """The recipe's training loss: dropout keyed by ``PRNGKey(1)`` at
    every step, as the reference's quickstart and harness key it."""
    rng = prng.PRNGKey(dropout_seed, device)

    def fn(p, b, s, exps):
        return MX.loss_fn(cfg, policy, p, b, exps, s, rng=rng)

    return fn


def calibrated_exps(cfg: MX.MaxoutConfig, policy: PrecisionPolicy, device, *,
                    data=None, steps: int = 8, seed: int = 0,
                    opt: OptConfig = OPT, n_batches=None) -> dict:
    """Initial DFXP exponents from ``steps`` observe-steps (paper §9.3)
    from the weights of ``PRNGKey(seed)``, dropout on."""
    data = data or data_for(cfg)
    obs = dataclasses.replace(policy, arithmetic="observe", storage="sim")
    params0 = MX.init_params(cfg, seed, device)
    gs = MX.group_shapes(cfg)
    return calibrate(loss_fn(cfg, obs, device), params0, gs, policy, opt,
                     batches(data, n_batches or steps + 2, device),
                     steps=steps)


def train(cfg: MX.MaxoutConfig, policy: PrecisionPolicy, device, *,
          init_exp=-8.0, steps: int = STEPS, batch: int = BATCH, data=None,
          seed: int = 7, eval_n: int = 1024, opt: OptConfig = OPT,
          dropout_seed: int = DROPOUT_SEED) -> dict:
    """Train ``steps`` SGD steps from the weights of ``PRNGKey(seed)``
    with dropout keyed by ``PRNGKey(dropout_seed)``; evaluate on
    ``data.eval_set(eval_n)``.  Returns the final loss, every step's
    loss, the eval accuracy, the final state, the exponents its last step
    stored the parameters with (the §5 controller may move them after
    that rounding), the seconds the loop took and the K1/K2 launches of
    the training loop alone."""
    data = data or data_for(cfg)
    gs = MX.group_shapes(cfg)
    params = MX.init_params(cfg, seed, device)
    state = init_train_state(params, sgd_init(params), gs, policy,
                             init_exp=init_exp)
    step = make_train_step(loss_fn(cfg, policy, device, dropout_seed), gs,
                           policy, opt)
    before = launch_counts()
    losses = []
    t0 = time.perf_counter()
    for i, b in enumerate(batches(data, steps, device, batch)):
        store_exps = dict(state.scale.exps)    # what step i rounds with
        state, m = step(state, b, prng.PRNGKey(i, device))
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()          # one sync for the run
    seconds = time.perf_counter() - t0
    after = launch_counts()
    ev = data.eval_set(eval_n)
    params_eval = (unpack_tree(state.params) if policy.storage == "packed"
                   else state.params)
    acc = MX.accuracy(cfg, policy, params_eval,
                      {"x": torch.from_numpy(ev["x"]).to(device),
                       "y": torch.from_numpy(ev["y"]).to(device)},
                      state.scale.exps, {})
    return {"loss": losses[-1], "losses": losses, "acc": float(acc),
            "state": state, "store_exps": store_exps, "seconds": seconds,
            "launches": {k: after[k] - before[k] for k in after}}


def rows(init_exp, fused_matmul: bool = False):
    """The Table-3 rows: (name, policy, initial exponents)."""
    return [
        ("float32 (baseline)", PrecisionPolicy("float32"), -8.0),
        ("float16", PrecisionPolicy("float16"), -8.0),
        ("fixed point 20/20", PrecisionPolicy("fixed", comp_width=20,
                                              update_width=20), -8.0),
        ("dfxp 10/12 (paper)", dfxp_policy(fused_matmul), init_exp),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference quickstart's net, (64, 64) x 3")
    ap.add_argument("--fused-matmul", action="store_true",
                    help="DFXP matmuls through the quantized matmul K2")
    ap.add_argument("--kernel-quantize", action="store_true",
                    help="large rounding sites through the quantize K1")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = SMOKE if args.smoke else MX.MaxoutConfig()
    enable_pallas_quantize(args.kernel_quantize)
    try:
        # calibrate DFXP scales first (paper §9.3)
        init_exp = calibrated_exps(cfg, dfxp_policy(args.fused_matmul),
                                   device)
        results = {}
        print(f"{'format':22s} {'final loss':>10s} {'eval acc':>9s}")
        for name, pol, ie in rows(init_exp, args.fused_matmul):
            r = train(cfg, pol, device, init_exp=ie)
            results[name] = r
            print(f"{name:22s} {r['loss']:10.4f} {r['acc']:9.3f}",
                  flush=True)
    finally:
        enable_pallas_quantize(False)
    return {"cfg": cfg, "init_exp": init_exp, "rows": results}


if __name__ == "__main__":
    main()
