"""Scale calibration (paper §9.3) — ``repro.train.calibrate``.

"We find the initial scaling factors by training with a higher precision
format.  Once those scaling factors are found, we reinitialize the model
parameters."  Runs K steps with the ``observe`` pseudo-arithmetic (f32
math; every quantization site records ``max|value|`` through the same
tape and sink machinery), takes the running max per group, and converts
magnitudes to initial log2-step exponents with one headroom bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.scale import calibrate_exp
from repro_torch.optim.opt import OptConfig, sgd_update, tree_map

from .state import _device, param_group_shapes
from .step import _map_with_group, loss_and_grads

Tensor = torch.Tensor


def observe_policy(policy: PrecisionPolicy) -> PrecisionPolicy:
    return dataclasses.replace(policy, arithmetic="observe", storage="sim")


def make_observe_step(loss_fn: Callable, group_shapes: Dict[str, tuple],
                      opt_cfg: OptConfig):
    """One f32 SGD step that also returns per-group max-|value| stats."""

    def step(params, mom, opt_step, batch, exps):
        dev = _device(params)
        sinks = {n: torch.zeros(s + (3,), dtype=torch.float32, device=dev,
                                requires_grad=True)
                 for n, s in group_shapes.items() if n.startswith("g:")}
        loss, fwd_stats, grads, sink_stats = loss_and_grads(
            loss_fn, params, batch, sinks, exps)

        with torch.no_grad():
            def obs(x, e, name):
                ax = x.to(torch.float32).abs()
                axes = tuple(range(torch.as_tensor(e).ndim, x.ndim))
                mx = torch.amax(ax, dim=axes) if axes else ax
                z = torch.zeros_like(mx)
                return x, torch.stack([mx, z, z + 1.0], dim=-1)

            def zeros(prefix):
                return {k: torch.zeros(v) for k, v in group_shapes.items()
                        if k.startswith(prefix)}

            _, gstats = _map_with_group(obs, grads, zeros("pg:"), "pg:")
            updates, new_momd = sgd_update(opt_cfg, grads, mom, opt_step)
            new_params = tree_map(lambda p, u: (p + u).to(torch.float32),
                                  params, updates)
            _, pstats = _map_with_group(obs, new_params, zeros("p:"), "p:")
            _, mstats = _map_with_group(obs, new_momd["momentum"],
                                        zeros("pm:"), "pm:")
            stats: Dict[str, Tensor] = {}
            for d in (fwd_stats, sink_stats, gstats, pstats, mstats):
                for k, v in d.items():
                    v = v[..., 0]
                    stats[k] = torch.maximum(stats[k], v) if k in stats \
                        else torch.clamp(v, min=0.0)
        return new_params, new_momd, loss, stats

    return step


def calibrate(loss_fn: Callable, params, group_shapes: Dict[str, tuple],
              policy: PrecisionPolicy, opt_cfg: OptConfig, batches,
              *, steps: int = 10) -> Dict[str, Tensor]:
    """Run K observe-steps over ``batches`` → per-group init exponents.

    ``loss_fn`` must already compute under :func:`observe_policy`."""
    dev = _device(params)
    all_groups = dict(group_shapes)
    all_groups.update(param_group_shapes(params))
    step = make_observe_step(loss_fn, all_groups, opt_cfg)
    mom = {"momentum": tree_map(torch.zeros_like, params)}
    exps0 = {n: torch.zeros(s, dtype=torch.float32, device=dev)
             for n, s in all_groups.items()}

    maxes: Dict[str, Tensor] = {}
    it = iter(batches)
    for i in range(steps):
        batch = next(it)
        params, mom, _, stats = step(
            params, mom, torch.tensor(i, dtype=torch.int32, device=dev),
            batch, exps0)
        for k, v in stats.items():
            maxes[k] = torch.maximum(maxes[k], v) if k in maxes else v

    init_exp: Dict[str, Tensor] = {}
    for name, shape in all_groups.items():
        width = (policy.update_width if name.startswith(("p:", "pm:"))
                 else policy.comp_width)
        mx = maxes.get(name)
        if mx is None:
            init_exp[name] = torch.zeros(shape, dtype=torch.float32,
                                         device=dev)
        else:
            init_exp[name] = torch.broadcast_to(
                calibrate_exp(mx, width, margin_bits=1), shape).clone()
    return init_exp
