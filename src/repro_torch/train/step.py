"""The DFXP train step (paper §5-§7, end to end) — ``repro.train.step``.

Order of operations per step, as in the reference (``step.py:3-16``):
  1. microbatches: forward/backward with quantized activations and
     backprop signals (the model's ``qbound`` sites); accumulate mean
     gradients, forward overflow statistics, and the sinks' gradients
     (the backward overflow statistics);
  2. optional global-norm clip;
  3. round the accumulated weight gradients at the computation width
     (``pg:`` groups — the paper's "gradient" groups);
  4. optimizer math in f32 (the wide-accumulator hypothesis), with its
     multiply-adds rounded once where the reference's compiled step fuses
     them (:func:`repro_torch.optim.opt.fma`);
  5. the max-norm constraint (the paper's maxout recipe) — applied, as the
     reference's code does (``step.py:253-255``), *before* step 6;
  6. round the new parameters (and momentum) at the update width
     (``p:``/``pm:`` groups — the paper's 12-bit parameter updates), in
     sim storage or into packed int mantissas;
  7. feed every group's statistics to the overflow-rate controller and
     apply the scale rule every ``policy.update_interval`` steps.

The step is eager PyTorch: gradients come from
``torch.autograd.grad(loss, [*params, *sinks])``, the step counter and
the controller's cadence stay on the device, and nothing reads a value
back to the host.  In ``packed`` storage parameters and momentum live as
``PackedArray``s; step 4 unpacks them and step 6 packs them again.

Under ``policy.stochastic_rounding`` step 6 rounds stochastically, each
leaf from ``fold_in(rng, hash(name) % 2**31)`` as the reference keys it
(``step.py:261``).  Python salts ``hash`` of a string per process, so
those streams repeat across processes only under a fixed
``PYTHONHASHSEED``; the port and the reference agree within a process.

Not ported here (ROADMAP): ``supervise``/``runaway_ovf`` (item 20),
``numerics_tap`` (item 19) and ``grad_transform``/``ef_transform`` (item
22); each raises if asked for.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.packed import pack
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quant import exact_pow2, float_round, round_mantissa
from repro_torch.core.scale import accumulate, controller_step
from repro_torch.optim.opt import (OptConfig, adamw_update, apply_max_norm,
                                   clip_by_global_norm, global_norm,
                                   sgd_update, tree_map)

from .state import (TrainState, _bexp, _path_str, leaves_with_path,
                    map_with_path, unpack_tree)

Tensor = torch.Tensor


def quantize_param(x: Tensor, width: int, e, *, stochastic_key=None):
    """Quantize a parameter/gradient leaf, to nearest even or, with
    ``stochastic_key``, stochastically; per-layer stats if ``e`` is [L].
    Returns ``(y, stats)`` with stats shaped ``e.shape + (3,)``."""
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    step = exact_pow2(_bexp(e, x))
    qmax = float(2 ** (width - 1) - 1)
    qmin = -float(2 ** (width - 1))
    m = round_mantissa(x.to(torch.float32) / step, stochastic_key)
    over = (m > qmax) | (m < qmin)
    over_h = (m > qmax / 2) | (m < qmin / 2)
    if e.ndim:
        axes = tuple(range(e.ndim, x.ndim))
        ovf = over.sum(dim=axes).to(torch.float32)
        ovfh = over_h.sum(dim=axes).to(torch.float32)
    else:
        ovf = torch.count_nonzero(over).to(torch.float32)
        ovfh = torch.count_nonzero(over_h).to(torch.float32)
    total = torch.full(ovf.shape, float(x.numel() / max(1, e.numel())),
                       dtype=torch.float32, device=x.device)
    y = (m.clamp_(qmin, qmax) * step).to(x.dtype)
    return y, torch.stack([ovf, ovfh, total], dim=-1)


def _map_with_group(fn, tree, exps: Dict[str, Tensor], prefix: str):
    """Map ``fn(leaf, e, name)`` with each leaf's scale-group exponent.
    Returns ``(tree', {group: stats})``."""
    stats: Dict[str, Tensor] = {}

    def apply(path, leaf):
        name = _path_str(path)
        out, st = fn(leaf, exps[f"{prefix}{name}"], name)
        stats[f"{prefix}{name}"] = st
        return out

    return map_with_path(apply, tree), stats


def _unflatten(template, leaves):
    it = iter(leaves)
    return map_with_path(lambda _, __: next(it), template)


def _split(batch: dict, n: int):
    """``n`` microbatches of a batch dict along axis 0."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    m = B // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def loss_and_grads(loss_fn: Callable, params, batch, sinks, exps):
    """``(loss, forward stats, grads, sink stats)`` of one forward and
    backward: ``torch.autograd.grad`` with respect to the parameters and
    the sinks together, as ``jax.grad(..., argnums=(params, sinks))``."""
    leaves = [x.detach().requires_grad_(True)
              for _, x in leaves_with_path(params)]
    loss, fwd_stats = loss_fn(_unflatten(params, leaves), batch, sinks, exps)
    wrt = leaves + list(sinks.values())
    gs = torch.autograd.grad(loss, wrt, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, wrt)]
    return (loss.detach(), {k: v.detach() for k, v in fwd_stats.items()},
            _unflatten(params, gs[:len(leaves)]),
            dict(zip(sinks, gs[len(leaves):])))


def make_train_step(
    loss_fn: Callable,            # (params, batch, sinks, exps) -> (loss, stats)
    group_shapes: Dict[str, tuple],
    policy: PrecisionPolicy,
    opt_cfg: OptConfig,
    *,
    microbatches: int = 1,
    compute_dtype=torch.float32,
    grad_transform: Optional[Callable] = None,
    numerics_tap: bool = False,
    ef_transform: Optional[Callable] = None,
    supervise: bool = False,
    runaway_ovf: Optional[float] = None,
):
    """Build ``step(state, batch, rng=None) -> (state, metrics)``.

    ``metrics`` holds device tensors: ``loss`` (mean over microbatches),
    ``grad_norm`` (before clipping) and ``step``.  ``rng`` (a threefry
    key, :mod:`repro_torch.core.prng`) keys the stochastic storage
    rounding of ``policy.stochastic_rounding`` only, as in the reference;
    the loss function draws its own dropout keys."""
    for flag, item, what in ((supervise or runaway_ovf is not None, 20,
                              "supervise/runaway_ovf"),
                             (numerics_tap, 19, "numerics_tap"),
                             (grad_transform is not None
                              or ef_transform is not None, 22,
                              "grad_transform/ef_transform")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP module item {item})")
    dyn = policy.dynamic
    quant_params = policy.enabled and policy.arithmetic in ("fixed", "dfxp")

    stochastic = policy.stochastic_rounding and quant_params

    def step(state: TrainState, batch, rng=None):
        if stochastic and rng is None:
            raise ValueError("stochastic rounding requires a PRNG key")
        dev = state.step.device
        if stochastic:
            rng = prng.as_key(rng, dev)
        sinks = {n: torch.zeros(s + (3,), dtype=torch.float32, device=dev,
                                requires_grad=True)
                 for n, s in group_shapes.items() if n.startswith("g:")}
        if policy.storage == "packed":
            params_c = unpack_tree(state.params, compute_dtype)
            mom_c = unpack_tree(state.opt, torch.float32)
        else:
            params_c, mom_c = state.params, state.opt
        exps = state.scale.exps

        # ---- 1. grads over microbatches ----------------------------------
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(torch.zeros_like, params_c)
            sink_stats = {n: torch.zeros_like(s) for n, s in sinks.items()}
            fwd_stats = {n: torch.zeros(s + (3,), dtype=torch.float32,
                                        device=dev)
                         for n, s in group_shapes.items()
                         if n.startswith(("a:", "w:"))}
            for b in _split(batch, microbatches):
                lo, st, g, gs = loss_and_grads(loss_fn, params_c, b, sinks,
                                               exps)
                loss = loss + lo
                grads = tree_map(torch.add, grads, g)
                sink_stats = {k: sink_stats[k] + gs[k] for k in sink_stats}
                fwd_stats = {k: fwd_stats[k] + st[k] if k in st
                             else fwd_stats[k] for k in fwd_stats}
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        else:
            loss, fwd_stats, grads, sink_stats = loss_and_grads(
                loss_fn, params_c, batch, sinks, exps)

        with torch.no_grad():
            # ---- 2. clip -------------------------------------------------
            gnorm = global_norm(grads)
            if opt_cfg.grad_clip:
                grads, _ = clip_by_global_norm(grads, opt_cfg.grad_clip)
            all_stats: Dict[str, Tensor] = {}
            for d in (fwd_stats, sink_stats):
                for k, v in d.items():
                    all_stats[k] = all_stats[k] + v if k in all_stats else v

            # ---- 3. gradient rounding (pg:) ------------------------------
            if quant_params:
                grads, gstats = _map_with_group(
                    lambda g, e, n: quantize_param(g, policy.comp_width, e),
                    grads, exps, "pg:")
                all_stats.update(gstats)

            # ---- 4. optimizer (wide math) --------------------------------
            if opt_cfg.kind == "sgd":
                updates, new_opt = sgd_update(opt_cfg, grads, mom_c,
                                              state.step)
            else:
                updates, new_opt = adamw_update(opt_cfg, grads, mom_c,
                                                state.step, params=params_c)
            # The reference's compiled step adds an SGD update with one
            # rounding in sim storage (XLA fuses p + (-lr * m)) and with
            # two in packed storage (XLA fuses the unpacking product
            # instead, so -lr * m is rounded first); each storage mode
            # does as the reference's does.  Updates arrive exact (float64)
            # from sgd_update.
            packed = policy.storage == "packed"
            new_params = tree_map(
                lambda p, u: (p.to(torch.float32)
                              + (u.to(torch.float32) if packed else u)
                              ).to(torch.float32),
                params_c, updates)

            # ---- 5. max-norm (before storage rounding, as the reference)
            if opt_cfg.max_col_norm:
                new_params = apply_max_norm(new_params, opt_cfg.max_col_norm)

            # ---- 6. parameter/momentum storage rounding (p:/pm:) ---------
            def q_store(x, e, name):
                sk = None
                if stochastic:
                    sk = prng.fold_in(rng, hash(name) % (2 ** 31))
                return quantize_param(x, policy.update_width, e,
                                      stochastic_key=sk)

            def pk(x, e, name):
                y, st = q_store(x, e, name)
                return pack(y, policy.update_width, _bexp(e, y)), st

            store = pk if policy.storage == "packed" else q_store
            if quant_params:
                new_params, pstats = _map_with_group(store, new_params, exps,
                                                     "p:")
                all_stats.update(pstats)
                if policy.quantize_momentum and opt_cfg.kind == "sgd":
                    new_mom, mstats = _map_with_group(
                        store, new_opt["momentum"], exps, "pm:")
                    new_opt = {"momentum": new_mom}
                    all_stats.update(mstats)
            elif policy.enabled:
                # float emulation of the storage format (fp16/bf16/fp8 rows)
                fmt = policy.update_format()
                new_params = tree_map(lambda x: float_round(x, fmt),
                                      new_params)

            # ---- 7. scale controller -------------------------------------
            new_scale = state.scale
            if dyn:
                new_scale = accumulate(new_scale, all_stats)
                apply = (state.step + 1) % policy.update_interval == 0
                new_scale = controller_step(
                    new_scale, max_overflow_rate=policy.max_overflow_rate,
                    apply=apply)

        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": state.step.to(torch.float32)}
        return TrainState(params=new_params, opt=new_opt, scale=new_scale,
                          step=state.step + 1), metrics

    return step
