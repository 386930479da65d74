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

``supervise=True`` is the fault-tolerant variant that
:class:`repro_torch.train.resilience.TrainSupervisor` drives
(``step.py:84-93``, ``:317-357`` of the reference): device-side sentinels
and a branch-free ``torch.where`` select that discards a tripped step's
update on the device.

Not ported here (ROADMAP): ``numerics_tap`` (item 19) and
``grad_transform``/``ef_transform`` (item 22); each raises if asked for.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.packed import PackedArray, pack
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quant import exact_pow2, float_round, round_mantissa
from repro_torch.core.scale import ScaleState, accumulate, controller_step
from repro_torch.core.tape import tensor_class
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


# Sentinel flag bits (metrics["flags"] in supervised mode).
FLAG_LOSS_NONFINITE = 1
FLAG_GRAD_NONFINITE = 2
FLAG_RUNAWAY_OVF = 4


def benign_injection() -> Dict[str, Tensor]:
    """The no-fault injection input of a supervised step (host scalars;
    a step adds them to device tensors without a copy or a sync)."""
    return {"grad_nan": torch.tensor(False),
            "loss_scale": torch.tensor(1.0, dtype=torch.float32)}


def _select(pred: Tensor, old, new):
    """``torch.where(pred, old, new)`` over a state tree (dicts,
    ``PackedArray``s, ``ScaleState``s, tensors)."""
    if isinstance(new, dict):
        return {k: _select(pred, old[k], v) for k, v in new.items()}
    if isinstance(new, PackedArray):
        return PackedArray(_select(pred, old.mantissa, new.mantissa),
                           _select(pred, old.exp, new.exp), new.width)
    if isinstance(new, ScaleState):
        return ScaleState(exps=_select(pred, old.exps, new.exps),
                          acc=_select(pred, old.acc, new.acc))
    return torch.where(pred, old, new)


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
    the loss function draws its own dropout keys.

    ``supervise=True`` makes the signature ``step(state, batch, rng, ef,
    inj) -> (state, metrics, ef)`` (``ef`` is ``{}`` until the
    error-feedback transforms are ported, ROADMAP item 22):

    * ``inj`` is the fault-injection input (:func:`benign_injection`):
      ``loss_scale`` multiplies the loss before autograd (a loss spike
      travels through real gradients) and ``grad_nan`` adds
      ``where(flag, nan, 0)`` to every gradient leaf;
    * ``metrics["flags"]`` is an int32 bitmask — :data:`FLAG_LOSS_NONFINITE`
      | :data:`FLAG_GRAD_NONFINITE` | :data:`FLAG_RUNAWAY_OVF` (a tensor
      class, :func:`repro_torch.core.tape.tensor_class`, whose §5
      overflow rate this step exceeds ``runaway_ovf``) — and
      ``metrics["cls_rates"]`` the per-class rates;
    * on a tripped sentinel the update is discarded on the device by a
      ``torch.where`` select, no branch and no read-back: parameters,
      optimizer state, step and ``ef`` keep their old values; the scale
      state keeps its old value on a NaN trip and takes the new one on a
      runaway-only trip (the §5 controller must see the overflow window
      to move out of it).
    """
    for flag, item, what in ((numerics_tap, 19, "numerics_tap"),
                             (grad_transform is not None
                              or ef_transform is not None, 22,
                              "grad_transform/ef_transform")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP module item {item})")
    if supervise and policy.storage == "packed" and opt_cfg.kind != "sgd":
        # the step returns adamw's moments in f32 where the state held them
        # packed, and the discard selects between the two; the reference's
        # select fails on the same mismatch (ROADMAP §3)
        raise ValueError("a supervised step in packed storage takes SGD, "
                         f"not {opt_cfg.kind!r}")
    dyn = policy.dynamic
    quant_params = policy.enabled and policy.arithmetic in ("fixed", "dfxp")

    stochastic = policy.stochastic_rounding and quant_params

    def _impl(state: TrainState, batch, rng, ef, inj):
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
        lfn = loss_fn
        if inj is not None:
            def lfn(p, b, s, e):
                # a loss spike rides through autograd: scaled loss, grads
                loss, st = loss_fn(p, b, s, e)
                return loss * inj["loss_scale"], st

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
                lo, st, g, gs = loss_and_grads(lfn, params_c, b, sinks, exps)
                loss = loss + lo
                grads = tree_map(torch.add, grads, g)
                sink_stats = {k: sink_stats[k] + gs[k] for k in sink_stats}
                fwd_stats = {k: fwd_stats[k] + st[k] if k in st
                             else fwd_stats[k] for k in fwd_stats}
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        else:
            loss, fwd_stats, grads, sink_stats = loss_and_grads(
                lfn, params_c, batch, sinks, exps)

        with torch.no_grad():
            if inj is not None:
                poison = torch.where(inj["grad_nan"], float("nan"), 0.0)
                grads = tree_map(lambda g: g + poison.to(g.dtype), grads)

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
            new_state = TrainState(params=new_params, opt=new_opt,
                                   scale=new_scale, step=state.step + 1)
            if not supervise:
                return new_state, metrics, ef

            # ---- sentinels and the on-device discard ---------------------
            bad_loss = ~torch.isfinite(loss)
            bad_grad = ~torch.isfinite(gnorm)
            cls_ovf: Dict[str, Tensor] = {}
            cls_tot: Dict[str, Tensor] = {}
            for gname, st in all_stats.items():
                c = tensor_class(gname)
                cls_ovf[c] = cls_ovf.get(c, 0.0) + st[..., 0].sum()
                cls_tot[c] = cls_tot.get(c, 0.0) + st[..., 2].sum()
            cls_rates = {c: cls_ovf[c] / torch.clamp(cls_tot[c], min=1.0)
                         for c in sorted(cls_ovf)}
            runaway = torch.zeros((), dtype=torch.bool, device=dev)
            if runaway_ovf is not None and cls_rates:
                runaway = torch.stack(list(cls_rates.values())).max() \
                    > runaway_ovf
            metrics["flags"] = (bad_loss.to(torch.int32) * FLAG_LOSS_NONFINITE
                                + bad_grad.to(torch.int32)
                                * FLAG_GRAD_NONFINITE
                                + runaway.to(torch.int32) * FLAG_RUNAWAY_OVF)
            metrics["cls_rates"] = cls_rates
            nan_bad = bad_loss | bad_grad
            any_bad = nan_bad | runaway
            new_state = TrainState(
                params=_select(any_bad, state.params, new_state.params),
                opt=_select(any_bad, state.opt, new_state.opt),
                # runaway-only: keep the new scale so the §5 controller
                # can move the exponent out of the overflow regime
                scale=_select(nan_bad, state.scale, new_state.scale),
                step=torch.where(any_bad, state.step, new_state.step))
            return new_state, metrics, ef     # no ef_transform: unchanged

    if supervise:
        def step(state: TrainState, batch, rng, ef, inj):
            return _impl(state, batch, rng, ef, inj)
    else:
        def step(state: TrainState, batch, rng=None):
            new_state, metrics, _ = _impl(state, batch, rng, {}, None)
            return new_state, metrics

    return step
