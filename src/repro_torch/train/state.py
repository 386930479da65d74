"""TrainState: parameters (+ optional packed storage), optimizer, DFXP scales —
``repro.train.state``.

Parameter-storage quantization groups (paper §6's "Up." bit-width) are
derived from the parameter tree itself (nested dicts of tensors, leaf
names joined by ``/``):
  * ``p:<path>``  — parameter storage scale (update width),
  * ``pg:<path>`` — weight-gradient scale (computation width),
  * ``pm:<path>`` — momentum/optimizer-state scale (update width).
Stacked per-layer leaves (under a stage's ``stacked`` subtree) get one
scale *per layer* (leading axis), mirroring the paper's per-layer groups.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.core.packed import PackedArray, pack, unpack
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.scale import ScaleState

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    params: Any                    # f32 tree (sim) | PackedArray tree
    opt: Any                       # optimizer state (matching storage)
    scale: ScaleState
    step: Tensor                   # int32 scalar, on the params' device


def leaves_with_path(tree, path=()):
    """``[(path tuple, leaf)]`` of nested dicts; a PackedArray is a leaf."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in leaves_with_path(v, path + (str(k),))]
    return [(path, tree)]


def map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, keeping their structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(path)


def param_leaf_groups(params) -> Dict[str, tuple]:
    """Map each param leaf path -> scale-group shape (per-layer if stacked)."""
    out = {}
    for path, leaf in leaves_with_path(params):
        name = _path_str(path)
        shape = leaf.shape if not isinstance(leaf, PackedArray) \
            else leaf.mantissa.shape
        stacked = "stacked" in name
        out[name] = (shape[0],) if (stacked and len(shape) > 0) else ()
    return out


def param_group_shapes(params) -> Dict[str, tuple]:
    shapes = {}
    for name, shape in param_leaf_groups(params).items():
        shapes[f"p:{name}"] = shape
        shapes[f"pg:{name}"] = shape
        shapes[f"pm:{name}"] = shape
    return shapes


def _device(tree) -> torch.device:
    leaf = leaves_with_path(tree)[0][1]
    return (leaf.mantissa if isinstance(leaf, PackedArray) else leaf).device


def init_train_state(params, opt_state, model_groups: Dict[str, tuple],
                     policy: PrecisionPolicy,
                     init_exp: float | Dict[str, Any] = -8.0) -> TrainState:
    device = _device(params)
    groups = dict(model_groups)
    groups.update(param_group_shapes(params))
    scale = ScaleState.create(groups, init_exp, device=device)
    if policy.storage == "packed":
        params = pack_tree(params, scale, "p:", policy.update_width)
        opt_state = pack_tree(opt_state, scale, "pm:", policy.update_width,
                              strip_prefix=1)
    elif policy.arithmetic in ("fixed", "dfxp"):
        # paper: parameters live at the update width from step 0 (packed
        # storage gets this from pack(); sim storage rounds them here)
        from .step import quantize_param

        def q(path, leaf):
            e = scale.exps[f"p:{_path_str(path)}"]
            return quantize_param(leaf, policy.update_width, e)[0]
        params = map_with_path(q, params)
    return TrainState(params=params, opt=opt_state, scale=scale,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def pack_tree(tree, scale: ScaleState, prefix: str, width: int,
              strip_prefix: int = 0):
    """Pack every leaf into a PackedArray using its group's exponent."""
    def pack_leaf(path, leaf):
        name = _path_str(path[strip_prefix:])
        e = scale.exps[f"{prefix}{name}"]
        return pack(leaf, width, _bexp(e, leaf))
    return map_with_path(pack_leaf, tree)


def unpack_tree(tree, dtype=torch.float32):
    return map_with_path(
        lambda _, x: unpack(x, dtype) if isinstance(x, PackedArray) else x,
        tree)


def _bexp(e, x) -> Tensor:
    """Broadcast a per-layer exponent [L] against a stacked leaf [L, ...]."""
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    if e.ndim == 0:
        return e
    return e.reshape(e.shape + (1,) * (x.ndim - e.ndim))
