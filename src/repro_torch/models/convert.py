"""Parameters of the JAX package, as the port's parameters.

``params_from_jax(cfg, tree)`` takes the reference's parameter pytree —
nested dicts of numpy arrays, layer-stacked ``[n, ...]`` per stage
(``repro.models.transformer.init_params``) — and returns the same tree of
torch tensors on the requested device, after checking every leaf against
the port's own shapes (a tied model has no ``head`` leaf in either
package).  The CPU tests use it to hand one package's weights to the
other; :func:`repro_torch.models.transformer.init_params` itself draws
the reference's numbers from the same threefry key, on the device.
``maxout_params_from_jax`` does the same for the maxout networks
(``repro.models.maxout.init_params``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import maxout as MX
from . import transformer as T


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _convert(want: dict, tree: dict, name: str, device) -> dict:
    got = _shapes(tree)
    if want != got:
        raise ValueError(f"parameter tree does not match {name!r}: "
                         f"expected {want}, got {got}")

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        a = np.array(t, dtype=np.float32, copy=True)
        return torch.from_numpy(a).to(device)

    return conv(tree)


def params_from_jax(cfg: T.ModelConfig, tree: dict, *, device="cuda") -> dict:
    """The reference's parameters as torch tensors on ``device``."""
    return _convert(_shapes(T.init_params(cfg, device="meta")), tree,
                    cfg.name, device)


def maxout_params_from_jax(cfg: MX.MaxoutConfig, tree: dict, *,
                           device="cuda") -> dict:
    """The reference's maxout parameters as torch tensors on ``device``."""
    return _convert(_shapes(MX.init_params(cfg, 0, device="meta")), tree,
                    cfg.name, device)
