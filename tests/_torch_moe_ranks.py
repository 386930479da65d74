"""The ranks' side of ``tests/test_torch_moe.py``'s expert-parallel world,
and the site names and tree helpers the file shares with it.

It imports torch and ``repro_torch`` only, never jax or the reference:
each spawned rank imports this module by name (``launch.mesh.spawn``).
"""
import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.core.tape import QTape as TTape
from repro_torch.models import moe as TM

PFX = "m"
SITES = ("dispatch", "pre", "expert_out", "out", "shared/pre", "shared/out")
WSITES = ("w_gate", "w_up", "w_down", "shared/w_gate", "shared/w_up",
          "shared/w_down")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _scales():
    names = [f"a:{PFX}/{s}" for s in SITES] + [f"w:{PFX}/{s}" for s in WSITES]
    return names


def _ep_rank(rank, params, x):
    """One rank of a TP = 2 serving world: granite's MoE block expert-
    parallel over ``model`` (the tokens replicated, the experts halved),
    with capacity (prefill) and dropless (decode)."""
    from repro_torch.dist import serve_pod_ctx
    from repro_torch.launch import mesh as M
    tspec = tconfigs.get_smoke("granite_moe_1b").moe_spec
    p = {k: torch.from_numpy(np.array(v)) for k, v in _flat(params).items()}
    out = {}
    for dropless in (False, True):
        exps = {n: torch.tensor(-6.0) for n in _scales()}
        tape = TTape(TPolicy("dfxp"), exps, {})
        with M.use_mesh(M.make_serve_mesh(tp=2)):
            y = TM.moe_ffn(_unflat(p), tspec, torch.from_numpy(x), tape,
                           PFX, dist=serve_pod_ctx(tp=2), dropless=dropless)
        out[dropless] = (y.numpy(),
                         {k: v.numpy() for k, v in tape.stats.items()})
    return out
