"""Mixture-of-Experts FFN — the single-device path of ``repro.models.moe``.

Routing is capacity-based (Switch/GShard style): each token's top-k
experts get it unless the expert's capacity ``C = ceil(T·k/E · cf)`` is
exhausted (decode is dropless: ``C = T``).  Dispatch and combine are
scatters and gathers, not one-hot products.

DFXP: the dispatched activations, the expert hidden layer and the expert
outputs are quantization sites; the router's logits and softmax stay in
f32 (the reference's documented deviation: routing decisions are
precision-sensitive).  The expert banks are rounded through
``tape.weight`` and multiplied with ``torch.bmm``, as the reference's
``einsum``s are plain XLA products outside any Pallas kernel.

Determinism (the trainer's bit-for-bit resume on the card):
  * ``top_k`` breaks ties by the lower expert index, as
    ``jax.lax.top_k`` does: a stable descending sort;
  * the dispatch writes each kept slot to its own ``(expert, rank)`` row
    and sends dropped slots to a scratch row past the capacity, which is
    cut off: no two writes share a kept row, so no atomics decide a sum;
  * the combine sums a token's ``k`` contributions in the order
    ``j = 0 .. k-1`` (XLA's CPU scatter-add order), and the dispatch's
    gather of a token's ``k`` copies differentiates as a sum over a
    fixed axis.

Not ported (ROADMAP module item 22): expert parallelism (the
``all_to_all`` dispatch), FSDP weight gathers and the stationary decode.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.tape import QTape

from .layers import init_dense, init_swiglu, swiglu

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int                      # per-expert hidden dim
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert_d_ff: int = 0    # 0 = no shared expert (llama4 uses one)
    renormalize: bool = True


def init_moe(key: Tensor, spec: MoESpec) -> dict:
    """The reference's draws: ``split(key, 5)`` into the router, the
    three expert banks (normals over ``sqrt`` of their fan-in) and the
    shared expert.  A batch of keys ``[L, 2]`` draws ``L`` layers."""
    ks = prng.split(key, 5)
    E, D, Fd = spec.num_experts, spec.d_model, spec.d_ff

    def bank(k, shape, fan_in):
        return prng.normal_blocked(k, shape).div_(
            float(np.float32(math.sqrt(fan_in))))

    p = {
        "router": init_dense(ks[..., 0, :], D, E, scale=0.02),
        "w_gate": bank(ks[..., 1, :], (E, D, Fd), D),
        "w_up": bank(ks[..., 2, :], (E, D, Fd), D),
        "w_down": bank(ks[..., 3, :], (E, Fd, D), Fd),
    }
    if spec.shared_expert_d_ff:
        p["shared"] = init_swiglu(ks[..., 4, :], D, spec.shared_expert_d_ff)
    return p


def _capacity(t_local: int, spec: MoESpec, dropless: bool = False) -> int:
    if dropless:
        # decode batches are tiny: full capacity keeps decode exact with
        # respect to the full forward (no token dropped)
        return t_local
    return max(1, math.ceil(t_local * spec.top_k / spec.num_experts
                            * spec.capacity_factor))


def route(x: Tensor, router_w: Tensor, spec: MoESpec, capacity: int):
    """Routing of tokens ``x`` [T, D] in f32: ``(eid, gate, pos, keep)``,
    each ``[T*k]`` in token-major order — the chosen expert, its
    (renormalised) gate, the slot's rank within its expert (the cumsum of
    the one-hot over the slots before it) and whether that rank is
    within ``capacity``."""
    E, k = spec.num_experts, spec.top_k
    logits = torch.matmul(x.to(torch.float32), router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    if spec.renormalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    eid = ids.reshape(-1)
    gate = gates.reshape(-1)
    onehot = F.one_hot(eid, E).to(torch.int32)               # [T*k, E]
    pos = torch.gather(torch.cumsum(onehot, 0, dtype=torch.int32) - 1, 1,
                       eid[:, None])[:, 0]
    keep = pos < capacity
    return eid, gate, pos, keep


def _moe_local(x: Tensor, params, tape: QTape, *, spec: MoESpec,
               prefix: str, dropless: bool = False) -> Tensor:
    """Per-device MoE math on tokens ``x`` [T, D]; records into ``tape``."""
    E, k = spec.num_experts, spec.top_k
    T, D = x.shape
    C = _capacity(T, spec, dropless)
    eid, gate, pos, keep = route(x, params["router"], spec, C)

    # dispatch: kept slots to their own [E, C] rows, dropped ones to the
    # scratch row C (the reference adds their zeros at row C - 1)
    row = torch.where(keep, pos, C).long()
    xk = x[:, None, :].expand(T, k, D).reshape(T * k, D)
    xe = x.new_zeros((E, C + 1, D))
    xe = xe.index_put((eid, row), xk)[:, :C]
    xe = tape.act(f"{prefix}/dispatch", xe)

    w_gate = tape.weight(f"{prefix}/w_gate", params["w_gate"]).to(x.dtype)
    w_up = tape.weight(f"{prefix}/w_up", params["w_up"]).to(x.dtype)
    w_down = tape.weight(f"{prefix}/w_down", params["w_down"]).to(x.dtype)
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    h = tape.act(f"{prefix}/pre", F.silu(g) * u)
    ye = torch.bmm(h, w_down)
    ye = tape.act(f"{prefix}/expert_out", ye)

    # combine: each token's k weighted outputs, summed in slot order
    pos_c = torch.clamp(pos, max=C - 1).long()
    picked = ye[eid, pos_c] * (gate * keep).to(ye.dtype)[:, None]
    picked = picked.view(T, k, D)
    y = picked[:, 0]
    for j in range(1, k):
        y = y + picked[:, j]
    return y


def moe_ffn(params, spec: MoESpec, x: Tensor, tape: QTape, prefix: str,
            dist=None, dropless: bool = False) -> Tensor:
    """MoE block on ``x`` [B, S, D], statistics recorded into ``tape``;
    with a shared expert, its SwiGLU output is added before the ``out``
    site."""
    if dist is not None and getattr(dist, "active", False):
        raise NotImplementedError(
            "expert parallelism (all_to_all dispatch, FSDP gathers, the "
            "stationary decode) is not ported yet: ROADMAP module item 22")
    B, S, D = x.shape
    y = _moe_local(x.reshape(B * S, D), params, tape, spec=spec,
                   prefix=prefix, dropless=dropless).reshape(B, S, D)
    if spec.shared_expert_d_ff:
        y = y + swiglu(params["shared"], x, tape, f"{prefix}/shared")
    return tape.act(f"{prefix}/out", y)
