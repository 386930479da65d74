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

Expert parallelism (the reference's ``shard_map`` island, written out
SPMD over :mod:`repro_torch.launch.mesh`): tokens sharded over
``dist.token_axes``, the banks' experts over ``dist.ep_axis`` and their
``D`` over ``dist.fsdp_axis`` (views), dispatch and combine as tiled
``all_to_all``s (plain, or in ``policy.a2a_compress_bits`` integer lanes
through :func:`repro_torch.dist.compress.compressed_all_to_all`), the
FSDP banks all-gathered per layer, or kept in place by the
``moe_stationary`` decode.  The collectives other than the compressed
``all_to_all`` carry no gradient: expert-parallel blocks run forward
(serving) and raise under autograd; training keeps one process.
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


def capacity(t_local: int, spec: MoESpec, dropless: bool = False) -> int:
    """Slots per expert for ``t_local`` tokens: ``ceil(T·k/E · cf)``, or
    ``T`` when ``dropless``."""
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
               prefix: str, dropless: bool = False, dist=None,
               mesh=None) -> Tensor:
    """Per-rank MoE math on tokens ``x`` [T, D]; records into ``tape``.

    ``params`` holds this rank's expert banks: the whole banks without
    expert parallelism, else views of its ``E/ep`` experts (and, with
    FSDP, its slice of ``D``).  With ``dist.ep_axis`` the dispatched
    slots cross an ``all_to_all`` to their experts' owners and back
    (in ``a2a_compress_bits`` integer lanes when the policy asks)."""
    E, k = spec.num_experts, spec.top_k
    T, D = x.shape
    C = capacity(T, spec, dropless)
    eid, gate, pos, keep = route(x, params["router"], spec, C)
    ep = dist.ep_axis if dist is not None else None
    fsdp = dist.fsdp_axis if dist is not None else None
    a2a_bits = getattr(tape.policy, "a2a_compress_bits", 0)

    # dispatch: kept slots to their own [E, C] rows, dropped ones to the
    # scratch row C (the reference adds their zeros at row C - 1)
    row = torch.where(keep, pos, C).long()
    xk = x[:, None, :].expand(T, k, D).reshape(T * k, D)
    xe = x.new_zeros((E, C + 1, D))
    xe = xe.index_put((eid, row), xk)[:, :C]
    xe = tape.act(f"{prefix}/dispatch", xe)
    if ep:
        xe = _all_to_all(xe, tape, f"a:{prefix}/dispatch", a2a_bits, ep,
                         0, 1, mesh)                        # [E/ep, C·ep, D]

    stationary = bool(dist is not None and dist.moe_stationary and fsdp
                      and dropless)
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    if fsdp and not stationary:
        # training: gather the FSDP-sliced banks per layer
        w_gate = mesh.all_gather(w_gate, fsdp, dim=1)
        w_up = mesh.all_gather(w_up, fsdp, dim=1)
        w_down = mesh.all_gather(w_down, fsdp, dim=2)
    w_gate = tape.weight(f"{prefix}/w_gate", w_gate).to(x.dtype)
    w_up = tape.weight(f"{prefix}/w_up", w_up).to(x.dtype)
    w_down = tape.weight(f"{prefix}/w_down", w_down).to(x.dtype)
    if stationary:
        # decode: the banks stay put and the activations move — each
        # fsdp rank holds a D-slice: partial products + psum, then the
        # D-sharded down-projection output is all-gathered
        Dl = w_gate.shape[1]
        d0 = mesh.axis_index(fsdp) * Dl
        xe_l = xe[:, :, d0:d0 + Dl]
        g = mesh.psum(torch.bmm(xe_l, w_gate), fsdp)
        u = mesh.psum(torch.bmm(xe_l, w_up), fsdp)
        h = tape.act(f"{prefix}/pre", F.silu(g) * u)
        ye = mesh.all_gather(torch.bmm(h, w_down), fsdp, dim=2)
    else:
        g = torch.bmm(xe, w_gate)
        u = torch.bmm(xe, w_up)
        h = tape.act(f"{prefix}/pre", F.silu(g) * u)
        ye = torch.bmm(h, w_down)
    if ep:
        ye = _all_to_all(ye, tape, f"a:{prefix}/expert_out", a2a_bits, ep,
                         1, 0, mesh)                        # [E, C, D]
    ye = tape.act(f"{prefix}/expert_out", ye)

    # combine: each token's k weighted outputs, summed in slot order
    pos_c = torch.clamp(pos, max=C - 1).long()
    picked = ye[eid, pos_c] * (gate * keep).to(ye.dtype)[:, None]
    picked = picked.view(T, k, D)
    y = picked[:, 0]
    for j in range(1, k):
        y = y + picked[:, j]
    return y


def _all_to_all(x: Tensor, tape: QTape, group: str, bits: int, axis,
                split: int, concat: int, mesh) -> Tensor:
    """The EP wire: a plain tiled ``all_to_all``, or with ``bits`` one in
    integer lanes at the site's activation exponent."""
    if bits:
        from repro_torch.dist.compress import compressed_all_to_all
        return compressed_all_to_all(x, tape._exp(group), bits, axis,
                                     split_axis=split, concat_axis=concat,
                                     mesh=mesh)
    return mesh.all_to_all(x, axis, split, concat)


def _bank_slices(params, dist, mesh) -> dict:
    """This rank's views of the expert banks: experts ``[E/ep]`` over
    ``ep_axis``, ``D`` over ``fsdp_axis`` (``w_gate``/``w_up`` dim 1,
    ``w_down`` dim 2); the router whole."""
    out = {"router": params["router"]}
    for name, fdim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        w = params[name]
        for axis, dim in ((dist.ep_axis, 0), (dist.fsdp_axis, fdim)):
            if axis:
                n = w.shape[dim] // mesh.axis_size(axis)
                w = w.narrow(dim, mesh.axis_index(axis) * n, n)
        out[name] = w
    return out


def _tensors(tree):
    if isinstance(tree, Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def moe_ffn(params, spec: MoESpec, x: Tensor, tape: QTape, prefix: str,
            dist=None, dropless: bool = False) -> Tensor:
    """MoE block on ``x`` [B, S, D], statistics recorded into ``tape``;
    with a shared expert, its SwiGLU output is added before the ``out``
    site.

    With an active ``dist`` (under the ambient mesh) the block is the
    reference's ``shard_map`` island written out: each rank takes its
    shard of the flattened tokens over ``dist.token_axes``, routes it,
    runs its experts (views of the banks) behind the ``all_to_all``s,
    and the token shards are gathered back whole; the block's statistics
    are summed over ``dist.all_axes`` before they reach ``tape``."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    if dist is not None and dist.active:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors({"x": x, **params})):
            raise NotImplementedError(
                "expert-parallel MoE has no backward: its all_gather, "
                "all_to_all and psum carry no gradient, so the sharded "
                "banks, the router and x would get none (run it under "
                "torch.no_grad(); training keeps one process)")
        from repro_torch.launch.mesh import ambient_mesh
        mesh = ambient_mesh()
        if mesh is None:
            raise ValueError("an active DistCtx needs the ambient mesh "
                             "(launch.mesh.use_mesh)")
        tok = tuple(dist.token_axes)
        if tok:
            n = B * S // mesh.axis_size(tok)
            x_flat = x_flat[mesh.axis_index(tok) * n:][:n]
        local = QTape(tape.policy, tape.scales, tape.sinks)
        y = _moe_local(x_flat, _bank_slices(params, dist, mesh), local,
                       spec=spec, prefix=prefix, dropless=dropless,
                       dist=dist, mesh=mesh)
        if tok:
            y = mesh.all_gather(y, tok, dim=0)
        for name, st in local.stats.items():
            tape._record(name, mesh.psum(st, dist.all_axes))
    else:
        y = _moe_local(x_flat, params, tape, spec=spec, prefix=prefix,
                       dropless=dropless)
    y = y.reshape(B, S, D)
    if spec.shared_expert_d_ff:
        y = y + swiglu(params["shared"], x, tape, f"{prefix}/shared")
    return tape.act(f"{prefix}/out", y)
