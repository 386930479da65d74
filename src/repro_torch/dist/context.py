"""DistCtx — the mesh-axis contract threaded through models and launchers.

The port of ``repro.dist.context``.  A ``DistCtx`` names which mesh axes
play which logical role; model code never mentions concrete axis names.
An inactive context (``all_axes=()``, the default) means one process:
every ``dist``-aware code path collapses to plain local math.

Roles:
  * ``token_axes``  — axes the flattened token batch is sharded over
    (data parallel; ``("pod", "data")`` across pods);
  * ``ep_axis``     — expert-parallel axis: MoE expert banks are sharded
    over it and dispatch/combine are ``all_to_all``s along it;
  * ``fsdp_axis``   — parameter-sharding axis: expert weights live sliced
    over it and are all-gathered per layer (training) or kept stationary
    with activations moving instead (``moe_stationary`` decode);
  * ``cp_axis``     — context parallelism: with ``cp_decode`` set (the
    long-context serving cells, the KV window sharded over ``cp_axis``),
    decode attention runs
    :func:`repro_torch.dist.cp_attention.cp_decode_attention` over the
    shards;
  * ``attn_seq_shard`` — shard training attention over the sequence
    instead of heads (for archs whose head counts don't divide the TP
    degree).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


class MeshConfigError(ValueError):
    """An incoherent mesh/parallelism request, rejected at construction.

    Raised by the serve-side factories (``serve_pod_ctx``,
    ``launch.mesh.make_serve_mesh``, ``serve.kv_pool.make_kv_pool``,
    ``ServeEngine``) for combinations that would otherwise surface as a
    late failure inside a collective: a mesh larger than the world, CP
    over a paged arena, a KV window the CP degree does not divide, a
    ``DistCtx`` naming axes the mesh doesn't have.
    """


@dataclasses.dataclass(frozen=True)
class DistCtx:
    token_axes: Tuple[str, ...] = ()
    ep_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    cp_axis: Optional[str] = None
    all_axes: Tuple[str, ...] = ()
    moe_stationary: bool = False
    attn_seq_shard: bool = False
    cp_decode: bool = False        # decode KV window is sharded over cp_axis

    @property
    def active(self) -> bool:
        """Whether a mesh is in play at all (one process ⇔ False)."""
        return bool(self.all_axes)

    @property
    def cp_axes(self) -> Tuple[str, ...]:
        return (self.cp_axis,) if self.cp_axis else ()


def single_pod_ctx() -> DistCtx:
    """16×16 single-pod mesh: ``data`` × ``model`` (see launch/mesh.py)."""
    return DistCtx(token_axes=("data",), ep_axis="model", fsdp_axis="data",
                   cp_axis="data", all_axes=("data", "model"))


def serve_pod_ctx(*, tp: int = 1, cp: int = 1) -> DistCtx:
    """Serving context for a ``make_serve_mesh(tp, cp)`` mesh.

    Serving tensor parallelism shards the **KV pool** over its kv-head
    axis (``model``) while parameters stay replicated, so every
    contraction that could reorder partial sums runs identically on every
    rank and the sharded engine's greedy streams stay bit-identical to one
    process's.  ``cp > 1`` shards the decode KV *window* over ``data``
    instead (long-context slots) and sets ``cp_decode`` so attention runs
    the exact log-sum-exp merge of :mod:`repro_torch.dist.cp_attention`.
    """
    if tp < 1 or cp < 1:
        raise MeshConfigError(f"tp={tp} and cp={cp} must be >= 1")
    axes = tuple(a for a, n in (("data", cp), ("model", tp)) if n > 1)
    return DistCtx(ep_axis="model" if tp > 1 else None,
                   cp_axis="data" if cp > 1 else None,
                   all_axes=axes, cp_decode=cp > 1)


def multi_pod_ctx() -> DistCtx:
    """2×16×16 two-pod mesh: pure-DP ``pod`` axis in front of the pod mesh.

    FSDP stays *within* a pod (``data``) so weight all-gathers never cross
    the slow inter-pod links; only gradient all-reduce does — the wire
    :func:`repro_torch.dist.compress.compress_decompress` narrows to
    low-bit lanes.
    """
    return DistCtx(token_axes=("pod", "data"), ep_axis="model",
                   fsdp_axis="data", cp_axis="data",
                   all_axes=("pod", "data", "model"))
