"""Distributed execution: mesh context, sharding rules, low-bit collectives.

The port of ``repro.dist``, on ``torch.distributed`` (one process per
mesh position, see :mod:`repro_torch.launch.mesh`).  Four pieces:

  * :mod:`repro_torch.dist.context`   — ``DistCtx``, the mesh-axis
    contract every model/launch function threads (which axes hold tokens,
    experts, FSDP shards, the context-parallel KV window);
  * :mod:`repro_torch.dist.sharding`  — ``ShardingRules``, logical name →
    partition entries for params, optimizer state, batches, decode
    caches and serve pools;
  * :mod:`repro_torch.dist.compress`  — DFXP gradient/activation
    compression with error feedback for the all-reduce and MoE
    all-to-all wires;
  * :mod:`repro_torch.dist.cp_attention` — context-parallel GQA decode
    attention (KV window sharded, softmax statistics combined exactly).
"""
from .context import (  # noqa: F401
    DistCtx,
    MeshConfigError,
    multi_pod_ctx,
    serve_pod_ctx,
    single_pod_ctx,
)
from .sharding import ShardingRules  # noqa: F401
