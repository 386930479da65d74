"""The assigned input shapes (4 per architecture) and their stand-ins.

The port of ``repro.configs.shapes``.  ``input_specs`` returns, for one
(arch, shape) cell, every model input as a tensor on the **meta**
device: a shape and a dtype, no data, so a 524,288-slot decode cache
costs nothing.  The reference returns ``jax.ShapeDtypeStruct``s with the
same keys, shapes and dtypes; the dry run
(:mod:`repro_torch.launch.dryrun`) traces against these.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: the port's
    ``ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: T.ModelConfig, shape: ShapeSpec) -> dict:
    """Model-input stand-ins for one cell. For decode shapes this is the
    serve-step input: one new token + a full cache of ``seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.input_mode == "tokens":
            batch["tokens"] = sds((B, S), i32)
        else:
            batch["embeds"] = sds((B, S, cfg.d_model), f32)
            if cfg.mrope_sections:
                batch["positions"] = sds((3, B, S), i32)
        if cfg.encoder_layers:
            batch["src_embeds"] = sds((B, S, cfg.d_model), f32)
        if shape.kind == "train":
            batch["labels"] = sds((B, S), i32)
        return {"batch": batch}
    # decode: cache of seq_len tokens + one new token
    src_len = S if cfg.encoder_layers else 0
    cache = T.init_cache(cfg, B, S, src_len=src_len, device="meta")
    tok = (sds((B,), i32) if cfg.input_mode == "tokens"
           else sds((B, 1, cfg.d_model), f32))
    return {"cache": cache, "tokens": tok, "pos": sds((), i32)}
