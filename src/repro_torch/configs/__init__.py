"""Architecture registry of the port: the reference's ten architectures.

``get(name)`` → full ModelConfig; ``get_smoke(name)`` → reduced
same-family config for CPU tests; ``cells(name)`` → the runnable shape
cells of :mod:`repro_torch.configs.shapes` (the reference's skips, noted
in each config file).  Each ``CONFIG`` and ``SMOKE`` is
copied field for field from ``repro.configs``: dense (llama3, qwen3 with
qk-norm, phi3), gemma3 (5:1 local:global windows, qk-norm, embed
scale), MoE (granite, llama4 with its shared expert), SSM (mamba2),
hybrid (zamba2's shared attention), the encoder-decoder
seamless-m4t-medium (cross-attention over ``src_embeds``) and the
embeds-input qwen2-vl-72b (M-RoPE); ``CELLS`` too.  As in the
reference's ``importlib``
lookup, a module registered in ``sys.modules`` as
``repro_torch.configs.<name>`` (with ``CONFIG`` and ``SMOKE``) is an
arch too: the LM example registers its inline LM_100M so.
"""
from __future__ import annotations

import importlib
import sys
from typing import Dict, Tuple

from repro_torch.models.transformer import ModelConfig

from .shapes import SHAPES, ShapeSpec, input_specs  # noqa: F401

ARCHS = (
    "zamba2_1p2b",
    "llama3_8b",
    "qwen3_14b",
    "phi3_medium_14b",
    "gemma3_27b",
    "seamless_m4t_medium",
    "llama4_maverick_400b",
    "granite_moe_1b",
    "mamba2_370m",
    "qwen2_vl_72b",
)

_ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "llama3-8b": "llama3_8b",
    "qwen3-14b": "qwen3_14b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-27b": "gemma3_27b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "llama4-maverick-400b": "llama4_maverick_400b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-moe-1b": "granite_moe_1b",
    "mamba2-370m": "mamba2_370m",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def _module(name: str):
    key = _ALIASES.get(name, name)
    registered = sys.modules.get(f"repro_torch.configs.{key}")
    if registered is not None:
        return registered
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}: the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def cells(name: str) -> Tuple[str, ...]:
    return _module(name).CELLS


def all_cells() -> Dict[str, Tuple[str, ...]]:
    return {a: cells(a) for a in ARCHS}
