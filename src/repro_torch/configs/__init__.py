"""Architecture registry of the port.

``get(name)`` → full ModelConfig; ``get_smoke(name)`` → reduced
same-family config for CPU tests.  The port serves the dense decoder
family; the reference's other architectures join this registry with the
slices that port their blocks (ROADMAP module item 21).
"""
from __future__ import annotations

import importlib

from repro_torch.models.transformer import ModelConfig

ARCHS = ("llama3_8b",)

_ALIASES = {
    "llama3-8b": "llama3_8b",
}


def _module(name: str):
    key = _ALIASES.get(name, name)
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r} (the port has {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
