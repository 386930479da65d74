"""Architecture registry of the port.

``get(name)`` → full ModelConfig; ``get_smoke(name)`` → reduced
same-family config for CPU tests.  The port has the dense decoder
family; the reference's other architectures join this registry with the
slices that port their blocks (ROADMAP module item 21).  As in the
reference's ``importlib`` lookup, a module registered in ``sys.modules``
as ``repro_torch.configs.<name>`` (with ``CONFIG`` and ``SMOKE``) is an
arch too: the LM example registers its inline LM_100M so.
"""
from __future__ import annotations

import importlib
import sys

from repro_torch.models.transformer import ModelConfig

ARCHS = ("llama3_8b",)

_ALIASES = {
    "llama3-8b": "llama3_8b",
}


def _module(name: str):
    key = _ALIASES.get(name, name)
    registered = sys.modules.get(f"repro_torch.configs.{key}")
    if registered is not None:
        return registered
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}: the port has {ARCHS}; "
                         f"the other families come with ROADMAP module "
                         f"item 21")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
