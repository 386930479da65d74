"""Attention over the KV pool: flash-decode (K3) and flash-prefill (K4).

``ops`` holds the wrappers, ``ref`` the plain PyTorch versions, ``build``
the nvcc/ctypes loader, ``csrc`` the CUDA sources.
"""
from .ops import LAUNCHES, flash_decode, flash_prefill, reset_launches  # noqa: F401
