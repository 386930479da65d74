"""Attention over the KV pool: flash-decode (K3) and flash-prefill (K4) on
slot-major rings, and their paged variants (K5, K6) through block tables.

``ops`` holds the wrappers, ``ref`` the plain PyTorch versions, ``csrc``
the CUDA sources; :mod:`repro_torch.kernels.build` builds and loads them.
"""
from .ops import (  # noqa: F401
    LAUNCHES,
    flash_decode,
    flash_decode_paged,
    flash_prefill,
    flash_prefill_paged,
    reset_launches,
)
from .ref import decode_attention_ref, prefill_attention_ref  # noqa: F401
