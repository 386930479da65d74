"""Fused DFXP quantize with overflow counts — K1 (``ops``), its plain
version (``ref``) and its CUDA source (``csrc/dfxp_quantize.cu``)."""
from .ops import LAUNCHES, dfxp_quantize, reset_launches  # noqa: F401
