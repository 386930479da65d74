"""Quantized matmul with per-operand DFXP rounding fused into the tile
loads — K2 (``ops``), its plain version (``ref``) and its CUDA source
(``csrc/qmatmul.cu``)."""
from .ops import LAUNCHES, qmatmul, qmm, reset_launches  # noqa: F401
