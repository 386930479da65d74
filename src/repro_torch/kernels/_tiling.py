"""Padding helpers shared by the kernel wrappers.

The reference pads every operand up to its TPU block multiples
(``repro.kernels._tiling``); the port's CUDA kernels mask their ragged
edges by index instead, so only the two helpers remain.  The port picks
its own tiles inside each kernel; the reference's TPU block heuristics
and its autotune cache are not carried over (ROADMAP).
"""
from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad2d(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to ``(rows, cols)``; no-op when already there."""
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    if pr or pc:
        return torch.nn.functional.pad(x, (0, pc, 0, pr))
    return x
