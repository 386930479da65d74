"""Numeric formats from the paper (+ beyond-paper float8).

Three arithmetic families (paper §3-§5):
  * ``FloatFormat``   — float with ``exp_bits``/``man_bits`` (fp32 reference,
    fp16/bf16, fp8 beyond-paper). Emulated by value-rounding in f32.
  * ``FixedPoint``    — one *global, never-updated* power-of-two scale.
    Parameterized by total ``width`` (incl. sign) and ``int_bits`` (bits left
    of the radix point; paper Fig.1 optimum: 5 → range ≈ ±32).
  * ``DynamicFixedPoint`` — per-group scales updated online from overflow
    statistics (paper §5). The scale is carried *outside* the format (in
    :class:`repro.core.scale.ScaleState`); the format only fixes the width.

All formats are frozen/hashable, so they key caches and compare by value.

Conventions:
  * A fixed-point grid with log2-step ``e`` represents ``k * 2**e`` for
    integer ``k`` in ``[-2**(width-1), 2**(width-1) - 1]`` (two's-complement,
    like the paper's signed mantissa).
  * "scaling factor × 2" in the paper == ``e + 1`` here (wider range,
    coarser step).
"""
from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """IEEE-like float with given exponent/mantissa widths (sign implied)."""

    name: str
    exp_bits: int
    man_bits: int

    @property
    def width(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def emax(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def emin(self) -> int:
        return 1 - self.emax

    @property
    def maxval(self) -> float:
        return float((2.0 - 2.0 ** (-self.man_bits)) * 2.0 ** self.emax)


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """Static fixed point: global radix position, never updated (paper §4)."""

    width: int          # total bits incl. sign
    int_bits: int = 5   # bits left of the radix point (paper Fig.1: 5)

    @property
    def exp(self) -> int:
        """log2 of the quantization step for this radix position."""
        # width-1 magnitude bits; int_bits of them left of the radix point.
        return self.int_bits - (self.width - 1)

    @property
    def qmax(self) -> int:
        return 2 ** (self.width - 1) - 1


@dataclasses.dataclass(frozen=True)
class DynamicFixedPoint:
    """Dynamic fixed point: width only; scale lives in ScaleState (paper §5)."""

    width: int

    @property
    def qmax(self) -> int:
        return 2 ** (self.width - 1) - 1


@dataclasses.dataclass(frozen=True)
class Observe:
    """Calibration pseudo-format: values pass through untouched; statistics
    record per-group max magnitudes instead of overflow counts. Implements
    the paper's §9.3 "find the initial scaling factors by training with a
    higher precision format"."""


Format = Union[FloatFormat, FixedPoint, DynamicFixedPoint, Observe, None]

# Named float formats (paper Table 1 + beyond-paper fp8).
FLOAT32 = FloatFormat("float32", 8, 23)
FLOAT16 = FloatFormat("float16", 5, 10)
BFLOAT16 = FloatFormat("bfloat16", 8, 7)
FLOAT8_E4M3 = FloatFormat("float8_e4m3", 4, 3)
FLOAT8_E5M2 = FloatFormat("float8_e5m2", 5, 2)

FLOAT_FORMATS = {
    f.name: f for f in (FLOAT32, FLOAT16, BFLOAT16, FLOAT8_E4M3, FLOAT8_E5M2)
}


def container_exact_bits(container: str) -> int:
    """Max DFXP width a float container holds exactly (incl. sign)."""
    return {"float32": 25, "float16": 12, "bfloat16": 9}[container]
