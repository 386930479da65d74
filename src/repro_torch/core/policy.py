"""Precision policy: which arithmetic, which widths, which container (paper §6).

The paper's headline configuration is ``dfxp`` with ``comp_width=10`` (all
computations: activations, weighted sums, and every gradient) and
``update_width=12`` (parameter storage).  ``fixed`` reproduces §4 (global
radix point after the ``fixed_int_bits``-th MSB), the float names
reproduce §3.

The serving and training fields, with the reference's meaning, defaults
and validation (``repro.core.policy``); the distributed fields
(``grad_compress_bits``, ``a2a_compress_bits``) join with the slice that
ports ``repro.dist``.
"""
from __future__ import annotations

import dataclasses

from .formats import (
    BFLOAT16,
    FLOAT8_E4M3,
    FLOAT8_E5M2,
    FLOAT16,
    FLOAT32,
    DynamicFixedPoint,
    FixedPoint,
    Format,
    Observe,
    container_exact_bits,
)

_FLOATS = {
    "float32": FLOAT32,
    "float16": FLOAT16,
    "bfloat16": BFLOAT16,
    "float8_e4m3": FLOAT8_E4M3,
    "float8_e5m2": FLOAT8_E5M2,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    arithmetic: str = "float32"      # float32|bfloat16|float16|float8_*|fixed|dfxp
    comp_width: int = 10             # paper: 10 (computations)
    update_width: int = 12           # paper: 12 (parameter updates)
    fixed_int_bits: int = 5          # paper Fig.1: radix after 5th MSB
    max_overflow_rate: float = 1e-4  # paper: 0.01%
    update_interval: int = 100       # controller cadence, in steps
    stochastic_rounding: bool = False   # beyond-paper (param updates only)
    quantize_momentum: bool = True
    storage: str = "sim"             # sim|packed
    compute_dtype: str = "float32"   # container dtype for activations/compute
    fused_matmul: bool = False       # route DFXP QTape.dot through the
    #   hand-written quantized matmul K2 (forward nn, dgrad nt, wgrad tn;
    #   repro_torch.kernels.dispatch)
    fused_decode: bool = False       # serve: hand-written flash-decode and
    #   flash-prefill kernels on the KV pool's storage (CLI --fused-decode)
    prefill_chunk: int = 0           # serve: chunked prefill size C; 0 =
    #   whole-prompt prefill (CLI --prefill-chunk)
    page_size: int = 0               # serve: paged KV pool page size P; 0 =
    #   slot-major rings.  P > 0 stores fixed-size pages behind per-request
    #   block tables (serve/paged.py) and forces chunked prefill, C
    #   defaulting to P (CLI --page-size)

    def __post_init__(self):
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.page_size < 0:
            raise ValueError("page_size must be >= 0")
        if self.arithmetic not in (*_FLOATS, "fixed", "dfxp", "observe"):
            raise ValueError(f"unknown arithmetic {self.arithmetic!r}")
        if self.storage not in ("sim", "packed"):
            raise ValueError(f"unknown storage {self.storage!r}")
        if self.storage == "packed" and self.arithmetic == "dfxp":
            exact = container_exact_bits(self.compute_dtype)
            if self.comp_width > exact:
                raise ValueError(
                    f"comp_width={self.comp_width} not exactly representable "
                    f"in {self.compute_dtype} containers (max {exact})")

    # -- format accessors ---------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.arithmetic != "float32"

    @property
    def dynamic(self) -> bool:
        return self.arithmetic == "dfxp"

    @property
    def observing(self) -> bool:
        return self.arithmetic == "observe"

    def comp_format(self) -> Format:
        """Format for activations, weighted sums, and all gradients."""
        if self.arithmetic == "observe":
            return Observe()
        if self.arithmetic in _FLOATS:
            f = _FLOATS[self.arithmetic]
            return None if f.name == "float32" else f
        if self.arithmetic == "fixed":
            return FixedPoint(self.comp_width, self.fixed_int_bits)
        return DynamicFixedPoint(self.comp_width)

    def update_format(self) -> Format:
        """Format for parameter (and momentum) storage."""
        if self.arithmetic == "observe":
            return Observe()
        if self.arithmetic in _FLOATS:
            f = _FLOATS[self.arithmetic]
            return None if f.name == "float32" else f
        if self.arithmetic == "fixed":
            return FixedPoint(self.update_width, self.fixed_int_bits)
        return DynamicFixedPoint(self.update_width)


# Paper's headline policies (Table 3 rows).
SINGLE_FLOAT = PrecisionPolicy("float32")
HALF_FLOAT = PrecisionPolicy("float16")
FIXED_20 = PrecisionPolicy("fixed", comp_width=20, update_width=20)
DFXP_10_12 = PrecisionPolicy("dfxp", comp_width=10, update_width=12)
