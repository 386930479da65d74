"""Core of the paper: numeric formats, quantizers, DFXP scale control."""
from .formats import (  # noqa: F401
    BFLOAT16,
    FLOAT8_E4M3,
    FLOAT8_E5M2,
    FLOAT16,
    FLOAT32,
    FLOAT_FORMATS,
    DynamicFixedPoint,
    FixedPoint,
    FloatFormat,
    Format,
    container_exact_bits,
)
from .packed import PackedArray, pack, pack_rows  # noqa: F401
from .policy import (  # noqa: F401
    DFXP_10_12,
    FIXED_20,
    HALF_FLOAT,
    SINGLE_FLOAT,
    PrecisionPolicy,
)
from .quant import (  # noqa: F401
    enable_pallas_quantize,
    exact_pow2,
    fixed_round,
    float_round,
    q_stats,
    q_value,
    new_sink,
    qbound,
    ste_quant,
)
from .scale import ScaleState, accumulate, calibrate_exp, controller_step  # noqa: F401
from .tape import QTape, tensor_class  # noqa: F401
