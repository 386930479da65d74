"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A DFXP operand
of at most 12 bits is exact in TF32, so TF32 is the rate a DFXP product
could reach on this card (float32 outside the tensor cores: 67e12)."""

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for a product: the larger of
    its operations at the TF32 peak and its bytes at the HBM rate."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def product(m: int, k: int, n: int, count: int = 1, elem: int = 4) -> tuple:
    """``(flops, bytes)`` of ``count`` products ``[m, k] x [k, n]``: each
    operand read once and the result written once."""
    return (2.0 * m * k * n * count,
            float(elem) * (m * k + k * n + m * n) * count)
