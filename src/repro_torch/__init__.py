"""repro_torch — the PyTorch/CUDA port of ``repro``, for NVIDIA Hopper.

The layout mirrors ``repro`` module for module (``core``, ``models``,
``kernels/attn``, ``serve``, ``launch``, ``configs``), so each file here
has one reference file there.  This package imports ``torch`` and numpy
only; the JAX package is its reference in the tests and nowhere else.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``).  On the CPU every kernel wrapper
computes its plain PyTorch version; on the card it launches the
hand-written kernel or raises.

Float32 products run in full float32: TF32 is switched off for both
matmuls and cuDNN here, once, so that every product matches the
reference's f32 accumulation contract to f32 rounding rather than to
TF32's ten mantissa bits.  The quantized matmul kernel (K2) and the
flash-prefill kernel (K4) reach float32 accuracy on the TF32 tensor cores
instead: an operand exact in TF32 (rounded at 12 bits or fewer, or an
int8 mantissa) goes whole, and any other operand is split into two TF32
parts, ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, whose cross products
put each product term within about 2^-22·|a·b| of its float32 value
(``kernels/qmatmul/ops.py``, ``kernels/attn/csrc/flash_prefill.cu``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when no card is present and the CPU was not asked for — a run
    meant for the card never falls back silently.
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return dev
