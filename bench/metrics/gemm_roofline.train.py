"""The step's matrix products against their roofline: the least time the
card could take for the products a training step needs (the
configuration's own count: forward, input and weight gradients, each
operand read once at the HBM rate or its operations at the TF32 peak,
whichever is longer), over the device time of the GEMM kernels in the
traced steps, found by the name patterns below: the quantized matmul K2
(``qmm_kernel``) and cuBLAS's and CUTLASS's products."""

PATTERNS = ("qmm_kernel", "gemm", "gemv", "xmma", "cutlass", "splitkreduce")


def is_gemm(name: str) -> bool:
    n = name.lower()
    return any(p in n for p in PATTERNS)


def read(run):
    traced = run.get("traced")
    if run.get("kind") != "train" or traced is None or not traced.kernels:
        return None
    device_s = traced.device_seconds(is_gemm)
    if device_s <= 0 or not run.get("traced_ok_steps"):
        return None
    least = run["gemm_least_s_per_step"] * run["traced_ok_steps"]
    return 100.0 * least / device_s
