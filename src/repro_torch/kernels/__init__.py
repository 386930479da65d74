"""Hand-written Hopper kernels of the port and their plain versions.

``attn`` (K3-K6), ``dfxp`` (K1, fused quantize) and ``qmatmul`` (K2,
quantized matmul) each hold ``ops`` (wrappers with launch counters),
``ref`` (plain PyTorch versions) and ``csrc`` (CUDA sources);
``build`` compiles every ``csrc`` with ``nvcc`` and loads it with
``ctypes``; ``dispatch`` is the differentiable fused matmul on K2.
"""
