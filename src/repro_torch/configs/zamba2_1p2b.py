"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38 mamba2 layers, d_model 2048, shared attn (32H, kv=32) + shared FFN every
6 mamba blocks (weights stored once — zamba's parameter-sharing trick),
ssm_state 64. [arXiv:2411.15242; hf]
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_period=6, rope_theta=1e4, tie_embeddings=True)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", num_layers=8, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssm_chunk=16, hybrid_period=3,
    tie_embeddings=True)

# sub-quadratic (SSM + shared attn): long_500k runs
CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
