"""granite-moe-1b-a400m [moe]: 32 experts top-8, every layer MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512,
    # vocab 49155 padded to a multiple of 256 for 16-way vocab TP
    vocab_size=49408, num_experts=32, top_k=8, moe_d_ff=512,
    moe_period=1, rope_theta=1e4, tie_embeddings=True)

SMOKE = ModelConfig(
    name="granite-smoke", family="moe", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=512,
    num_experts=8, top_k=4, moe_d_ff=64, moe_period=1, tie_embeddings=True)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
