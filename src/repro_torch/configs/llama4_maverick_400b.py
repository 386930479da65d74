"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, shared expert,
MoE every 2nd layer (interleaved dense FFN), early-fusion backbone.
[hf:meta-llama/Llama-4-Maverick-17B-128E]

At 400B parameters it fits no single card; the port serves and trains its
smoke config (the reference keeps it in packed int16 storage on a pod).
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b", family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192,
    vocab_size=202048, num_experts=128, top_k=1, moe_d_ff=8192,
    moe_period=2, shared_expert=True, rope_theta=5e5, tie_embeddings=False)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    num_experts=8, top_k=1, moe_d_ff=64, moe_period=2, shared_expert=True,
    tie_embeddings=False)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
