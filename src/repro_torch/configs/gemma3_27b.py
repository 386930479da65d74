"""gemma3-27b [dense]: 5:1 local:global attention, 262k vocab.

Local layers: sliding window 1024, rope theta 10k; every 6th layer global
(theta 1M). 62 layers = 10 full (5L+1G) super-blocks + 2 trailing local.
[hf:google/gemma-3-27b-pt]
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", num_layers=62, d_model=5376,
    num_heads=32, num_kv_heads=16, head_dim=128, d_ff=21504,
    vocab_size=262144, window=1024, local_global_pattern=5,
    local_rope_theta=1e4, rope_theta=1e6, embed_scale=True,
    qk_norm=True, tie_embeddings=True)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense", num_layers=7, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    window=16, local_global_pattern=2, local_rope_theta=1e4,
    embed_scale=True, qk_norm=True, tie_embeddings=True)

# 5/6 layers sub-quadratic (window cache); global layers decode O(S) with a
# sequence-sharded cache -> long_500k runs
CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
