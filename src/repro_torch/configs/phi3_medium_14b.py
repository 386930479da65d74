"""phi3-medium-14b [dense]: RoPE SwiGLU GQA kv=10. [arXiv:2404.14219]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=10, head_dim=128, d_ff=17920,
    vocab_size=100352, rope_theta=1e4, tie_embeddings=False)

SMOKE = ModelConfig(
    name="phi3-smoke", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    tie_embeddings=False)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
