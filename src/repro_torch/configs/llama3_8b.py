"""llama3-8b [dense]: GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=128256, rope_theta=5e5, tie_embeddings=False)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    tie_embeddings=False)

# pure full attention -> long_500k skipped
CELLS = ("train_4k", "prefill_32k", "decode_32k")
