"""qwen3-14b [dense]: qk_norm, GQA. [hf:Qwen/Qwen3-14B]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17408,
    vocab_size=151936, qk_norm=True, rope_theta=1e6, tie_embeddings=False)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    qk_norm=True, tie_embeddings=False)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
