"""qwen2-vl-72b [vlm]: backbone only; patch embeddings are stub inputs
(the batch carries precomputed mixed ``embeds`` and M-RoPE position ids).
[arXiv:2409.12191]
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
    vocab_size=152064, input_mode="embeds", mrope_sections=(16, 24, 24),
    rope_theta=1e6, tie_embeddings=False)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    input_mode="embeds", mrope_sections=(4, 6, 6), tie_embeddings=False)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
