"""seamless-m4t-medium [audio]: enc-dec backbone; audio frontend is a stub
(the batch carries precomputed frame embeddings, ``src_embeds``). [arXiv:2308.11596]

Simplification (documented): RoPE positions instead of the original
sinusoidal/relative scheme.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    encoder_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=256256, ffn_kind="gelu",  # 256206 padded to %256 for vocab TP
    rope_theta=1e4, tie_embeddings=False)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec", num_layers=3, encoder_layers=2,
    d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
    vocab_size=512, ffn_kind="gelu", tie_embeddings=False)

# full attention -> long_500k skipped; decode runs (it has a decoder stack)
CELLS = ("train_4k", "prefill_32k", "decode_32k")
