"""mamba2-370m [ssm]: attention-free SSD. [arXiv:2405.21060]"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50432,  # 50280 padded to %256 for vocab TP
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", num_layers=4, d_model=128,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssm_chunk=16, tie_embeddings=True)

# attention-free: long_500k runs
CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
