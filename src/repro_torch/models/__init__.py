"""Model definitions of the port: the token-in decoder families (dense,
MoE, SSM and hybrid), the encoder-decoder and the embeds-input models in
``transformer`` over ``layers``, ``moe`` and ``ssm``, and the paper's
maxout networks in ``maxout``."""
from . import layers, maxout, moe, ssm, transformer  # noqa: F401
from .transformer import ModelConfig, build_stages, group_shapes  # noqa: F401
