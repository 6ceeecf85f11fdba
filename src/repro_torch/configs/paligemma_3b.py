"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1/MQA, head_dim 256)
d_ff=16384 vocab=257216 — SigLIP frontend STUBBED as 256 precomputed patch
embeddings; gemma-style decoder with prefix-LM masking [arXiv:2407.07726; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    n_prefix_tokens=256, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=96, n_heads=4, n_kv_heads=1,
                          head_dim=24, d_ff=256, vocab_size=512,
                          n_prefix_tokens=16)
