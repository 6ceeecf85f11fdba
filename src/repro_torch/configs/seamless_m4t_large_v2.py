"""seamless-m4t-large-v2 [audio enc-dec]: 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].

Backbone only: the audio frontend is a stub (precomputed frame embeddings).
24 encoder + 24 decoder layers, non-gated transformer FFN (fairseq lineage).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    notes="mlp_nogate",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=96, n_heads=4,
                          n_kv_heads=4, head_dim=24, d_ff=256, vocab_size=512)
