"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b lineage; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=96, n_heads=4, n_kv_heads=4,
                          head_dim=24, d_ff=256, vocab_size=384)
