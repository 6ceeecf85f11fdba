"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936 —
QKV bias enabled [hf:Qwen/Qwen1.5-0.5B lineage; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936, head_dim=128,
    qkv_bias=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=96, n_heads=4, n_kv_heads=4,
                          head_dim=24, d_ff=256, vocab_size=512)
