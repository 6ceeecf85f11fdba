"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention (window 4096)
[arXiv:2401.16818; unverified]. SWA makes it sub-quadratic -> runs long_500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    sliding_window=4096, subquadratic=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=96, n_heads=4, n_kv_heads=2,
                          head_dim=24, d_ff=256, vocab_size=384,
                          sliding_window=16)
