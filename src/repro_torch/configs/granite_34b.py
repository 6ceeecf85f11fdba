"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1/MQA) d_ff=24576
vocab=49152 — llama-arch code model, non-gated MLP (GPTBigCode lineage)
[arXiv:2405.04324; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    notes="mlp_nogate",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=512, vocab_size=512)
