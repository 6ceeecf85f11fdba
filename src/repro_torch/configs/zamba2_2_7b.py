"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d_model=2560 ssm_state=64 + shared
attention block (32H) applied every 6 SSM blocks [arXiv:2411.15242; hf].
Sub-quadratic (SSM backbone) -> runs long_500k."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attn_every=6, subquadratic=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=384,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        shared_attn_every=2)
