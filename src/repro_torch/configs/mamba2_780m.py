"""mamba2-780m [ssm]: 48L d_model=1536 attention-free, ssm_state=128 — SSD
(state-space duality) [arXiv:2405.21060; unverified]. Runs long_500k."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, vocab_size=384,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16))
