"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048 — 128 routed experts top-1 + 1 shared expert,
MoE every other layer (interleaved), early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E lineage; unverified]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    moe=MoEConfig(n_experts=128, n_shared_experts=1, top_k=1,
                  d_ff_expert=8192, moe_every=2, first_dense=0),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24,
        d_ff=256, vocab_size=512,
        moe=MoEConfig(n_experts=8, n_shared_experts=1, top_k=1,
                      d_ff_expert=256, moe_every=2, first_dense=0,
                      capacity_factor=8.0))  # no drops at smoke scale
