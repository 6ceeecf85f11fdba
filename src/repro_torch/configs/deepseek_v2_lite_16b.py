"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (kv=16) vocab=102400 —
MLA kv_lora=512, first layer dense (d_ff=10944), 26 MoE layers with 2 shared
+ 64 routed experts (d_ff_expert=1408) top-6 [arXiv:2405.04434; hf].

Note: the assignment header lists "MoE 64e top-6" and the note "160 routed"
(the 236B V2's count); we implement the Lite variant: 64 routed experts.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6,
                  d_ff_expert=1408, moe_every=1, first_dense=1),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=256, vocab_size=512,
        moe=MoEConfig(n_experts=8, n_shared_experts=1, top_k=2,
                      d_ff_expert=64, moe_every=1, first_dense=1,
                      capacity_factor=8.0),  # no drops at smoke scale
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=24,
                      v_head_dim=24))
