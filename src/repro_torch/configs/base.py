"""Config dataclasses of the model zoo, a copy of ``repro/configs/base.py``.

Every architecture has a ``ModelConfig`` in ``configs/<id>.py`` with its
exact published dimensions, plus a ``smoke()`` variant for CPU tests (same
family and topology, tiny dims). The family extensions (MoE, SSM, MLA) are
plain fields here: ``models/model_zoo`` routes every family.
``TrainConfig``, ``ShapeCell`` and ``SHAPE_CELLS`` are the reference's,
field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Family = Literal["dense", "encdec", "vlm", "hybrid", "ssm", "moe"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    moe_every: int = 1            # MoE layer every N layers (1 = all layers)
    first_dense: int = 0          # leading dense layers (deepseek-v2 style)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSD head size P
    chunk: int = 128              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int = 0          # 0 = full-rank q projection


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0       # 0 = full attention
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid (zamba2-style): shared attention block every N ssm blocks
    shared_attn_every: int = 0
    # enc-dec
    n_enc_layers: int = 0         # when family == "encdec", n_layers = decoder
    # vlm / audio stub frontends: number of prefix embedding positions
    n_prefix_tokens: int = 0
    # which attention layout the arch supports for >= 500k decode
    subquadratic: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to a multiple of 128, as in the
        reference. Logits come at the padded size; labels and generated
        tokens always index < vocab_size."""
        return ((self.vocab_size + 127) // 128) * 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell for the dry-run grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_CELLS: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    microbatch: int = 0           # 0 = no microbatching (single shot)
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    param_dtype: str = "float32"  # smoke tests use f32; prod bf16+f32 master
    compute_dtype: str = "bfloat16"
    remat: Literal["none", "dots", "full"] = "full"
    z_loss: float = 1e-4
    gradient_compression: bool = False
    seed: int = 0
