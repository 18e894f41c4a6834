"""Model / run configuration dataclasses and the assigned input shapes (a copy
of the reference's repro/configs/base.py; the port keeps its own)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio (the port adds zamba2)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu (tanh) | gelu_erf (exact; the port's zamba2)

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_dense_ff: int = 0  # arctic-style parallel dense residual FFN
    capacity_factor: float = 1.25
    moe_group_size: int = 512  # tokens per dispatch group

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1  # B/C groups
    ssm_conv_width: int = 4

    # --- hybrid (zamba2): shared attention block applied every k ssm layers ---
    hybrid_attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_frames: int = 1500  # stub conv-frontend output length (encoder input)

    # --- vlm (llava): stub patch-embedding prefix ---
    num_patches: int = 0

    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    remat: str = "full"  # none | full | dots
    tie_embeddings: bool = False
    attn_q_chunk: int = 2048  # flash-style q/kv chunking granularity

    # --- distribution ---
    dp_boundary: str = "replica"  # replica: FPISA over (pod,data); pod: over pod only
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    accum_steps: int = 1  # gradient-accumulation microbatches per step
    seq_parallel: bool = False  # Megatron-style SP: shard seq over 'model' between TP blocks
    flash_remat: bool = True  # remat the attention pair-step (recompute scores in bwd);
    # keep OFF for hdim-TP archs whose scores carry an all-reduce (it would re-run it)

    # --- zamba2 (the published Zamba2 hybrid; the port's own fields, after the
    # reference's, whose defaults leave every reference config as it is) ---
    hybrid_layer_ids: tuple = ()  # layers that apply a shared block before their mamba block
    num_mem_blocks: int = 0  # shared blocks, applied in turn (application j: block j mod n)
    adapter_rank: int = 0  # rank of each application's gate/up adapter

    def __post_init__(self):
        # a list from a JSON file becomes a tuple: the config stays hashable
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic attention: run only for SSM/hybrid archs.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True
