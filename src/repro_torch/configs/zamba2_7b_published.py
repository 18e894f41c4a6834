"""zamba2-7b-published [zamba2] — Zyphra/Zamba2-7B-Instruct's config.json at
its published sizes: 81 layers (68 mamba, 13 hybrid at ``hybrid_layer_ids``),
d_model 3,584, two shared blocks of 32 heads of 224 over the 7,168-wide
concatenation, an exact gated gelu MLP of 14,336 with rank-128 adapters,
Mamba2 of d_state 64, head_dim 64, expand 2 and 2 B/C groups, chunks of
256, tied head. The port's own config (family ``zamba2``,
``models/zamba2.py``), beside the reference's list: the reference's
``zamba2-7b`` (family ``hybrid``) is its simplification."""
from repro_torch.configs.base import ModelConfig

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ModelConfig(
    name="zamba2-7b-published", family="zamba2",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=224,
    d_ff=14336, vocab_size=32000, mlp="gelu_erf",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, ssm_groups=2,
    ssm_conv_width=4, rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=True,
    hybrid_layer_ids=HYBRID_LAYER_IDS, num_mem_blocks=2, adapter_rank=128,
)

# two shared blocks over three applications at irregular layers, 2 B/C
# groups, head_dim = 2 d / heads and the (hd / 2)^-0.5 scale, as published
SMOKE = CONFIG.with_(
    name="zamba2-7b-published-smoke", num_layers=6, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16, hybrid_layer_ids=(1, 2, 4),
    adapter_rank=8, param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
