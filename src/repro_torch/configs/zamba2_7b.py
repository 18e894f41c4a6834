"""zamba2-7b [hybrid] — arXiv:2411.15242. Mamba2 backbone + shared attention
block applied every 6 layers (13 applications, 3 tail mamba layers)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_chunk=256, hybrid_attn_every=6,
)

SMOKE = CONFIG.with_(
    name="zamba2-7b-smoke", num_layers=7, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16, hybrid_attn_every=3,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
