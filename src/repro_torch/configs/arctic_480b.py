"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base.

128 experts top-2 with a parallel dense residual MLP per layer."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, num_experts_per_token=2, moe_dense_ff=4864,
    dp_boundary="pod",
    flash_remat=False,  # hdim TP: scores carry an AR; recompute would re-run it
)

SMOKE = CONFIG.with_(
    name="arctic-480b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512,
    num_experts=4, num_experts_per_token=2, moe_dense_ff=64, moe_group_size=64,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
