"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 (paper-table)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    num_experts=384, num_experts_per_token=8,
    dp_boundary="pod",
)

SMOKE = CONFIG.with_(
    name="kimi-k2-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=64, vocab_size=512,
    num_experts=8, num_experts_per_token=2, moe_group_size=64,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
