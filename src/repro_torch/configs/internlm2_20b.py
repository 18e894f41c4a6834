"""internlm2-20b [dense] — arXiv:2403.17297. GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, rope_theta=1e6,
)

SMOKE = CONFIG.with_(
    name="internlm2-20b-smoke", num_layers=2, d_model=64, num_heads=8,
    num_kv_heads=2, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
