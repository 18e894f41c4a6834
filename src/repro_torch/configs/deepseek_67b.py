"""deepseek-67b [dense] — arXiv:2401.02954. Llama-arch, 95L, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
)

SMOKE = CONFIG.with_(
    name="deepseek-67b-smoke", num_layers=3, d_model=64, num_heads=8,
    num_kv_heads=2, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
