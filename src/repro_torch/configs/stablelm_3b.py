"""stablelm-3b [dense] — hf:stabilityai/stablelm-2 family."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
)

SMOKE = CONFIG.with_(
    name="stablelm-3b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
