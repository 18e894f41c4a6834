"""mamba2-780m [ssm] — arXiv:2405.21060 (SSD). Attention-free."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
)

SMOKE = CONFIG.with_(
    name="mamba2-780m-smoke", num_layers=2, d_model=64,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    param_dtype="float32", activation_dtype="float32",
)
