"""whisper-medium [audio] — arXiv:2212.04356. Enc-dec; conv frontend stubbed
(the batch supplies precomputed (B, 1500, d_model) frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, mlp="gelu",
    is_encoder_decoder=True, num_encoder_layers=24, num_frames=1500,
)

SMOKE = CONFIG.with_(
    name="whisper-medium-smoke", num_layers=2, num_encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    num_frames=24,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
