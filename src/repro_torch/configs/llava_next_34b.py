"""llava-next-34b [vlm] — anyres tiling backbone; patch embeddings stubbed
(input_specs supplies precomputed (B, 576, d_model) patch features)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, num_patches=576,
    flash_remat=False,  # hdim TP: scores carry an AR; recompute would re-run it
)

SMOKE = CONFIG.with_(
    name="llava-next-34b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, num_patches=8,
    param_dtype="float32", activation_dtype="float32", attn_q_chunk=32,
)
