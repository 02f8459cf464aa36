"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision frontend stubbed).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191; hf]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (batch, patches, d_model) plus their positions;
text+vision positions drive 3-section M-RoPE (temporal/height/width).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    attention="full",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # halves of head_dim: 16+24+24 = 64
    use_qkv_bias=True,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    frontend="vision_stub",
    frontend_tokens=1024,
    sub_quadratic=False,
)
