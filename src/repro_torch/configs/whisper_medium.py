"""whisper-medium [audio] — encoder-decoder transformer backbone.

24L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865 [arXiv:2212.04356]

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (batch, frames, d_model).  24 encoder + 24
decoder layers (whisper-medium).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    attention="full",
    use_qkv_bias=True,
    act="gelu",
    norm="layernorm",
    frontend="audio_stub",
    frontend_tokens=1500,     # whisper encoder frames (30 s @ 50 Hz)
    max_target_positions=448,
    sub_quadratic=False,
)
