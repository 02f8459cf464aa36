"""command-r-35b [dense] — GQA, no-bias.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256_000,
    attention="full",
    rope_theta=8_000_000.0,
    act="silu",
    norm="layernorm",         # cohere uses LayerNorm (no bias)
    tie_embeddings=True,      # command-r ties input/output embeddings
    parallel_block=True,      # cohere parallel attention + FFN block
    sub_quadratic=False,      # pure full attention -> skip long_500k
)
