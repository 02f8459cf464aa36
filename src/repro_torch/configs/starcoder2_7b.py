"""starcoder2-7b [dense] — GQA, RoPE, bias in qkv (starcoder2 uses bias).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 [arXiv:2402.19173; hf]

36 heads is not divisible by the 16-way model axis, so attention activations
use sequence-parallel sharding instead of head sharding (see parallel/sharding).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49_152,
    attention="full",
    rope_theta=100_000.0,
    use_qkv_bias=True,
    act="gelu",
    norm="layernorm",
    sub_quadratic=False,
)
