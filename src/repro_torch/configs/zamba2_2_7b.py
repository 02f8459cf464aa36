"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

54 Mamba2 blocks; one *shared-weight* transformer block (full attention +
MLP) is applied every 6 SSM blocks (Zamba's shared-block design: the same
weights are reused at every application site).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32_000,
    attention="full",         # the shared block uses full attention
    rope_theta=10_000.0,
    act="gelu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    hybrid_attn_every=6,
    sub_quadratic=True,       # hybrid (SSM decode state is O(1)) -> 500k runs
)
