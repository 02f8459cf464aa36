"""llama4-maverick-400b-a17b [moe] — interleaved dense/MoE, 128 experts top-1,
one shared expert, early fusion (vision stubbed).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]

Every other layer is MoE (moe_every=2), matching Maverick's interleaved
MoE schedule; ~400B total / ~17B active.  This is the arch whose training
state (params + Adam moments ~5.6 TB) CANNOT fit a pod without the paper's
pooled-memory technique — see EXPERIMENTS.md §Dry-run.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    attention="full",
    rope_theta=500_000.0,
    act="silu",
    norm="rmsnorm",
    num_experts=128,
    top_k=1,
    moe_every=2,
    shared_experts=1,
    sub_quadratic=False,      # chunked-attention variant not modeled; skip 500k
)
