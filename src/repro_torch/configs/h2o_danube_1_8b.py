"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    attention="swa",
    window=4096,
    rope_theta=10_000.0,
    act="silu",
    norm="rmsnorm",
    sub_quadratic=True,       # SWA -> long_500k runs
)
