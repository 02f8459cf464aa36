"""smollm-135m [dense] — llama-arch small; the end-to-end train example model.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49_152,
    attention="full",
    rope_theta=10_000.0,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=False,
)
