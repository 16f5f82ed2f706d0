"""llama3.2-3b — 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    rope_theta=500000.0,
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",
    train_microbatches=4,
    subquadratic=False,
)
