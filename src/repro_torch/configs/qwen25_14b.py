"""qwen2.5-14b — 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    qkv_bias=True,
    rope_theta=1000000.0,
    sharding_profile="fsdp",
    remat="full",
    train_microbatches=2,
    subquadratic=False,
)
