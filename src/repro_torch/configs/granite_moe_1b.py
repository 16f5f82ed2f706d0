"""granite-moe-1b-a400m — 24L d_model=1024 16H (GQA kv=8) d_ff=512(per-expert)
vocab=49155, MoE 32 experts top-8 every layer.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=49155,
    head_dim=64,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    # group_tokens=128: with 512-wide experts the one-hot dispatch and
    # combine einsums rival the expert FLOPs at the default 512 groups
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, group_tokens=128),
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",
    train_microbatches=2,
    subquadratic=False,
)
