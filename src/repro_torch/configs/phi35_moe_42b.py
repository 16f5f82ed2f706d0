"""phi3.5-moe-42b-a6.6b — 32L d_model=4096 32H (GQA kv=8) d_ff=6400(per-expert)
vocab=32064, MoE 16 experts top-2 every layer.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from .base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,  # all-FFN capacity lives in the experts
    vocab_size=32064,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400),
    rope_theta=10000.0,
    sharding_profile="zero3",   # 42B total params: shard everything
    remat="full",
    train_microbatches=4,
    subquadratic=False,
)
