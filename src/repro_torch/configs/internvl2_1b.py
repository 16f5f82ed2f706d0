"""internvl2-1b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT + InternLM2/Qwen2-0.5B-style LM backbone; the vision frontend is a
stub providing precomputed patch embeddings (per brief).
[arXiv:2404.16821; hf]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    modality="vlm",
    sharding_profile="fsdp",
    remat="full",
    subquadratic=False,
)
