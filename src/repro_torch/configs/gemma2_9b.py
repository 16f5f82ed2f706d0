"""gemma2-9b — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Local(4096)/global alternating, logit softcaps.  [arXiv:2408.00118; hf]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    pattern=(
        LayerSpec(mixer="attn", ffn="dense", window=4096),
        LayerSpec(mixer="attn", ffn="dense", window=None),
    ),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    use_post_norm=True,
    scale_embed=True,
    act="gelu",
    sharding_profile="fsdp",
    remat="full",
    train_microbatches=4,
    subquadratic=True,
)
