"""mamba2-780m — 48L d_model=1536 attn-free (SSD) vocab=50280 ssm_state=128.
[arXiv:2405.21060; unverified]
"""
from .base import LayerSpec, MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    n_layers=48,
    d_model=1536,
    n_heads=24,       # unused (attn-free); kept for interface completeness
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    mamba=MambaConfig(d_state=128, head_dim=64, n_groups=1, conv_width=4,
                      chunk=256, expand=2),
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",
    train_microbatches=2,
    subquadratic=True,  # SSM: O(1) decode state -> long_500k runs
)
