"""musicgen-medium — 48L d_model=1536 24H (kv=24, i.e. MHA) d_ff=6144
vocab=2048 (EnCodec codebook).  Decoder-only over EnCodec tokens; the audio
frontend is a stub providing precomputed frame embeddings (per brief).
[arXiv:2306.05284; hf]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    act="gelu",
    modality="audio",
    sharding_profile="fsdp",
    remat="full",
    train_microbatches=2,
    subquadratic=False,
)
