"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local(4096-window)/global alternating attention, attn+final logit softcaps,
sandwich norms, sqrt(d) embedding scale, GeGLU.  [arXiv:2408.00118; hf]

long_500k runs: the sliding-window layers keep O(window) caches; global
layers hold the whole KV cache — decode is O(L) reads.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    pattern=(
        LayerSpec(mixer="attn", ffn="dense", window=4096),  # local
        LayerSpec(mixer="attn", ffn="dense", window=None),  # global
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
    subquadratic=True,  # half the stack is sliding-window
)
