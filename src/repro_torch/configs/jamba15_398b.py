"""jamba-1.5-large-398b — 72L d_model=8192 64H (GQA kv=8) d_ff=24576(per-expert)
vocab=65536, Mamba:attn 7:1 interleave, MoE(16e top-2) every other layer.
[arXiv:2403.19887; hf]

Deviation (DESIGN.md §9): paper-Jamba uses Mamba-1 selective scan; this
framework substitutes the Mamba2 SSD block (same state-size interface).
The 72-layer stack is 9 repeats of an 8-layer pattern with attention at
position 4 and MoE on odd positions (1:7 attn:mamba, 1:2 moe:dense).
"""
from .base import LayerSpec, MambaConfig, ModelConfig, MoEConfig

_P = []
for i in range(8):
    mixer = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    _P.append(LayerSpec(mixer=mixer, ffn=ffn))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    pattern=tuple(_P),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576),
    mamba=MambaConfig(d_state=128, head_dim=64, n_groups=8, conv_width=4,
                      chunk=256, expand=2),
    rope_theta=10000.0,
    sharding_profile="zero3",   # 398B params: ZeRO-3 over all data axes
    remat="full",
    train_microbatches=8,
    subquadratic=True,  # hybrid: 63/72 layers are SSM; 9 attn layers KV-shard
)
