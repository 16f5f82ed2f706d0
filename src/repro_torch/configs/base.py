"""Model / run configuration system (counterpart of ``repro.configs.base``;
every field the port reads, with its default as there).

A ``ModelConfig`` fully describes one architecture.  Heterogeneous stacks
(gemma2 local/global alternation, jamba attn:mamba 1:7) are expressed as a
repeating ``pattern`` of ``LayerSpec`` entries; the port's model
(``repro_torch.models.transformer``) loops over ``n_layers // len(pattern)``
repeats with the pattern inside the loop, each pattern position's
parameters stacked over the repeats.

``sharding_profile`` (dp, fsdp or zero3) says how the sharded training
lays the parameters and AdamW moments over a device mesh
(``repro_torch.sharding.partition``).  The reference's fields that steer
only its compiler's placement and lowering (``scan_unroll``,
``probe_unroll``, ``moe_shard_constraints``, ``attn_seq_proj``,
``batch_shard_constraint``) are left out: nothing in the port reads them.
The model reads ``remat`` under autograd; the dry run
(``launch.dryrun``) reads ``train_microbatches`` for a train cell
(``launch.train`` takes ``--microbatches``, default 1, as the reference's
``launch/train.py`` does).

Shapes (the assigned input-shape set) are in ``SHAPES``; each (arch x shape)
cell resolves via ``runnable()`` -- pure-full-attention archs skip long_500k
per the brief (DESIGN.md §6.2).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional

Modality = Literal["text", "audio", "vlm"]


@dataclass(frozen=True)
class LayerSpec:
    """One sublayer position within the repeating pattern."""
    mixer: Literal["attn", "mamba"] = "attn"
    ffn: Literal["dense", "moe", "none"] = "dense"
    window: Optional[int] = None  # sliding-window size for attn, None = global


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                 # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # dispatch group size: total one-hot dispatch/combine work is
    # ~1.25·k·T·group_tokens — small-expert configs (granite d_ff=512)
    # want this low or the dispatch einsums rival the expert FLOPs
    group_tokens: int = 512


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    use_post_norm: bool = False             # gemma2 sandwich norms
    scale_embed: bool = False               # gemma2 sqrt(d) embedding scale
    act: Literal["silu", "gelu"] = "silu"
    modality: Modality = "text"
    # how the sharded training lays the parameters over a mesh
    # (repro_torch.sharding.partition)
    sharding_profile: Literal["dp", "fsdp", "zero3"] = "fsdp"
    # what the backward pass recomputes of each repeat of the pattern:
    # nothing (every activation saved), everything but the weight products
    # ("dots"), or everything ("full")
    remat: Literal["nothing", "dots", "full"] = "full"
    # default gradient-accumulation microbatches of a train cell in the dry
    # run (the memory lever: a microbatch's activations are held at once)
    train_microbatches: int = 1
    # rmsnorm with a full float32 upcast (True) or bfloat16 with float32
    # statistics (False)
    norm_f32: bool = True
    # the attention PV product accumulated in float32 (True) or in the
    # activations' dtype (False)
    attn_out_f32: bool = True
    # sub-quadratic mechanism available (SSM/hybrid/sliding-window)?
    subquadratic: bool = False
    # embedding / lm-head tables are padded up to a multiple of this (as
    # the reference pads them); logits beyond ``vocab_size`` are masked to
    # -inf in the forward pass.
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}"
        )

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts, embedding included."""
        d, hd = self.d_model, self.resolved_head_dim
        total = active = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
            active += self.vocab_size * d
        for spec in self.pattern:
            t = a = 0
            if spec.mixer == "attn":
                qkvo = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
                t += qkvo
                a += qkvo
            else:
                m = self.mamba or MambaConfig()
                d_in = m.expand * d
                g = m.n_groups * m.d_state
                nheads = d_in // m.head_dim
                p = d * (2 * d_in + 2 * g + nheads)        # in_proj
                p += (d_in + 2 * g) * m.conv_width          # conv
                p += nheads * 2 + nheads                    # A_log, D, dt_bias
                p += d_in * d                               # out_proj
                t += p
                a += p
            if spec.ffn == "dense":
                f = 3 * d * self.d_ff
                t += f
                a += f
            elif spec.ffn == "moe":
                moe = self.moe
                assert moe is not None
                t += d * moe.n_experts + 3 * d * moe.d_ff * moe.n_experts
                a += d * moe.n_experts + 3 * d * moe.d_ff * moe.top_k
            t += 2 * d  # norms (approx; post-norms negligible)
            a += 2 * d
            total += t * self.n_repeats
            active += a * self.n_repeats
        return total, active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "pure full-attention arch: no sub-quadratic mechanism for 500k "
            "context (skip per brief, DESIGN.md §6.2)"
        )
    return True, ""


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.pattern
    small = dict(
        n_layers=len(pat) if len(pat) > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sharding_profile="dp",
        remat="nothing",
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64,
            capacity_factor=2.0,
        )
    if cfg.mamba is not None:
        small["mamba"] = MambaConfig(d_state=16, head_dim=16, chunk=8)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
