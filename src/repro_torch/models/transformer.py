"""Generic decoder-only model covering all assigned architectures
(counterpart of ``repro.models.transformer``).

The layer stack is ``n_repeats`` repetitions of a static ``pattern`` of
sublayers (attn/mamba mixer + dense/moe ffn).  Each pattern position's
parameters are stacked over the repeats on axis 0, as in the reference's
param tree, and a Python loop over the repeats replaces its
``lax.scan``.  The module tree carries the reference's names, so a
``state_dict`` key is the reference's flattened key with "." for "/"
(``blocks.0.mixer.wq``; ``models/convert.py``, ``checkpoint/``).

Under autograd each repeat's body is rematerialized as ``cfg.remat``
says, as the reference's ``jax.checkpoint`` of its scan body: "full"
recomputes the whole body in the backward pass, "dots" saves the weight
products and recomputes the rest (JAX's
``checkpoint_dots_with_no_batch_dims``), "nothing" saves every
activation.  Training reads the parameters through ``unbound``.  The
reference's sharding hooks concern GSPMD and are left out;
``logical_specs`` gives its spec tree, which the sharded training lays
over a mesh (``sharding.partition``).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig

from . import layers as L
from . import mamba2, moe


class Sublayer(nn.Module):
    """One pattern position, stacked over the repeats: ``norm``, ``mixer``,
    ``post_norm`` (sandwich norms), and ``ffn_norm``, ``ffn``,
    ``ffn_post_norm`` unless the position has no FFN."""

    def __init__(self, cfg: ModelConfig, spec, gen, device=None):
        super().__init__()
        R, d = cfg.n_repeats, cfg.d_model
        self.norm = L.RMSNorm(d, R, device)
        if spec.mixer == "attn":
            self.mixer = L.Attention(cfg, R, gen, device)
        else:
            self.mixer = mamba2.Mamba2(cfg, R, gen, device)
        if cfg.use_post_norm:
            self.post_norm = L.RMSNorm(d, R, device)
        if spec.ffn != "none":
            self.ffn_norm = L.RMSNorm(d, R, device)
            if spec.ffn == "dense":
                self.ffn = L.MLP(d, cfg.d_ff, R, gen, device)
            else:
                self.ffn = moe.MoE(d, cfg.moe, R, gen, device)
            if cfg.use_post_norm:
                self.ffn_post_norm = L.RMSNorm(d, R, device)


class Transformer(nn.Module):
    """The whole parameter tree: ``embed``, ``lm_head`` (untied heads
    only), ``final_norm`` and ``blocks`` (one ``Sublayer`` per pattern
    position).  ``gen=None`` leaves the weights uninitialized (a module to
    load a state_dict into)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, gen, device)
        if not cfg.tie_embeddings:
            self.lm_head = L.Embedding(cfg.padded_vocab, cfg.d_model, gen,
                                       device)
        self.final_norm = L.RMSNorm(cfg.d_model, None, device)
        self.blocks = nn.ModuleList(Sublayer(cfg, spec, gen, device)
                                    for spec in cfg.pattern)


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Transformer:
    """float32 parameters drawn from ``gen`` (on ``device``, which must be
    ``gen``'s device) with the reference's distributions."""
    return Transformer(cfg, gen, device)


def logical_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """{``state_dict`` name: logical axes}: the reference's spec tree
    (``repro.models.transformer.init``), each block leaf with the stacked
    ``"layers"`` axis first."""
    with torch.device("meta"):
        params = Transformer(cfg)
    out = {}
    for mname, module in params.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            spec = type(module).SPECS[pname]
            if mname.startswith("blocks."):
                spec = ("layers",) + spec
            out[f"{mname}.{pname}" if mname else pname] = spec
    return out


def unbound(params: Transformer, dtype: Optional[torch.dtype] = None):
    """``params`` as a tree of namespaces under the module's names, each
    leaf cast to ``dtype`` (None: as it is) and every block leaf split
    over the repeats (``unbind(0)``).  ``forward`` reads it as it reads
    the module (``blocks[i].mixer.wq[r]``), and gradients flow through
    the cast to the module's parameters.  Indexing a stacked leaf would
    give each repeat's gradient a zero tensor of the whole stack in the
    backward pass; ``unbind`` stacks the repeats' gradients once."""
    def tree(module, split):
        ns = SimpleNamespace()
        for name, p in module.named_parameters(recurse=False):
            p = p if dtype is None else p.to(dtype)
            setattr(ns, name, p.unbind(0) if split else p)
        for name, child in module.named_children():
            setattr(ns, name, tree(child, split))
        return ns

    out = SimpleNamespace(blocks=[tree(b, True) for b in params.blocks])
    for name, child in params.named_children():
        if name != "blocks":
            setattr(out, name, tree(child, False))
    return out


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the products without a batch dimension (the
    weight products: ``mm``, or ``bmm`` over a batch of one, as einsum
    lowers them), recompute everything else."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _rematerialized(body, remat: str):
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_weight_products))
    if remat == "nothing":
        return body
    raise ValueError(f"remat must be 'nothing', 'dots' or 'full', got "
                     f"{remat!r}")


def _apply_sublayer(p: Sublayer, r: int, cfg: ModelConfig, spec, x, *,
                    positions, start, cache, q_chunk):
    h = L.rmsnorm(p.norm.scale[r], x, cfg.norm_eps, f32=cfg.norm_f32)
    if spec.mixer == "attn":
        h = L.attention_apply(p.mixer, r, cfg, h, positions=positions,
                              start=start, window=spec.window,
                              kv_cache=cache, q_chunk=q_chunk)
    else:
        h = mamba2.mamba_apply(p.mixer, r, cfg, h, state=cache)
    if cfg.use_post_norm:
        h = L.rmsnorm(p.post_norm.scale[r], h, cfg.norm_eps,
                      f32=cfg.norm_f32)
    x = x + h
    aux = None
    if spec.ffn != "none":
        h = L.rmsnorm(p.ffn_norm.scale[r], x, cfg.norm_eps, f32=cfg.norm_f32)
        if spec.ffn == "dense":
            h = L.mlp_apply(p.ffn, r, h, cfg.act)
        else:
            h, aux = moe.moe_apply(p.ffn, r, h, cfg.moe, cfg.act)
        if cfg.use_post_norm:
            h = L.rmsnorm(p.ffn_post_norm.scale[r], h, cfg.norm_eps,
                          f32=cfg.norm_f32)
        x = x + h
    return x, aux


def forward(
    params: Transformer,
    cfg: ModelConfig,
    *,
    tokens: Optional[torch.Tensor] = None,   # (B, S) integer ids
    embeds: Optional[torch.Tensor] = None,   # (B, S, d) for audio/vlm stubs
    positions=None,
    caches=None,
    q_chunk: int = 512,
    last_only: bool = False,
):
    """Returns (logits (B, S, V), caches, aux loss (a float32 scalar)).
    ``params``: a ``Transformer`` or its ``unbound`` tree.

    ``positions``: None (0, 1, ..., S-1), an int (the first position of S
    contiguous ones, known on the host: the decode step's), or an (S,)
    tensor.  ``caches`` (``init_caches``) are updated in place and
    returned.  ``last_only`` applies the LM head to the final position
    only (prefill).
    """
    x = params.embed.embedding[tokens] if embeds is None else embeds
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    S = x.shape[1]
    start = None
    if positions is None or isinstance(positions, int):
        start = positions or 0
        positions = torch.arange(start, start + S, device=x.device)

    def repeat(r, x, aux):
        for i, spec in enumerate(cfg.pattern):
            cache = (None if caches is None
                     else {k: v[r] for k, v in caches[i].items()})
            x, a = _apply_sublayer(params.blocks[i], r, cfg, spec, x,
                                   positions=positions, start=start,
                                   cache=cache, q_chunk=q_chunk)
            if a is not None:
                aux = aux + a
        return x, aux

    if torch.is_grad_enabled() and caches is None:
        repeat = _rematerialized(repeat, cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.n_repeats):
        x, aux = repeat(r, x, aux)

    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params.final_norm.scale, x, cfg.norm_eps, f32=cfg.norm_f32)
    head = (params.embed if cfg.tie_embeddings else params.lm_head).embedding
    logits = torch.einsum("bsd,vd->bsv", x, head)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask the table-padding rows (under autograd the filled columns
        # pass no gradient back, as the reference's where)
        logits[..., cfg.vocab_size:] = L.NEG_INF
    return logits, caches, aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Per pattern position, a dict of caches stacked over the repeats.

    Sliding-window attention layers get a circular cache of ``window``
    slots (bounding long-context memory); global layers get ``max_len``
    slots.  ``pos`` is each repeat's next position (int32).
    """
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    R = cfg.n_repeats

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            Sc = min(spec.window, max_len) if spec.window else max_len
            caches.append({
                "k": zeros((R, batch, Sc, kvh, hd)),
                "v": zeros((R, batch, Sc, kvh, hd)),
                "pos": zeros((R,), torch.int32),
            })
        else:
            m = cfg.mamba
            d_in = m.expand * cfg.d_model
            H = d_in // m.head_dim
            gn = m.n_groups * m.d_state
            K = m.conv_width
            caches.append({
                "conv_x": zeros((R, batch, K - 1, d_in)),
                "conv_B": zeros((R, batch, K - 1, gn)),
                "conv_C": zeros((R, batch, K - 1, gn)),
                "ssm": zeros((R, batch, H, m.head_dim, m.d_state),
                             torch.float32),
            })
    return tuple(caches)
