"""Core transformer layers: RMSNorm, RoPE, GQA attention, gated MLP
(counterpart of ``repro.models.layers``).

Each layer is an ``nn.Module`` whose parameters carry the reference's
param-tree names, stacked over the model's repeats on axis 0 (``wq`` is
(repeats, d, heads, head_dim)); ``apply(r, ...)`` runs repeat ``r``.
Weights are drawn from an explicit ``torch.Generator`` with the
reference's scales.

Attention is the reference's ``_attend`` in plain torch ops: float32
softmax, the QK and PV products accumulated in float32 (``attn_out_f32``),
query chunking, sliding windows, GQA, attention-logit softcapping (gemma2)
and QKV bias (qwen2.5).  It is not ``scaled_dot_product_attention``,
which takes no softcap.  The reference's ``repro.sharding.partition``
hooks (sequence sharding of q and x) are the identity on one device and
are left out.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0e38


def normal(shape, scale: float, gen: torch.Generator, device) -> torch.Tensor:
    """float32 N(0, 1) * scale from ``gen``."""
    return torch.randn(shape, generator=gen, device=device) * scale


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable weight.  Serving records no graph all the same:
    ``Model.prefill`` / ``decode_step`` run under ``torch.no_grad()``."""
    return nn.Parameter(t)


# ---------------------------------------------------------------------------
# norms / embeddings / rope
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    """``scale``: (repeats, d), or (d,) when ``repeats`` is None."""

    # each parameter's logical axes (the reference's spec tree, without the
    # stacked "layers" axis; ``transformer.logical_specs``)
    SPECS = {"scale": ("embed_nosplit",)}

    def __init__(self, d: int, repeats: Optional[int], device=None):
        super().__init__()
        shape = (d,) if repeats is None else (repeats, d)
        self.scale = param(torch.ones(shape, device=device))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float,
            f32: bool = True) -> torch.Tensor:
    if f32:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * scale
        return y.to(x.dtype)
    # the input dtype normalizes, with float32 statistics
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    r = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * r * scale.to(x.dtype)


class Embedding(nn.Module):
    """``embedding``: (vocab, d), N(0, 0.02^2)."""

    SPECS = {"embedding": ("vocab", "embed")}

    def __init__(self, vocab: int, d: int, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        t = (normal((vocab, d), 0.02, gen, device) if gen is not None
             else torch.empty((vocab, d), device=device))
        self.embedding = param(t)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim), positions: (seq,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs      # (seq, half)
    cos = torch.cos(ang)[..., None, :]              # (seq, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Explicit 3-D head layout: ``wq`` (R, d, H, hd), ``wk`` / ``wv``
    (R, d, KV, hd), ``wo`` (R, H, hd, d); with ``qkv_bias`` also ``bq``
    (R, H, hd), ``bk`` / ``bv`` (R, KV, hd), zero at init."""

    SPECS = {"wq": ("embed", "q_heads", None),
             "wk": ("embed", "kv_heads", None),
             "wv": ("embed", "kv_heads", None),
             "wo": ("q_heads", None, "embed"),
             "bq": ("q_heads", None),
             "bk": ("kv_heads", None),
             "bv": ("kv_heads", None)}

    def __init__(self, cfg, repeats: int, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        s = d ** -0.5
        shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                  "wo": (h, hd, d)}
        for name, shape in shapes.items():
            t = (normal((repeats,) + shape, s, gen, device)
                 if gen is not None
                 else torch.empty((repeats,) + shape, device=device))
            setattr(self, name, param(t))
        if cfg.qkv_bias:
            for name, shape in (("bq", (h, hd)), ("bk", (kv, hd)),
                                ("bv", (kv, hd))):
                setattr(self, name, param(torch.zeros((repeats,) + shape,
                                                        device=device)))


def _attend(q, k, v, q_positions, kv_positions, window: Optional[int],
            softcap: Optional[float], out_f32: bool = True) -> torch.Tensor:
    """Masked softmax attention for one query block.  q: (B, Sq, H, hd),
    k / v: (B, Skv, KV, hd), kv_positions -1 for an empty slot.  The QK
    product accumulates in float32 (the reference's
    ``preferred_element_type``), the softmax is float32, the
    probabilities go back to q's dtype, and the PV product accumulates in
    float32 when ``out_f32``."""
    H, KV = q.shape[2], k.shape[2]
    g = H // KV
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)   # (B, Skv, H, hd)
        v = torch.repeat_interleave(v, g, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhe,bshe->bhqs", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = kv_positions[None, :] <= q_positions[:, None]       # causal
    mask = mask & (kv_positions[None, :] >= 0)                 # validity
    if window is not None:
        mask = mask & (kv_positions[None, :] > q_positions[:, None] - window)
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if out_f32:
        return torch.einsum("bhqs,bshe->bqhe", probs.float(), v.float())
    dt = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqs,bshe->bqhe", probs.to(dt), v.to(dt))


def _write_cache(cache: dict, kx, vx, positions: torch.Tensor,
                 start: Optional[int], S: int):
    """Write this call's K / V into a (circular, when windowed) cache in
    place; return the slots' global positions (-1: empty) and advance the
    cache's position.  The positions of one call are contiguous and the
    same for the whole batch; ``start`` is the first of them as a host
    integer (None: read it from ``positions``, which waits for the
    device)."""
    ck, cv = cache["k"], cache["v"]
    Sc = ck.shape[1]
    if S <= Sc:
        # decode (S = 1) and a fresh prefill: one contiguous span, its start
        # clamped into the cache as the reference's dynamic_update_slice
        # clamps it
        first = int(positions[0]) if start is None else start
        at = min(first % Sc, Sc - S)
        ck[:, at:at + S] = kx.to(ck.dtype)
        cv[:, at:at + S] = vx.to(cv.dtype)
    else:
        # a prompt longer than the sliding window: only the last Sc tokens
        # survive, and their slots tile the cache exactly once
        sl = positions[-Sc:] % Sc
        ck.zero_()
        cv.zero_()
        ck[:, sl] = kx[:, -Sc:].to(ck.dtype)
        cv[:, sl] = vx[:, -Sc:].to(cv.dtype)
    cpos = cache["pos"]           # first position written this call
    last = cpos + S - 1           # last global position now present
    slot_ids = torch.arange(Sc, device=ck.device)
    # token held by slot s = the largest t <= last with t % Sc == s
    tok = last - torch.remainder(last - slot_ids, Sc)
    kv_positions = torch.where(tok >= 0, tok, -1)
    cpos.add_(S)
    return ck, cv, kv_positions


def attention_apply(p: Attention, r: int, cfg, x: torch.Tensor, *,
                    positions: torch.Tensor, start: Optional[int] = None,
                    window: Optional[int],
                    kv_cache: Optional[dict] = None,
                    q_chunk: int = 512) -> torch.Tensor:
    """Repeat ``r`` of the attention sublayer.  x: (B, S, d).

    Without a cache: causal self-attention over x.  With a cache
    (``{"k", "v"}`` (B, Sc, KV, hd), ``"pos"`` a 0-d int32 tensor, all
    views of the stacked caches): x's K / V are written at ``positions``
    (the circular slot when windowed) in place, the position advances, and
    the queries attend over the whole cache (prefill: S = prompt length;
    decode: S = 1).
    """
    S = x.shape[1]
    q = torch.einsum("bsd,dhe->bshe", x, p.wq[r])
    kx = torch.einsum("bsd,dke->bske", x, p.wk[r])
    vx = torch.einsum("bsd,dke->bske", x, p.wv[r])
    if cfg.qkv_bias:
        q, kx, vx = q + p.bq[r], kx + p.bk[r], vx + p.bv[r]
    q = rope(q, positions, cfg.rope_theta)
    kx = rope(kx, positions, cfg.rope_theta)

    if kv_cache is None:
        k_all, v_all, kv_positions = kx, vx, positions
    else:
        k_all, v_all, kv_positions = _write_cache(kv_cache, kx, vx,
                                                  positions, start, S)

    def q_block(qc, qpos):
        return _attend(qc, k_all, v_all, qpos, kv_positions, window,
                       cfg.attn_logit_softcap, cfg.attn_out_f32)

    if S > q_chunk and S % q_chunk == 0:
        # under autograd each chunk's scores are recomputed in the backward
        # pass, as the reference's jax.checkpoint of the chunk does: saved,
        # every chunk's (B, H, q_chunk, S) scores would be held at once
        block = q_block
        if torch.is_grad_enabled():
            block = functools.partial(checkpoint, q_block,
                                      use_reentrant=False)
        out = torch.cat([block(q[:, i:i + q_chunk], positions[i:i + q_chunk])
                         for i in range(0, S, q_chunk)], dim=1)
    else:
        out = q_block(q, positions)
    out = out.to(x.dtype)
    return torch.einsum("bshe,hed->bsd", out, p.wo[r])


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """``w_gate`` / ``w_up`` (R, d, ff), ``w_down`` (R, ff, d)."""

    SPECS = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
             "w_down": ("ff", "embed")}

    def __init__(self, d: int, ff: int, repeats: int,
                 gen: Optional[torch.Generator], device=None):
        super().__init__()
        for name, shape, s in (("w_gate", (d, ff), d ** -0.5),
                               ("w_up", (d, ff), d ** -0.5),
                               ("w_down", (ff, d), ff ** -0.5)):
            t = (normal((repeats,) + shape, s, gen, device)
                 if gen is not None
                 else torch.empty((repeats,) + shape, device=device))
            setattr(self, name, param(t))


def activation(act: str):
    if act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def mlp_apply(p: MLP, r: int, x: torch.Tensor, act: str) -> torch.Tensor:
    a = activation(act)
    return (a(x @ p.w_gate[r]) * (x @ p.w_up[r])) @ p.w_down[r]
