"""Top-k capacity-based Mixture-of-Experts (counterpart of
``repro.models.moe``).

The reference's "dropping" dispatch on one device: tokens are grouped,
each group dispatches into an (experts, capacity) buffer with one-hot
einsums, the expert FFN runs on the buffer, and a combine einsum scatters
the results back.  Tokens beyond ``capacity_factor * k * T / E`` of an
expert are dropped.  The router's top k is a stable descending sort, so
tied probabilities pick the lower expert index first, as
``jax.lax.top_k`` does (``torch.topk`` does not promise an order).  The
reference's expert-axis sharding constraints are the identity on one
device and are left out.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .layers import activation, normal, param


class MoE(nn.Module):
    """``router`` (R, d, E), ``w_gate`` / ``w_up`` (R, E, d, ff),
    ``w_down`` (R, E, ff, d)."""

    SPECS = {"router": ("embed_nosplit", None),
             "w_gate": ("experts", "embed", None),
             "w_up": ("experts", "embed", None),
             "w_down": ("experts", None, "embed")}

    def __init__(self, d: int, moe_cfg, repeats: int,
                 gen: Optional[torch.Generator], device=None):
        super().__init__()
        e, ff = moe_cfg.n_experts, moe_cfg.d_ff
        for name, shape, s in (("router", (d, e), d ** -0.5),
                               ("w_gate", (e, d, ff), d ** -0.5),
                               ("w_up", (e, d, ff), d ** -0.5),
                               ("w_down", (e, ff, d), ff ** -0.5)):
            t = (normal((repeats,) + shape, s, gen, device)
                 if gen is not None
                 else torch.empty((repeats,) + shape, device=device))
            setattr(self, name, param(t))


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_apply(p: MoE, r: int, x: torch.Tensor, moe_cfg, act: str, *,
              group_tokens: Optional[int] = None):
    """Repeat ``r``.  x: (B, S, d).  Returns (output (B, S, d), the
    router's aux loss, a float32 scalar)."""
    B, S, d = x.shape
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    T = B * S
    tg = min(group_tokens or moe_cfg.group_tokens, T)
    while T % tg:
        tg -= 1
    g = T // tg
    xt = x.reshape(g, tg, d)

    logits = torch.einsum("gtd,de->gte", xt, p.router[r])
    probs = torch.softmax(logits.float(), dim=-1)                 # (g, tg, e)
    gate_vals, ids = top_k(probs, k)                              # (g, tg, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    cap = max(int(moe_cfg.capacity_factor * k * tg / e), k)

    # position of each (token, choice) within its expert's capacity buffer
    onehot = F.one_hot(ids, e).to(torch.int32)                    # (g,tg,k,e)
    flat = onehot.reshape(g, tg * k, e)
    pos = torch.cumsum(flat, dim=1) - 1
    pos = torch.sum(pos * flat, dim=-1).reshape(g, tg, k)
    keep = pos < cap

    # dispatch[g, t, e, c] in {0, 1}; combine carries the gate weight (a
    # position past the capacity has no one-hot row, as in jax.nn.one_hot)
    pos_oh = (F.one_hot(pos.clamp(max=cap - 1).long(), cap).to(x.dtype)
              * keep[..., None].to(x.dtype))
    disp = torch.einsum("gtke,gtkc->gtec", onehot.to(x.dtype), pos_oh)
    comb = torch.einsum("gtke,gtkc->gtec", onehot.float(),
                        pos_oh.float() * gate_vals[..., None]).to(x.dtype)

    xe = torch.einsum("gtec,gtd->gecd", disp, xt)                 # (g,e,cap,d)
    a = activation(act)
    h = a(torch.einsum("gecd,edf->gecf", xe, p.w_gate[r])) * torch.einsum(
        "gecd,edf->gecf", xe, p.w_up[r])
    ye = torch.einsum("gecf,efd->gecd", h, p.w_down[r])
    y = torch.einsum("gecd,gtec->gtd", ye, comb).reshape(B, S, d)

    # load-balance aux loss (Switch-style)
    frac_tokens = torch.mean(onehot.float(), dim=(1, 2))          # (g, e)
    frac_probs = torch.mean(probs, dim=1)                         # (g, e)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return y, aux * moe_cfg.router_aux_coef
