"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule, written from scratch on tensors (counterpart of
``repro.optim.adamw``; not ``torch.optim.AdamW``, which clips nowhere and
takes its learning rate from the host).

The schedule, the clip scale and the bias corrections are device tensors
computed from the step counter, as in the reference.  ``apply`` updates
the parameters and the moments in place, leaf by leaf, and uses each
gradient as its own leaf's scratch: the update allocates nothing of a
leaf's size.  The reference gets the same by donating its state to the
jitted step; a functional update here would hold about six temporaries
the size of the largest leaf (gemma2-2b's 2.36 GB embedding) on top of
the state.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch

__all__ = ["AdamWConfig", "schedule", "init", "global_norm", "apply"]


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine down to ``lr_min`` at
    ``total_steps``: a float32 tensor of ``step``'s shape and device."""
    step = step.to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero first and second moments, keyed as ``params``."""
    return {name: {k: torch.zeros_like(p) for k, p in params.items()}
            for name in ("m", "v")}


def global_norm(leaves) -> torch.Tensor:
    """The float32 L2 norm of all the leaves together."""
    sq = [torch.linalg.vector_norm(l, dtype=torch.float32) ** 2
          for l in leaves]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], opt_state: dict,
          step: torch.Tensor, grad_norm: torch.Tensor | None = None) -> dict:
    """One update of ``params``, ``opt_state["m"]`` and ``opt_state["v"]``
    in place (float32 leaves keyed alike) from ``grads``, which it
    overwrites: the gradients are scratch once read.  ``step`` is the
    0-d step counter (not advanced here).  ``grad_norm``: the global
    gradient norm to clip by (the sharded step's, taken over every
    rank's shards); None takes it over ``grads``.  Returns the metrics
    {"grad_norm", "lr"} as 0-d float32 tensors."""
    gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for k, p in params.items():
        g, m, v = grads[k], opt_state["m"][k], opt_state["v"][k]
        g.mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        # g := m / bc1 / (sqrt(v / bc2) + eps) + wd p, then p -= lr g
        torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps).mul_(bc1)
        torch.div(m, g, out=g).add_(p, alpha=cfg.weight_decay)
        p.sub_(g.mul_(lr))
    return {"grad_norm": gnorm, "lr": lr}
