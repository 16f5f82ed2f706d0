"""Model facade: init / apply / serving entry points + modality frontend
stubs (counterpart of ``repro.models.model``).

Per the brief, ``[audio]`` / ``[vlm]`` architectures specify the transformer
*backbone* only; the modality frontend is a stub whose job is to provide
precomputed frame/patch embeddings with the right shapes.

Parameters are a ``transformer.Transformer`` module; caches are the tuple
of ``init_caches``, updated in place by ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import transformer


def cast_floats(tree, dtype):
    """Floating-point leaves cast to ``dtype`` (a leaf already of that
    dtype is passed through, not copied).  A ``Transformer`` gives a new
    module of the cast parameters, or itself when every floating
    parameter already has ``dtype``; dictionaries, lists and tuples are
    mapped.

    The cast is for serving: the new module's parameters are detached
    copies that take no gradient.  Training casts inside its loss with
    ``transformer.unbound(params, dtype)``, through which gradients reach
    the float32 parameters (``train.train_step.make_loss_fn``)."""
    def c(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    if isinstance(tree, transformer.Transformer):
        if all(p.dtype == dtype for p in tree.parameters()
               if p.is_floating_point()):
            return tree
        with torch.device("meta"):
            new = transformer.Transformer(tree.cfg)
        new.load_state_dict({k: c(v) for k, v in tree.state_dict().items()},
                            assign=True)
        return new.requires_grad_(False)
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return c(tree)


class Model:
    """Binds a config to the init / apply / serving entry points."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> transformer.Transformer:
        """float32 parameters from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (the reference's ``init`` also returns its
        GSPMD sharding specs, which one device has no use for)."""
        from repro_torch.core.engine import resolve_device

        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init(gen, self.cfg, dev)

    # -- full-sequence forward (train / scoring) ----------------------------
    def apply(self, params, batch: dict, *, q_chunk: int = 512):
        """batch: {"tokens": (B, S)} or {"embeds": (B, S, d)}; ``params``:
        a ``Transformer`` or its ``transformer.unbound`` tree.  Returns
        (logits (B, S, V), aux loss).  Under autograd it records the
        graph, with each repeat rematerialized as ``cfg.remat`` says."""
        logits, _, aux = transformer.forward(
            params, self.cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), q_chunk=q_chunk)
        return logits, aux

    # -- serving ------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    device="cuda"):
        from repro_torch.core.engine import resolve_device

        return transformer.init_caches(self.cfg, batch, max_len, dtype,
                                       resolve_device(device))

    @torch.no_grad()
    def prefill(self, params, batch: dict, caches, *, q_chunk: int = 512):
        """Run the prompt through the model, filling the caches.
        Returns (last-token logits (B, V), caches)."""
        logits, caches, _ = transformer.forward(
            params, self.cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), caches=caches, q_chunk=q_chunk,
            last_only=True)
        return logits[:, -1], caches

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, caches, pos):
        """One decode step.  token: (B, 1) ids (or (B, 1, d) embeds); pos:
        the token's position (an int, or a 0-d tensor, read once on the
        host).  Returns (logits (B, V), caches)."""
        kw: dict[str, Any] = {}
        if token.ndim == 3:
            kw["embeds"] = token
        else:
            kw["tokens"] = token
        logits, caches, _ = transformer.forward(
            params, self.cfg, positions=int(pos), caches=caches, **kw)
        return logits[:, -1], caches


# ---------------------------------------------------------------------------
# modality frontend stubs
# ---------------------------------------------------------------------------
def audio_frontend_stub(gen: torch.Generator, batch: int, seq: int,
                        d_model: int, dtype=torch.bfloat16,
                        device: Optional[torch.device] = None):
    """Pretend-EnCodec frame embeddings (musicgen): (B, S, d)."""
    return (torch.randn((batch, seq, d_model), generator=gen,
                        device=device) * 0.02).to(dtype)


def vision_frontend_stub(gen: torch.Generator, batch: int, seq: int,
                         d_model: int, dtype=torch.bfloat16,
                         device: Optional[torch.device] = None):
    """Pretend-InternViT patch embeddings projected to LM width: (B, S, d)."""
    return (torch.randn((batch, seq, d_model), generator=gen,
                        device=device) * 0.02).to(dtype)
