"""Serving steps: batched prefill and single-token decode with caches
(counterpart of ``repro.train.serve_step``).

The steps run the model in bfloat16 and return float32 logits.  A step
casts the parameters it is given with ``cast_floats``, which hands
parameters already in bfloat16 back as they are: the caller casts once
(``launch.serve`` does), and no step copies the weights.  The reference's
``cache_shardings`` (GSPMD placement of the caches over a mesh) waits for
the sharded training (ROADMAP.md queue 1, item 12b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, cast_floats


def make_prefill_step(cfg: ModelConfig, *, q_chunk: int = 512):
    model = Model(cfg)

    def prefill_step(params, batch: dict, caches):
        p = cast_floats(params, torch.bfloat16)
        if "embeds" in batch:
            b = {"embeds": batch["embeds"].to(torch.bfloat16)}
        else:
            b = {"tokens": batch["tokens"]}
        logits, caches = model.prefill(p, b, caches, q_chunk=q_chunk)
        return logits.float(), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    model = Model(cfg)

    def decode_step(params, token, caches, pos):
        p = cast_floats(params, torch.bfloat16)
        if token.ndim == 3:
            token = token.to(torch.bfloat16)
        logits, caches = model.decode_step(p, token, caches, pos)
        return logits.float(), caches

    return decode_step
