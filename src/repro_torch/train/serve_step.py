"""Serving steps: batched prefill and single-token decode with caches
(counterpart of ``repro.train.serve_step``).

The steps run the model in bfloat16 and return float32 logits.  A step
casts the parameters it is given with ``cast_floats``, which hands
parameters already in bfloat16 back as they are: the caller casts once
(``launch.serve`` does), and no step copies the weights.
``cache_shardings`` gives the reference's layout of the caches over a
mesh (``PartitionSpec``s; the port's serving runs on one device).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as D
from repro_torch.core.distributed import P
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.model import Model, cast_floats
from repro_torch.sharding import partition


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


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The ``PartitionSpec`` of each cache of ``Model.init_caches``, one
    dict a pattern position (the reference's ``NamedSharding`` tree's
    specs): KV caches over the kv-head dim when it divides the model
    axis, else over the sequence; SSM states over the inner and head
    dims when they divide.  A spec naming a dimension the mesh lacks
    raises, as the reference's ``NamedSharding`` does."""
    bspec = partition.batch_pspec(mesh, batch)
    b = bspec[0] if bspec else None
    m = mesh_shape(mesh).get("model", 1)
    out = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            Sc = min(spec.window, max_len) if spec.window else max_len
            if cfg.n_kv_heads % m == 0:
                kvspec = P(None, b, None, "model", None)
            elif Sc % m == 0:
                kvspec = P(None, b, "model", None, None)
            else:
                kvspec = P(None, b, None, None, None)
            out.append({"k": kvspec, "v": kvspec, "pos": P(None)})
        else:
            mm = cfg.mamba
            d_in = mm.expand * cfg.d_model
            H = d_in // mm.head_dim
            inner = "model" if d_in % m == 0 else None
            heads = "model" if H % m == 0 else None
            out.append({"conv_x": P(None, b, None, inner),
                        "conv_B": P(None, b, None, None),
                        "conv_C": P(None, b, None, None),
                        "ssm": P(None, b, heads, None, None)})
    names = set(mesh_shape(mesh))
    for layer in out:
        for spec in layer.values():
            missing = D._spec_axes(spec) - names
            if missing:
                raise ValueError(f"cache spec {tuple(spec)} names "
                                 f"{sorted(missing)}, not in the mesh's "
                                 f"{sorted(names)}")
    return tuple(out)
