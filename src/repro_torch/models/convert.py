"""Weights carried between the two packages.

The reference's param tree, flattened with its checkpointer's keys
(``embed/embedding``, ``final_norm/scale``, ``blocks/<i>/mixer/wq``, ...,
each block leaf stacked over the repeats on axis 0), and the port's
``Transformer.state_dict()`` name the same leaves with the same shapes: a
port name is the reference key with "." for "/".  The mapping is total
and one to one, and both directions check it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .transformer import Transformer

__all__ = ["params_from_reference", "params_to_reference"]


def _check(cfg: ModelConfig, shapes: Mapping[str, tuple]) -> None:
    with torch.device("meta"):
        want = {k.replace(".", "/"): tuple(v.shape)
                for k, v in Transformer(cfg).state_dict().items()}
    missing = sorted(set(want) - set(shapes))
    extra = sorted(set(shapes) - set(want))
    wrong = sorted(k for k in set(want) & set(shapes)
                   if tuple(shapes[k]) != want[k])
    if missing or extra or wrong:
        raise ValueError(
            f"{cfg.name}: the reference's params do not map onto the port's: "
            f"missing {missing}, unexpected {extra}, "
            f"shape mismatch {[(k, tuple(shapes[k]), want[k]) for k in wrong]}")


def params_from_reference(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                          device="cpu") -> Transformer:
    """The port's parameters holding the reference's flattened param tree
    (a leaf's dtype is kept)."""
    _check(cfg, {k: np.shape(v) for k, v in flat.items()})
    with torch.device("meta"):
        params = Transformer(cfg)
    params.load_state_dict(
        {k.replace("/", "."): torch.tensor(np.asarray(v), device=device)
         for k, v in flat.items()}, assign=True)
    return params


def params_to_reference(params: Transformer) -> dict[str, np.ndarray]:
    """The reference's flattened param tree (float32 numpy arrays for
    floating leaves) from the port's parameters."""
    flat = {k.replace(".", "/"): v.detach().cpu().float().numpy()
            for k, v in params.state_dict().items()}
    _check(params.cfg, {k: v.shape for k, v in flat.items()})
    return flat
