"""Jobs for the ranks of a local world (``testing.world.World.run``) that
train sharded: each runs in every rank on its ``DeviceMesh`` and returns
numpy-able results, which the tests hold against the JAX package and
against the single-device step.

    with World(4) as w:
        outs = w.run("repro_torch.testing.training:train", cfg,
                     MeshSpec((2, 2), ("data", "model")), flat=ref_state)

A state ``flat`` is the reference's train state flattened with its
checkpointer's keys (numpy leaves), carried across by
``train_step.state_from_reference`` and sharded by ``shard_state``.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

__all__ = ["shard_blocks", "batch_rows", "train", "gradients"]


def _rank_device(device):
    from repro_torch.core.engine import resolve_device

    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device(device)


def _sharded_state(cfg, mesh, flat, seed, dev):
    from repro_torch.train import train_step as ts

    if flat is None:
        return ts.init_state(cfg, seed, dev, mesh=mesh)
    full = ts.state_from_reference(flat, cfg, dev)
    state = ts.shard_state(full, mesh, cfg)
    del full
    return state


def _flat(tree) -> dict:
    from repro_torch.checkpoint import checkpointer

    return {k: v.detach() for k, v in checkpointer._flatten(tree).items()}


def shard_blocks(cfg, mesh, flat: Mapping, device="cpu") -> dict:
    """This rank's blocks of the state ``flat``, keyed as the reference's
    checkpointer keys the global leaves."""
    return _flat(_sharded_state(cfg, mesh, flat, 0, _rank_device(device)))


def batch_rows(cfg, mesh, *, batch: int, seq: int, step: int = 0,
               seed: int = 0, device="cpu") -> dict:
    """This rank's rows of SyntheticTokens' batch ``step``, split as
    ``partition.batch_pspec`` splits a batch of ``batch`` rows."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.sharding import partition

    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed,
                           device=_rank_device(device), mesh=mesh,
                           batch_spec=partition.batch_pspec(mesh, batch))
    return data.batch_at(step)


def train(cfg, mesh, *, flat: Optional[Mapping] = None, seed: int = 0,
          first: int = 0, steps: int = 1, batch: int = 8, seq: int = 32,
          repeat: bool = False, opt: Optional[dict] = None,
          microbatches: int = 1, ckpt_dir: Optional[str] = None,
          resume: bool = False, gather: bool = True,
          device="cpu") -> dict:
    """Sharded steps [first, first + steps) on SyntheticTokens' batches
    (batch ``first`` every step if ``repeat``) from the state ``flat``
    (else ``init_state(cfg, seed)``, or with ``resume`` the latest
    checkpoint in ``ckpt_dir``, restored onto this mesh); then, with a
    ``ckpt_dir`` and no ``resume``, a sharded save at the last step.
    Returns {"metrics": one dict of floats a step, "restored": the step
    restored (-1 without), "blocks": the restored (else initial) blocks,
    "state": the global state after the steps (flat, with ``gather``)}."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts

    dev = _rank_device(device)
    restored = -1
    if resume:
        state, restored, _ = elastic.resume(cfg, ckpt_dir, mesh=mesh,
                                            device=dev)
    else:
        state = _sharded_state(cfg, mesh, flat, seed, dev)
    out = {"restored": restored,
           "blocks": {k: v.clone() for k, v in _flat(state).items()}}
    bspec = partition.batch_pspec(mesh, batch)
    step_fn = ts.make_train_step(cfg, adamw.AdamWConfig(**(opt or {})),
                                 microbatches=microbatches, mesh=mesh,
                                 batch_spec=bspec)
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed, device=dev,
                           mesh=mesh, batch_spec=bspec)
    out["metrics"] = []
    for s in range(first, first + steps):
        state, m = step_fn(state, data.batch_at(first if repeat else s))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    if ckpt_dir and not resume:
        checkpointer.save(ckpt_dir, first + steps - 1, state,
                          elastic.state_shardings(cfg, mesh), mesh)
    if gather:
        out["state"] = ts.state_to_reference(ts.gather_state(state, mesh,
                                                             cfg))
    return out


def gradients(cfg, mesh, *, flat: Optional[Mapping] = None, seed: int = 0,
              batch: int = 8, seq: int = 32, step: int = 0,
              microbatches: int = 1, float32: bool = False,
              device="cpu") -> dict:
    """The global float32 gradients (gathered, keyed as the parameters'
    reference keys) and the global loss of the sharded backward on
    SyntheticTokens' batch ``step`` from the state ``flat`` (else
    ``init_state(cfg, seed)``); ``float32``: the loss on the float32
    parameters themselves (no bfloat16 cast)."""
    from repro_torch.core import distributed as D
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts

    dev = _rank_device(device)
    state = _sharded_state(cfg, mesh, flat, seed, dev)
    bspec = partition.batch_pspec(mesh, batch)
    rows = batch_rows(cfg, mesh, batch=batch, seq=seq, step=step,
                      device=device)
    if float32:
        model = Model(cfg)

        def loss_fn(params, b):
            logits, aux = model.apply(transformer.unbound(params),
                                      {"tokens": b["tokens"]})
            loss = ts.cross_entropy(logits, b["labels"])
            return loss + aux, (loss, aux)
    else:
        loss_fn = ts.make_loss_fn(cfg)
    grads, (loss, _) = ts.sharded_backward(
        loss_fn, cfg, state["params"], rows, mesh, batch_spec=bspec,
        microbatches=microbatches,
        dtype=torch.float32 if float32 else torch.bfloat16)
    layout = ts.param_layout(cfg, mesh)
    return {"loss": float(loss),
            "grads": {n.replace(".", "/"): D._gather_full(g, mesh, layout[n])
                      for n, g in grads.items()}}
