"""Elastic restart: resume a job on whatever healthy devices remain
(counterpart of ``repro.runtime.elastic``).

1. ``choose_mesh(n_devices)`` picks the largest (data, model) mesh that
   fits the surviving device count, holding the model axis at the largest
   power of two <= the target width (16), shrinking the data axis first.
   It returns a ``MeshSpec``: a ``torch.distributed`` world must be as
   large as its mesh, so the caller starts a world of ``prod(shape)``
   ranks (``testing.world.World``, or ``torchrun``) and each rank builds
   the ``DeviceMesh`` (``launch.mesh.make_test_mesh``).
2. ``resume(...)`` restores the latest complete checkpoint with the new
   mesh's layouts: the checkpoint format is mesh-free (one ``.npy`` file a
   global leaf and a manifest), and each rank reads only its blocks.  The
   data pipeline is a pure function of (seed, step), so the resumed run
   replays the exact stream from the restored step.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.core.distributed import P
from repro_torch.launch.mesh import MeshSpec, make_test_mesh
from repro_torch.sharding import partition

__all__ = ["TARGET_MODEL_AXIS", "choose_mesh", "state_shardings", "resume"]

TARGET_MODEL_AXIS = 16


def choose_mesh(n_devices: Optional[int] = None, *,
                target_model: int = TARGET_MODEL_AXIS) -> MeshSpec:
    """Largest (data, model) mesh fitting the surviving devices (default:
    the current world's ranks, else the CUDA devices)."""
    if n_devices is None:
        dist = torch.distributed
        n_devices = (dist.get_world_size() if dist.is_initialized()
                     else torch.cuda.device_count())
    n = n_devices
    assert n >= 1
    model = 1
    while model * 2 <= min(target_model, n):
        model *= 2
    return MeshSpec((n // model, model), ("data", "model"))


def state_shardings(cfg, mesh, abstract_state: Any = None,
                    specs: Any = None) -> dict:
    """The train state's layout on ``mesh``: {"params": {name:
    PartitionSpec}, "opt": {"m": the same, "v": the same}, "step": P()}.
    ``abstract_state`` (a train state whose "params" give the shapes) and
    ``specs`` ({"params": {name: logical spec}}) default to ``cfg``'s."""
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts

    if abstract_state is None and specs is None:
        psh = ts.param_layout(cfg, mesh)
    else:
        if specs is None:
            specs = {"params": transformer.logical_specs(cfg)}
        params = (abstract_state["params"] if abstract_state is not None
                  else transformer.Transformer(cfg, device="meta"))
        named = (dict(params.named_parameters())
                 if isinstance(params, torch.nn.Module) else params)
        psh = partition.param_shardings(
            specs["params"], cfg.sharding_profile, mesh,
            {n: tuple(t.shape) for n, t in named.items()})
    return {"params": psh, "opt": {"m": psh, "v": psh}, "step": P()}


def _template(cfg) -> dict:
    """The train state's structure, its leaves None (they name keys)."""
    from repro_torch.models import transformer

    with torch.device("meta"):
        names = [n for n, _ in
                 transformer.Transformer(cfg).named_parameters()]
    return {"params": dict.fromkeys(names),
            "opt": {m: dict.fromkeys(names) for m in ("m", "v")},
            "step": None}


def resume(cfg, ckpt_dir: str, template: Any = None, specs: Any = None,
           mesh=None, device="cuda"):
    """Restore the latest checkpoint in ``ckpt_dir`` onto ``mesh`` (a
    ``DeviceMesh`` of the current world; default: ``choose_mesh()`` over
    the world's ranks), every rank reading its blocks.  ``template``: the
    sharded train state's structure (its leaves only name the keys;
    default ``cfg``'s train state).  Returns (state, restored step,
    mesh); state is None, step -1, without a checkpoint."""
    if mesh is None:
        mesh = make_test_mesh(*choose_mesh())
    shardings = state_shardings(cfg, mesh, None, specs)
    state, step = checkpointer.restore_latest(
        ckpt_dir, _template(cfg) if template is None else template, device,
        shardings, mesh)
    return state, step, mesh
