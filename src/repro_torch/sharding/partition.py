"""Logical-axis -> mesh-axis partitioning rules (counterpart of
``repro.sharding.partition``).

Model code names every parameter dimension with a *logical* axis
(``models.transformer.logical_specs``).  This module maps those names to a
``PartitionSpec`` for a mesh and a sharding profile:

profile   embed-dim ('embed')        everything tensor-parallel ('heads',
                                     'ff', 'experts', 'vocab', 'mamba_*')
-------   -------------------------  ------------------------------------
dp        replicated                 'model'
fsdp      'data'                     'model'
zero3     ('pod','data') when the    'model'
          mesh has a pod axis

Optimizer state inherits the parameter specs (ZeRO: the moments are
sharded wherever the parameter is).  Batch dims shard over the
data-parallel axes.

Every function here is a pure function of the mesh's dimension names and
sizes: it takes a ``DeviceMesh`` or a ``launch.mesh.MeshSpec`` and returns
the port's ``PartitionSpec`` (``core.distributed.P``), entry for entry the
reference's.  The sharded train step (``train.train_step``) places each
rank's block of a leaf where the reference's ``NamedSharding`` places the
device at the same row-major mesh position, and computes replicated along
``model``: the reference's GSPMD constraint hooks (``ambient_mesh``,
``model_axis_size``, ``shard_dim``, ``seq_shard``, ``batch_shard``), which
steer the compiler's placement of activations, have no counterpart here.
"""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.core.distributed import PartitionSpec as P
from repro_torch.launch.mesh import mesh_shape

__all__ = ["TENSOR_AXES", "HEAD_AXES", "data_axes", "spec_to_pspec",
           "param_shardings", "batch_pspec", "cache_pspec"]

TENSOR_AXES = {"heads", "ff", "experts", "vocab", "mamba_inner", "mamba_heads"}
# head-count axes: shard over 'model' only when the count divides the axis
# (GQA kv heads usually don't: they stay replicated, Megatron-style)
HEAD_AXES = {"q_heads", "kv_heads"}


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def _map_axis(name, profile: str, mesh, dim_size: Optional[int] = None):
    sizes = mesh_shape(mesh)
    if name is None or name in ("layers", "embed_nosplit"):
        return None
    if name in HEAD_AXES:
        if "model" in sizes and dim_size is not None \
                and dim_size % sizes["model"] == 0:
            return "model"
        return None
    if name in TENSOR_AXES:
        return "model" if "model" in sizes else None
    if name == "embed":
        if profile == "dp":
            return None
        if profile == "zero3":
            ax = data_axes(mesh)
            return ax if len(ax) > 1 else (ax[0] if ax else None)
        return "data" if "data" in sizes else None
    raise ValueError(f"unknown logical axis {name!r}")


def spec_to_pspec(spec: tuple, profile: str, mesh, shape=None) -> P:
    sizes = shape if shape is not None else (None,) * len(spec)
    return P(*(_map_axis(a, profile, mesh, d) for a, d in zip(spec, sizes)))


def param_shardings(specs: Mapping[str, tuple], profile: str, mesh,
                    shapes: Optional[Mapping[str, tuple]] = None) -> dict:
    """{name: PartitionSpec} from a {name: logical spec} dictionary (a
    ``state_dict``'s names, ``logical_specs(cfg)``).  ``shapes`` ({name:
    shape}) lets the head-count axes decide divisibility; without it
    they stay replicated."""
    if shapes is not None and set(shapes) != set(specs):
        raise ValueError(f"specs and shapes name other leaves: "
                         f"{sorted(set(specs) ^ set(shapes))}")
    return {k: spec_to_pspec(s, profile, mesh,
                             None if shapes is None else tuple(shapes[k]))
            for k, s in specs.items()}


def batch_pspec(mesh, batch_size: int) -> P:
    """Shard the batch dim over every data axis that divides it."""
    sizes = mesh_shape(mesh)
    axes = []
    for a in data_axes(mesh):
        if batch_size % sizes[a] == 0:
            axes.append(a)
            batch_size //= sizes[a]
    return P(tuple(axes) if axes else None)


def cache_pspec(mesh, batch: int, seq: int, kv_heads: int) -> P:
    """KV-cache (B, S, KV, HD) sharding: batch over data axes; the KV-head
    dim over 'model' when divisible, else the sequence dim (emergent
    sequence-parallel decode attention; DESIGN.md §6.3)."""
    bspec = batch_pspec(mesh, batch)
    m = mesh_shape(mesh).get("model", 1)
    if kv_heads % m == 0:
        return P(bspec[0] if bspec else None, None, "model", None)
    if seq % m == 0:
        return P(bspec[0] if bspec else None, "model", None, None)
    return P(bspec[0] if bspec else None, None, None, None)
