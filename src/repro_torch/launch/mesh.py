"""Device meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the ranks of the current world, one rank a device; each
named dimension stands in for a ``jax.sharding.Mesh`` axis, and the
distributed modules (``core/distributed.py``) take their process groups
from it.  The world itself is the caller's: ``torch.distributed`` is told
its address, size and rank (``repro_torch.testing.world`` starts a local
one of spawned ranks).  Under ``gloo`` the mesh's device type is "cpu"
(the collectives go through host buffers), under ``nccl`` "cuda".

The reference's production shapes are kept as data: a single pod of
16 x 16 devices (axes data, model) and two such pods with a leading slow
"pod" axis.

Axis roles (as in the reference):
    pod    slow inter-pod axis: PaLD z-streaming (``pod_stream``)
    data   fast axis: rows
    model  fast axis: columns
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch.distributed as dist

__all__ = ["SINGLE_POD", "MULTI_POD", "MeshSpec", "mesh_shape",
           "production_spec", "make_production_mesh", "make_test_mesh",
           "mesh_device_type"]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


class MeshSpec(NamedTuple):
    """A mesh's shape and dimension names without a world: what the
    layout functions (``sharding.partition``) read, and what a rank of a
    ``testing.world.World`` turns into its ``DeviceMesh``."""
    shape: tuple
    axes: tuple


def mesh_shape(mesh) -> dict:
    """{dimension name: size} of a ``DeviceMesh`` or a :class:`MeshSpec`,
    in the mesh's order (the counterpart of ``jax.sharding.Mesh.shape``)."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(mesh.axes, (int(s) for s in mesh.shape)))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def production_spec(multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh as a :class:`MeshSpec` (what the
    dry run lays its cells over, no world needed)."""
    if multi_pod:
        return MeshSpec(MULTI_POD, ("pod", "data", "model"))
    return MeshSpec(SINGLE_POD, ("data", "model"))


def mesh_device_type() -> str:
    """The device type of a mesh over the current world: "cuda" under
    NCCL, else "cpu" (gloo's groups take host tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over
    the current world, rank r at the row-major position r.  Every rank
    calls it (it creates process groups); the world's size must be
    ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs an initialized "
                           "torch.distributed world (one rank a device)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"need a world of {n} ranks for mesh {shape}, "
                           f"have {dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model); needs a world of 256 or 512
    ranks."""
    return make_test_mesh(*production_spec(multi_pod))
