"""Checkpointing: atomic save, restore, pruning, background writes
(counterpart of ``repro.checkpoint.checkpointer``, on the same disk layout,
so each package reads the other's checkpoints).

Layout:  <dir>/step_<N>/            N zero-padded to 8 digits
            manifest.json       {"step": N, "leaves": {key: {"file",
                                 "shape", "dtype"}}}
            <flat-key>.npy      one file per leaf, the key's "/" as "__"

Keys are a tree's paths joined by "/": dictionary keys (sorted, as JAX
flattens them), list and tuple indices, and the dotted names of a
``state_dict`` (``blocks.0.mixer.wq`` is the key ``blocks/0/mixer/wq``; a
model's parameter names follow the reference's param tree, so the keys
are the same in both packages).  An ``nn.Module`` saves as its
``state_dict``.

Atomicity: leaves are written into ``step_<N>.tmp`` and the directory is
renamed only after the manifest lands; ``available_steps`` ignores
``.tmp`` directories and directories without a manifest.

bfloat16: NumPy has no bfloat16 type, and the reference's files hold
bfloat16 leaves as 2-byte void words (descr ``'<V2'``) with ``"dtype":
"bfloat16"`` in the manifest.  The port writes such a leaf byte for byte
the same way and reads one back as its raw 16-bit words viewed as
``torch.bfloat16``, so no ``ml_dtypes`` is needed.

Device: ``restore``, ``restore_latest`` and ``read_leaf`` put the leaves
on the card unless the caller passes ``device="cpu"``, and raise without
a GPU (``core.engine.resolve_device``), as every entry point of the port
does.

Sharded trees (the sharded train state, ``train.train_step``): given
``shardings`` (a tree of ``PartitionSpec``s mirroring the tree; a leaf it
does not name is whole on every rank) and ``mesh`` (a ``DeviceMesh``,
every rank calling), ``save`` gathers each leaf to the mesh's first rank,
which writes the same mesh-free layout as a single-device save while the
others wait; ``restore`` has each rank read only its own blocks of each
``.npy`` leaf (``np.load(mmap_mode="r")``), so a checkpoint written from
any mesh restores onto any other (elastic resume) and host memory holds
a block at a time.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import distributed as D

__all__ = ["SEP", "save", "available_steps", "read_manifest", "read_leaf", "restore",
           "restore_latest", "prune", "AsyncCheckpointer"]

SEP = "/"
_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, D.PartitionSpec):   # a leaf of a shardings tree
        return {prefix: tree}
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        items = sorted((str(k).replace(".", SEP), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return flat


def _to_host(leaf) -> np.ndarray | torch.Tensor:
    """A CPU copy of a leaf (a tensor stays a tensor: bfloat16 has no
    NumPy type)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _write_leaf(path: str, leaf) -> tuple[list, str]:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        words = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(words.shape)})
            f.write(words.tobytes())
        return list(words.shape), _BF16
    arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
           else np.asarray(leaf))
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _write(directory: str, step: int, flat) -> str:
    """Write the leaves of ``flat`` ({key: leaf}, an iterable of pairs)
    atomically; the final checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, leaf in flat:
        fname = key.replace(SEP, "__") + ".npy"
        shape, dtype = _write_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"][key] = {"file": fname, "shape": shape,
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _gathered(tree: Any, shardings: Any, mesh):
    """(key, the global leaf) on the mesh's first rank, leaf by leaf, as
    the ranks gather it; (key, None) on the others."""
    specs = _flatten(shardings) if shardings is not None else {}
    for key, leaf in _flatten(tree).items():
        spec = specs.get(key, D.P())
        yield key, D._gather_root(leaf, mesh, spec)


def _is_root(mesh) -> bool:
    group = D._group(mesh, D._names(mesh))
    return torch.distributed.get_rank() == \
        torch.distributed.get_process_group_ranks(group)[0]


def _device_of(tree) -> torch.device:
    for leaf in _flatten(tree).values():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def save(directory: str, step: int, tree: Any, shardings: Any = None,
         mesh=None) -> Optional[str]:
    """Blocking atomic save.  Returns the final checkpoint path.  With a
    ``mesh``, ``tree`` holds this rank's blocks under ``shardings`` and
    every rank calls: the first rank writes the global leaves, and every
    rank returns when the checkpoint is complete (or raises, every rank,
    when the write failed)."""
    if mesh is None:
        return _write(directory, step, _flatten(tree).items())
    root = _is_root(mesh)

    def body():
        leaves = _gathered(tree, shardings, mesh)
        if root:
            return _write(directory, step, leaves)
        for _ in leaves:
            pass
        return os.path.join(directory, f"step_{step:08d}")

    return D._agreed(mesh, _device_of(tree), body)


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name[5:]))
    return sorted(steps)


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def read_leaf(path: str, key: str, device="cuda",
              manifest: Optional[dict] = None, mesh=None,
              spec=None) -> torch.Tensor:
    """One leaf of the checkpoint at ``path`` as a tensor on ``device``;
    with ``mesh`` and ``spec``, this rank's block of it (read from the
    memory-mapped file: the rest is never loaded)."""
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    meta = (manifest or read_manifest(path))["leaves"][key]
    # with a mesh, a copy-on-write map: only the block is read
    arr = np.load(os.path.join(path, meta["file"]),
                  mmap_mode="c" if mesh is not None else None)
    if list(arr.shape) != list(meta["shape"]):
        raise ValueError(f"{path}: leaf {key!r} has shape {arr.shape}, "
                         f"the manifest says {meta['shape']}")
    if meta["dtype"] == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if mesh is not None:
        t = D._block(t, mesh, spec or (), f"{path}: leaf {key!r}").clone()
    return t.to(dev)


def restore(path: str, template: Any, device="cuda", shardings: Any = None,
            mesh=None) -> Any:
    """Restore into the structure of ``template``: a tree of dictionaries,
    lists and tuples (its leaves only name the keys) or a ``state_dict``,
    whose dotted names are the keys' paths.  Every leaf lands on
    ``device``.  With a ``mesh``: each leaf is this rank's block under
    ``shardings`` (a tree of ``PartitionSpec``s mirroring the template;
    a leaf it does not name is read whole)."""
    from repro_torch.core.engine import resolve_device

    device = resolve_device(device)
    manifest = read_manifest(path)
    specs = _flatten(shardings) if shardings is not None else {}

    def build(node, prefix):
        if isinstance(node, Mapping):
            out = {k: build(v, f"{prefix}{SEP}{str(k).replace('.', SEP)}"
                            if prefix else str(k).replace(".", SEP))
                   for k, v in node.items()}
            return type(node)(out)
        if isinstance(node, (list, tuple)):
            vals = [build(v, f"{prefix}{SEP}{i}" if prefix else str(i))
                    for i, v in enumerate(node)]
            return type(node)(vals)
        return read_leaf(path, prefix, device, manifest, mesh,
                         specs.get(prefix))

    return build(template, "")


def restore_latest(directory: str, template: Any, device="cuda",
                   shardings: Any = None, mesh=None):
    from repro_torch.core.engine import resolve_device

    device = resolve_device(device)
    steps = available_steps(directory)
    if not steps:
        return None, -1
    step = steps[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    return restore(path, template, device, shardings, mesh), step


def prune(directory: str, keep: int = 3) -> None:
    for step in available_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{step:08d}"))


class AsyncCheckpointer:
    """Snapshot to host memory, then write on a background thread: the
    caller waits only for the device-to-host copy.  With a ``mesh`` (every
    rank calling ``save`` and ``wait``): the snapshot is the gather of the
    blocks to the mesh's first rank, which alone writes and prunes, and
    ``wait`` returns on every rank once its write is done."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.directory = directory
        self.keep = keep
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            torch.distributed.barrier(
                group=D._group(self.mesh, D._names(self.mesh)))

    def save(self, step: int, tree: Any, shardings: Any = None) -> None:
        self.wait()
        if self.mesh is None:
            host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        else:
            host = dict(_gathered(tree, shardings, self.mesh))
            if not _is_root(self.mesh):
                return

        def work():
            _write(self.directory, step, host.items())
            prune(self.directory, self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
