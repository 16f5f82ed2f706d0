"""Distributed PaLD over ``torch.distributed`` (counterpart of
``repro.core.distributed``).

The reference maps the two passes onto a TPU mesh under ``shard_map``; the
port runs them SPMD over the ranks of a ``torch.distributed`` world, one
rank a device: every rank calls the same function with the same global
input and gets the global result, as the reference's single controller
does.  A ``DeviceMesh`` with named dimensions stands in for the
``jax.sharding.Mesh``, and process groups over its dimensions for the
``jax.lax`` collective axes (the helpers below: ``all_gather(...,
tiled=True)`` along one or more dimensions, ``ppermute`` one step forward
along a dimension, ``axis_index``).  Each rank's compute is the same
rectangular CUDA kernels the single-device paths run
(``kernels/ops.focus_general`` / ``cohesion_general``, through
``PaldPlan.focus_general`` / ``cohesion_general``); the index tiebreak of
``ties="ignore"`` takes the shard's global offsets (``xw_offsets``), so no
(m, n) tiebreak array is built.

Strategies (the reference's)
----------------------------
allgather     D row-sharded; one all-gather of D; row-parallel.  Comm n^2
              words a rank, memory n^2 a rank.
ring          D row-sharded; row blocks rotate one step a pass step; comm
              n^2 words a rank, memory O(n^2/p).  The next block's transfer
              runs while the kernels work on this one.
2d            D block-sharded over (rows x cols) mesh dimensions; gathers
              along each; comm ~3 n^2/sqrt(p) words a rank.
2d+pod-stream as 2d, the slow ``pod`` dimension streamed: the per-pod row
              slab rotates across pods while both passes consume it.

The feature strategies (``pald_distributed_from_features``) move the
(n, d) features instead of D, and each rank computes its distance tiles
with ``features.masked_dist_tile``.

A failure in one rank is a failure of every rank: after the body the
ranks check for one (one all-reduce), and every rank raises, so none
goes on into a collective its peers left.

Backends.  Under ``nccl`` the collectives take the CUDA tensors as they
are.  Under ``gloo`` (several ranks sharing one card: NCCL refuses two
ranks on one device) every collective goes through host buffers: a copy to
the host, the transfer, a copy back; the bytes copied are counted per rank
(:func:`staged_bytes`).  bfloat16 payloads travel as their bytes (gloo
has no bfloat16 or int16 transfers).  Every collective reports its kind
and its operand and result bytes to the active recorders
(``launch.cost_analysis.record_collectives``), whatever the backend, so
the dry run's per-rank counts can be held to what a step puts on the
wire.  Every process group this module creates has the finite timeout
:data:`TIMEOUT_S` (``$REPRO_TORCH_DIST_TIMEOUT``), so a rank that fails
cannot leave its peers blocked for longer.

All strategies return the global C, on every rank, as ``pald.cohesion``
would on one device; ``comm_dtype=torch.bfloat16`` casts D to bfloat16 for
the collectives and back to float32 before the kernels (exact: every
bfloat16 value is a float32 value), so the result is single-device PaLD on
the bfloat16-cast D, under the same ``ties``.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from . import engine as _engine
from .features import masked_dist_tile

__all__ = ["pald_distributed", "pald_distributed_from_features",
           "shard_map_compat", "PartitionSpec", "P", "staged_bytes",
           "reset_staged_bytes", "TIMEOUT_S"]

# seconds a collective of this module's groups may wait for a peer
TIMEOUT_S = float(os.environ.get("REPRO_TORCH_DIST_TIMEOUT", "300"))


# ---------------------------------------------------------------------------
# collective helpers: the counterparts of jax.lax.all_gather(tiled=True),
# ppermute (one step forward) and axis_index over a DeviceMesh
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """How a global array is split over a mesh, one entry per array
    dimension: None (whole), a mesh dimension's name, or a tuple of names
    (split over their row-major product), as ``jax.sharding.PartitionSpec``;
    a tuple of one name is that name, as there."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))


P = PartitionSpec

_STAGED = [0]      # bytes copied between the card and the host (gloo)
_GROUPS: dict = {}  # (id(mesh), dims) -> (mesh, group)
_RECORDERS: list = []  # objects with .add(kind, operand, result, ranks)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _note(kind: str, operand: int, result: int, group) -> None:
    """Report one collective of this rank to the active recorders: its
    kind (the reference's names: "all-gather", "all-reduce",
    "all-to-all", "collective-permute"), the bytes this rank puts in and
    gets out, and the global ranks of its group."""
    if _RECORDERS:
        ranks = dist.get_process_group_ranks(group)
        for r in _RECORDERS:
            r.add(kind, operand, result, ranks)


def staged_bytes() -> int:
    """Bytes this rank copied between device and host for collectives
    since the last :func:`reset_staged_bytes` (gloo with CUDA tensors)."""
    return _STAGED[0]


def reset_staged_bytes() -> None:
    _STAGED[0] = 0


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> dict:
    return dict(zip(_names(mesh), mesh.mesh.shape))


def _dims(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _in_order(mesh, axes) -> tuple[str, ...]:
    """``axes`` in the mesh's order (the row-major order of the ranks)."""
    want = _dims(axes)
    unknown = [a for a in want if a not in _names(mesh)]
    if unknown:
        raise ValueError(f"mesh dimensions {unknown} not in the mesh's "
                         f"{_names(mesh)}")
    return tuple(a for a in _names(mesh) if a in want)


def _axis_size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in _dims(axes))


def _axis_index(mesh, axes) -> int:
    """This rank's row-major position over the mesh dimensions ``axes``
    (in the mesh's order), as ``jax.lax.axis_index``."""
    coord = dict(zip(_names(mesh), mesh.get_coordinate()))
    sizes = _sizes(mesh)
    i = 0
    for a in _in_order(mesh, axes):
        i = i * sizes[a] + coord[a]
    return i


def _group(mesh, axes):
    """The process group of the ranks that share this rank's coordinates
    outside ``axes``, ordered row-major over ``axes`` (global rank order).
    Created on first use for every such set of ranks, by every rank in
    the same order (the distributed bodies run the same code everywhere),
    with the finite :data:`TIMEOUT_S`."""
    dims = _in_order(mesh, axes)
    key = (id(mesh), dims)
    if key not in _GROUPS:
        names = _names(mesh)
        ranks = mesh.mesh
        order = [names.index(a) for a in names if a not in dims] + \
                [names.index(a) for a in dims]
        q = math.prod(ranks.shape[names.index(a)] for a in dims)
        sets = ranks.permute(order).reshape(-1, q).tolist()
        group, _ = dist.new_subgroups_by_enumeration(
            sets, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) != "nccl"


def _to_wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        _STAGED[0] += x.numel() * x.element_size()
        x = x.cpu()
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def _from_wire(x: torch.Tensor, like: torch.Tensor,
               staged: bool) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        x = x.view(torch.bfloat16)
    if staged:
        _STAGED[0] += x.numel() * x.element_size()
        x = x.to(like.device)
    return x


def _all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``: the blocks of
    the ranks along ``axes`` concatenated on ``dim`` in row-major order."""
    group = _group(mesh, axes)
    staged = _staged(x, group)
    w = _to_wire(x, staged)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    _note("all-gather", _nbytes(w), len(parts) * _nbytes(w), group)
    dist.all_gather(parts, w, group=group)
    return _from_wire(torch.cat(parts, dim=dim), x, staged)


class _Shift:
    """``jax.lax.ppermute(x, axis, [(j, j+1 mod q)])`` started now and
    finished by :meth:`result`, so the transfer runs beside the kernels
    launched in between (under gloo the host copies are synchronous)."""

    def __init__(self, x: torch.Tensor, mesh, axis: str):
        group = _group(mesh, axis)
        ranks = dist.get_process_group_ranks(group)
        q, me = len(ranks), _axis_index(mesh, axis)
        self.like, self.reqs = x, []
        if q == 1:
            self.out = x
            return
        self.staged = _staged(x, group)
        w = _to_wire(x, self.staged)
        self.buf = torch.empty_like(w)
        _note("collective-permute", _nbytes(w), _nbytes(w), group)
        self.reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, ranks[(me + 1) % q], group),
            dist.P2POp(dist.irecv, self.buf, ranks[(me - 1) % q], group)])
        self.send = w  # kept alive until the transfer completes

    def result(self) -> torch.Tensor:
        if not self.reqs:
            return self.out
        for r in self.reqs:
            r.wait()
        return _from_wire(self.buf, self.like, self.staged)


def _all_reduce(x: torch.Tensor, mesh, axes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``jax.lax.psum(x, axes)`` (``op=MAX``: ``pmax``) as a new tensor:
    one all-reduce over the ranks along ``axes``; ``x`` on a device the
    group's backend takes (the host under gloo)."""
    group = _group(mesh, axes)
    w = x.detach().clone()
    _note("all-reduce", _nbytes(w), _nbytes(w), group)
    dist.all_reduce(w, op=op, group=group)
    return w


def _any(flag: bool, mesh, device) -> bool:
    """True on every rank when ``flag`` is true on any rank of ``mesh``
    (one all-reduce): how the ranks agree that one of them failed."""
    group = _group(mesh, _names(mesh))
    on = device if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=on)
    return bool(_all_reduce(t, mesh, _names(mesh), dist.ReduceOp.MAX).item())


def _agreed(mesh, dev, fn):
    """``fn()`` on every rank, then one all-reduce: if it raised on any
    rank, every rank raises (its own error, or one naming the failure
    elsewhere), so no rank goes on into a collective its peers left."""
    err = None
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 - re-raised below, everywhere
        err = exc
    if _any(err is not None, mesh, dev):
        if err is not None:
            raise err
        raise RuntimeError("the distributed call failed on another rank of "
                           "the mesh")
    return out


def _entry_axes(entry) -> tuple[str, ...]:
    return () if entry is None else _dims(entry)


def _local_block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            q = _axis_size(mesh, axes)
            m = x.shape[dim] // q
            x = x.narrow(dim, _axis_index(mesh, axes) * m, m)
    return x.contiguous()


def _global(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global array from every rank's block under ``spec``."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            x = _all_gather(x, mesh, axes, dim=dim)
    return x


# ---------------------------------------------------------------------------
# exact blocks (the sharded training's layouts): a dimension splits only
# when its size divides the product of its mesh dimensions, as
# ``jax.device_put(x, NamedSharding(mesh, spec))`` requires
# ---------------------------------------------------------------------------
def _spec_axes(spec) -> set:
    return {a for entry in spec for a in _entry_axes(entry)}


def _check_divides(shape, mesh, spec, what="array") -> None:
    if len(spec) > len(shape):
        raise ValueError(f"{what}: spec {tuple(spec)} has more entries than "
                         f"its {len(shape)} dimensions")
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        q = _axis_size(mesh, axes) if axes else 1
        if shape[dim] % q:
            raise ValueError(
                f"{what} of shape {tuple(shape)}: spec {tuple(spec)} implies "
                f"that the global size of its dimension {dim} should be "
                f"divisible by {q}, but it is equal to {shape[dim]}")


def _coord(mesh) -> dict:
    """This rank's coordinates, {mesh dimension name: index}."""
    return dict(zip(_names(mesh), mesh.get_coordinate()))


def _block(x: torch.Tensor, mesh, spec, what="array") -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (a view), the
    block ``jax.device_put`` gives the device at the same row-major mesh
    position; raises where a dimension does not divide, as it does."""
    _check_divides(x.shape, mesh, spec, what)
    return _block_at(x, mesh, spec, _coord(mesh))


def _is_owner(mesh, spec) -> bool:
    """True on one rank of each set of ranks that hold the same block
    under ``spec``: the one at coordinate 0 on every mesh dimension the
    spec does not name."""
    named = _spec_axes(spec)
    return all(c == 0 for a, c in _coord(mesh).items() if a not in named)


def _gather_full(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global array from every rank's block under ``spec``, on every
    rank: one all-gather a split dimension, staged through the host once
    under gloo."""
    dims = [(d, _entry_axes(e)) for d, e in enumerate(spec) if _entry_axes(e)]
    if not dims:
        return x
    staged = _staged(x, _group(mesh, dims[0][1]))
    w = _to_wire(x, staged)
    for d, axes in dims:
        group = _group(mesh, axes)
        parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
        _note("all-gather", _nbytes(w), len(parts) * _nbytes(w), group)
        dist.all_gather(parts, w.contiguous(), group=group)
        w = torch.cat(parts, dim=d)
    return _from_wire(w, x, staged)


def _block_at(x: torch.Tensor, mesh, spec, coord: dict) -> torch.Tensor:
    """The block of the global ``x`` under ``spec`` that the rank at mesh
    coordinates ``coord`` ({dimension name: index}) holds (a view)."""
    sizes = _sizes(mesh)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            i = 0
            for a in _in_order(mesh, axes):
                i = i * sizes[a] + int(coord[a])
            m = x.shape[dim] // _axis_size(mesh, axes)
            x = x.narrow(dim, i * m, m)
    return x


def _sum_block(g: torch.Tensor, mesh, axes, spec,
               dtype=torch.float32) -> torch.Tensor:
    """This rank's block under ``spec`` of the sum, in ``dtype``, of the
    global ``g`` of every rank along ``axes`` (none: ``g`` itself), a new
    tensor.  One all-to-all: each rank sends every peer along ``axes``
    that peer's block of its ``g`` (bfloat16 as its bytes), and adds the
    blocks it receives in ``dtype`` in rank order, as a sum of microbatch
    gradients accumulates.  Under gloo the blocks travel and are summed on
    the host, and only this rank's sum goes back to the card."""
    _check_divides(g.shape, mesh, spec)
    me = _coord(mesh)
    axes = _in_order(mesh, axes) if axes else ()
    if not axes:
        return _block_at(g, mesh, spec, me).to(dtype, copy=True)
    import numpy as np

    sizes = _sizes(mesh)
    group = _group(mesh, axes)
    chunks = []
    for j in range(_axis_size(mesh, axes)):   # group ranks: row-major
        peer = dict(me, **dict(zip(axes, np.unravel_index(
            j, tuple(sizes[a] for a in axes)))))
        chunks.append(_block_at(g, mesh, spec, peer))
    send = torch.stack(chunks)
    staged = _staged(send, group)
    w = _to_wire(send, staged)
    recv = torch.empty_like(w)
    _note("all-to-all", _nbytes(w), _nbytes(recv), group)
    dist.all_to_all_single(recv, w, group=group)
    parts = _from_wire(recv, send, False)
    total = parts[0].to(dtype, copy=True)
    for part in parts[1:]:
        total.add_(part.to(dtype))
    if staged:
        _STAGED[0] += total.numel() * total.element_size()
        total = total.to(g.device)
    return total


def _gather_root(x: torch.Tensor, mesh, spec):
    """Rank 0 of ``mesh``: the global array (on the host) whose block under
    ``spec`` each rank holds; the other ranks: None.  One gather over the
    whole mesh; a block that several ranks hold is taken once."""
    import numpy as np

    group = _group(mesh, _names(mesh))
    root = dist.get_process_group_ranks(group)[0]
    me = dist.get_rank() == root
    if not _spec_axes(spec):                  # every rank holds it whole
        return x.detach().cpu() if me else None
    nccl = dist.get_backend(group) == "nccl"
    w = x.contiguous() if nccl else _to_wire(x, x.is_cuda)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    # a gather to one rank, reported as an all-gather that only the root
    # receives: the root's result is every block, another rank's its own
    _note("all-gather", _nbytes(w), _nbytes(w) * (len(parts) if me else 1),
          group)
    dist.gather(w, parts if me else None, dst=root, group=group)
    if not me:
        return None
    sizes = _sizes(mesh)
    shape = list(x.shape)
    for dim, entry in enumerate(spec):
        if _entry_axes(entry):
            shape[dim] *= _axis_size(mesh, _entry_axes(entry))
    full = torch.empty(shape, dtype=x.dtype)
    for pos, part in enumerate(parts):
        coord = dict(zip(sizes, np.unravel_index(pos, tuple(sizes.values()))))
        if not any(coord[a] for a in sizes if a not in _spec_axes(spec)):
            _block_at(full, mesh, spec, coord).copy_(_from_wire(part, x, False))
    return full


def shard_map_compat(body, *, mesh, in_specs, out_specs):
    """The SPMD counterpart of ``jax.shard_map``: a function of global
    arrays that hands each rank its blocks under ``in_specs`` (one
    ``PartitionSpec``, or a tuple of them for several arguments), runs
    ``body`` on them, and gathers the global outputs under ``out_specs``
    on every rank."""
    single_in = isinstance(in_specs, PartitionSpec)
    single_out = isinstance(out_specs, PartitionSpec)

    def fn(*args):
        specs = (in_specs,) if single_in else tuple(in_specs)
        out = body(*(_local_block(a, mesh, s) for a, s in zip(args, specs)))
        if single_out:
            return _global(out, mesh, out_specs)
        return tuple(_global(o, mesh, s) for o, s in zip(out, out_specs))

    return fn


# ---------------------------------------------------------------------------
# weights of a row block
# ---------------------------------------------------------------------------
def _weights_rows(U_rows: torch.Tensor, row_offset: int,
                  n_valid) -> torch.Tensor:
    """W = 1/U for a row block: zero on the global diagonal (global row ==
    column), where U is 0, and on padding."""
    m, n = U_rows.shape
    rows = row_offset + torch.arange(m, device=U_rows.device)
    cols = torch.arange(n, device=U_rows.device)
    zero = (rows[:, None] == cols[None, :]) | (U_rows == 0)
    W = torch.where(zero, 0.0, 1.0 / torch.where(U_rows == 0, 1.0, U_rows))
    if n_valid is not None:
        W = W * ((rows < n_valid)[:, None] & (cols < n_valid)[None, :])
    return W.to(torch.float32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# 1-D strategies: D row-sharded over every mesh dimension
# ---------------------------------------------------------------------------
def _allgather_body(Dloc, *, mesh, axis, n_valid, plan):
    m = Dloc.shape[0]
    Dall = _f32(_all_gather(Dloc, mesh, axis))                # (n, n)
    Dloc = _f32(Dloc)
    off = _axis_index(mesh, axis) * m
    U = plan.focus_general(Dloc, Dall, Dloc)                  # (m, n)
    W = _weights_rows(U, off, n_valid)
    return plan.cohesion_general(Dloc, Dall, Dloc, W, xw_offsets=(off, 0))


def _ring_steps(Dloc, mesh, axis, p, step):
    """Rotate ``Dloc``'s block around the ring for p steps, calling
    ``step(s, blk)`` on the block held at step s (the block of rank
    (r - s) mod p); the next block's transfer runs during the step."""
    blk = Dloc
    for s in range(p):
        nxt = _Shift(blk, mesh, axis) if s < p - 1 else None
        try:
            step(s, blk)
        finally:  # a failed step still completes the transfer it started
            if nxt is not None:
                blk = nxt.result()


def _ring_body(Dloc, *, mesh, axis, p, n_valid, plan):
    m, n = Dloc.shape
    r = _axis_index(mesh, axis)
    Df = _f32(Dloc)

    def owner_cols(s):
        # after s forward shifts we hold the block originally on (r - s) % p
        return ((r - s) % p) * m

    U = torch.zeros((m, n), dtype=torch.float32, device=Dloc.device)

    def f_step(s, blk):
        off = owner_cols(s)
        U[:, off:off + m] = plan.focus_general(
            Df, _f32(blk), Df[:, off:off + m].contiguous())

    _ring_steps(Dloc, mesh, axis, p, f_step)
    W = _weights_rows(U, r * m, n_valid)
    C = torch.zeros((m, n), dtype=torch.float32, device=Dloc.device)

    def c_step(s, blk):
        off = owner_cols(s)
        C.add_(plan.cohesion_general(
            Df, _f32(blk), Df[:, off:off + m].contiguous(),
            W[:, off:off + m].contiguous(), xw_offsets=(r * m, off)))

    _ring_steps(Dloc, mesh, axis, p, c_step)
    return C


# ---------------------------------------------------------------------------
# feature-sharded 1-D strategies: X row-sharded, distances computed per rank
#
# Moving the (n, d) features instead of the (n, n) distances shrinks every
# collective by n/d.  Padded feature rows are zeros, which every metric
# maps to a finite distance, so each rank re-imposes the +inf / zero
# diagonal contract by global index (``masked_dist_tile``).
# ---------------------------------------------------------------------------
def _feat_allgather_body(Xloc, *, mesh, axis, metric, n_valid, plan):
    m = Xloc.shape[0]
    Xall = _all_gather(Xloc, mesh, axis)                      # (n, d)
    n = Xall.shape[0]
    nv = n if n_valid is None else n_valid
    off = _axis_index(mesh, axis) * m
    Dall = masked_dist_tile(Xall, Xall, metric, 0, 0, nv)     # (n, n)
    Dloc = Dall[off:off + m].contiguous()                     # own rows
    U = plan.focus_general(Dloc, Dall, Dloc)
    W = _weights_rows(U, off, n_valid)
    return plan.cohesion_general(Dloc, Dall, Dloc, W, xw_offsets=(off, 0))


def _feat_ring_body(Xloc, *, mesh, axis, p, metric, n_valid, plan):
    m = Xloc.shape[0]
    r = _axis_index(mesh, axis)
    # the z axis of both passes needs every point's features: gathering X
    # is the one O(n d) collective; the ring moves (m, d) blocks
    Xall = _all_gather(Xloc, mesh, axis)                      # (n, d)
    n = Xall.shape[0]
    nv = n if n_valid is None else n_valid
    Dloc = masked_dist_tile(Xloc, Xall, metric, r * m, 0, nv)  # (m, n)

    def owner_off(s):
        return ((r - s) % p) * m

    U = torch.zeros((m, n), dtype=torch.float32, device=Xloc.device)

    def f_step(s, xblk):
        off = owner_off(s)
        Dblk = masked_dist_tile(xblk, Xall, metric, off, 0, nv)  # recomputed
        U[:, off:off + m] = plan.focus_general(
            Dloc, Dblk, Dloc[:, off:off + m].contiguous())

    _ring_steps(Xloc, mesh, axis, p, f_step)
    W = _weights_rows(U, r * m, n_valid)
    C = torch.zeros((m, n), dtype=torch.float32, device=Xloc.device)

    def c_step(s, xblk):
        off = owner_off(s)
        Dblk = masked_dist_tile(xblk, Xall, metric, off, 0, nv)
        C.add_(plan.cohesion_general(
            Dloc, Dblk, Dloc[:, off:off + m].contiguous(),
            W[:, off:off + m].contiguous(), xw_offsets=(r * m, off)))

    _ring_steps(Xloc, mesh, axis, p, c_step)
    return C


# ---------------------------------------------------------------------------
# 2-D strategy (comm-optimal), optionally streaming over the pod dimension
# ---------------------------------------------------------------------------
def _2d_body(Dblk, *, mesh, row_axes, col_axis, stream_axis, n_valid, plan):
    mr, mc = Dblk.shape
    gathered_rows = tuple(a for a in row_axes if a != stream_axis)
    # row offset of this rank's X block in the global ordering
    roff = _axis_index(mesh, row_axes) * mr
    # D rows of the local X block, all columns: gather along the columns
    Grow = _f32(_all_gather(Dblk, mesh, col_axis, dim=1))      # (mr, n)
    if stream_axis is None:
        # every row: the slab is all rows of the local column block
        slab = _all_gather(Dblk, mesh, row_axes, dim=0)       # (n, mc)
        nsteps, slab_rows = 1, slab.shape[0]
        pod_idx = 0
    else:
        # gather along the fast row dimensions only; pod slabs rotate
        slab = (_all_gather(Dblk, mesh, gathered_rows, dim=0)
                if gathered_rows else Dblk)
        nsteps, slab_rows = _axis_size(mesh, stream_axis), slab.shape[0]
        pod_idx = _axis_index(mesh, stream_axis)
    Df = _f32(Dblk)

    def slab_row_offset(s):
        return ((pod_idx - s) % nsteps) * slab_rows

    def steps(step):
        blk = slab
        for s in range(nsteps):
            nxt = (_Shift(blk, mesh, stream_axis)
                   if stream_axis is not None and s < nsteps - 1 else None)
            try:
                step(s, blk)
            finally:
                if nxt is not None:
                    blk = nxt.result()

    # pass 1: U[Xi, Yj] = sum over z of the slab chunks; slab holds
    # D[chunk rows, Yj], and by symmetry slab.T = d(y in Yj, z in chunk)
    U = torch.zeros((mr, mc), dtype=torch.float32, device=Dblk.device)

    def f_step(s, blk):
        zoff = slab_row_offset(s)
        dxz = Grow[:, zoff:zoff + slab_rows].contiguous()
        U.add_(plan.focus_general(dxz, _f32(blk.T), Df))

    steps(f_step)
    # the weights need whole U rows: gather along the columns
    Urow = _all_gather(U, mesh, col_axis, dim=1)               # (mr, n)
    Wrow = _weights_rows(Urow, roff, n_valid)

    # pass 2: C[Xi, Zj] = sum over y of the slab chunks
    C = torch.zeros((mr, mc), dtype=torch.float32, device=Dblk.device)

    def c_step(s, blk):
        yoff = slab_row_offset(s)
        dxy = Grow[:, yoff:yoff + slab_rows].contiguous()
        w = Wrow[:, yoff:yoff + slab_rows].contiguous()
        C.add_(plan.cohesion_general(Df, _f32(blk), dxy, w,
                                     xw_offsets=(roff, yoff)))

    steps(c_step)
    return C


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def _device_of(device) -> torch.device:
    dev = _engine.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pald_distributed(
    D,
    mesh,
    *,
    strategy: str = "auto",
    row_axes: Sequence[str] | None = None,
    col_axis: str | None = None,
    pod_stream: bool | None = None,
    normalize: bool = True,
    impl: str | None = None,
    comm_dtype=None,
    block: int | str = "auto",
    block_z: int | str = "auto",
    ties: str | None = None,
    weight=None,
    on_error: str = "raise",
    device="cuda",
) -> torch.Tensor:
    """Compute the PaLD cohesion matrix on a device mesh.

    Every rank of the mesh's world calls it with the same global D and
    gets the same global C.

    Args:
        D: global (n, n) distance matrix (numpy array or tensor); padded
            internally with +inf to shard evenly, each rank taking its
            block under the strategy.
        mesh: the ``DeviceMesh`` to run on (``launch.mesh``).
        strategy: "allgather", "ring", "2d", or "auto" ("2d" on a mesh of
            >= 2 dimensions, else "ring"); "2d" needs a 2-D mesh,
            optionally with ``pod_stream=True`` on the slow axis.
        row_axes / col_axis: which mesh dimensions shard rows / columns;
            default all-but-last / last.
        pod_stream: stream the inter-pod row slab ("2d" only; default: a
            mesh with a "pod" dimension streams).
        normalize: apply the 1/(n-1) factor, like ``pald.cohesion``.
        impl: each rank's kernels: "cuda" (the hand-written kernels) or
            "torch" (the plain versions); default the device's.
        comm_dtype: ``torch.bfloat16`` moves D in bfloat16 (halving every
            collective) and compares in float32 after the cast back, which
            is exact: the result is single-device PaLD on the
            bfloat16-cast D under the same ``ties`` (distances that
            collide in bfloat16 become exact ties, governed by ``ties``).
        block / block_z: each rank's plain-version tiles; "auto" resolves
            them from the tuning cache, keyed by the per-rank row extent.
        ties / weight: the weight functional of every shard body (see
            ``pald.cohesion``).
        on_error: "raise" (default) or "fallback": a shard body's failing
            kernel call walks ``core/resilience.guarded_general`` (on the
            card every rung past the kernels is unavailable).
        device: "cuda" (default; the rank's current CUDA device) or "cpu".

    Returns:
        (n, n) float32 C on ``device``, equal to single-device
        ``pald.cohesion(D, ties=ties)`` for any strategy.

    Raises:
        ValueError: unknown strategy or ties, or a strategy / mesh-shape
            mismatch.
    """
    axis_names = list(_names(mesh))
    row_axes = (tuple(a for a in axis_names if a != axis_names[-1])
                if row_axes is None else tuple(row_axes))
    col_axis = col_axis or axis_names[-1]
    if strategy == "auto":
        strategy = "2d" if len(axis_names) >= 2 else "ring"
    if strategy not in ("allgather", "ring", "2d"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "2d" and not row_axes:
        raise ValueError("strategy '2d' needs a mesh with >= 2 dimensions "
                         f"(got {tuple(axis_names)})")
    if pod_stream is None:
        pod_stream = "pod" in axis_names and strategy == "2d"
    stream_axis = "pod" if pod_stream else None
    if stream_axis is not None and (strategy != "2d"
                                    or stream_axis not in row_axes):
        raise ValueError("pod_stream needs strategy '2d' with a 'pod' row "
                         "dimension")
    dev = _device_of(device)

    D = torch.as_tensor(D)
    n0 = D.shape[0]
    pr = _axis_size(mesh, row_axes) if row_axes else 1
    pc = _axis_size(mesh, col_axis)
    quantum = pr * pc
    m = -(-n0 // quantum) * quantum
    dt = comm_dtype or torch.float32
    Dp = torch.full((m, m), float("inf"), dtype=dt, device=dev)
    Dp[:n0, :n0] = D.to(device=dev, dtype=dt)
    Dp.diagonal().fill_(0.0)
    n_valid = n0 if m != n0 else None

    # every per-rank knob (tiles, impl, weight) resolves once, keyed on the
    # per-rank row extent
    m_dev = m // (quantum if strategy in ("allgather", "ring") else pr)
    local_plan = _engine.plan_local(m_dev, impl=impl, ties=ties,
                                    weight=weight, block=block,
                                    block_z=block_z, on_error=on_error,
                                    device=dev)
    flat = tuple(axis_names)
    if strategy == "allgather":
        body = lambda x: _allgather_body(  # noqa: E731
            x, mesh=mesh, axis=flat, n_valid=n_valid, plan=local_plan)
        spec = P(flat, None)
    elif strategy == "ring":
        body = lambda x: _ring_body(  # noqa: E731
            x, mesh=mesh, axis=flat, p=quantum, n_valid=n_valid,
            plan=local_plan)
        spec = P(flat, None)
    else:
        body = lambda x: _2d_body(  # noqa: E731
            x, mesh=mesh, row_axes=row_axes, col_axis=col_axis,
            stream_axis=stream_axis, n_valid=n_valid, plan=local_plan)
        spec = P(row_axes, col_axis)
    _group(mesh, _names(mesh))  # the agreement's group, before any failure
    C = _agreed(mesh, dev, lambda: shard_map_compat(
        body, mesh=mesh, in_specs=spec, out_specs=spec)(Dp))[:n0, :n0]
    if normalize:
        C = C / max(n0 - 1, 1)
    return C


def pald_distributed_from_features(
    X,
    mesh,
    *,
    metric: str = "euclidean",
    strategy: str = "auto",
    normalize: bool = True,
    impl: str | None = None,
    block: int | str = "auto",
    block_z: int | str = "auto",
    ties: str | None = None,
    weight=None,
    on_error: str = "raise",
    device="cuda",
) -> torch.Tensor:
    """Distributed PaLD straight from row-sharded feature vectors.

    X is zero-padded to shard evenly over the flattened mesh; each rank
    computes its distance rows itself, so the only O(n)-scaled
    communication is feature movement (n d words), n/d less than the
    distance-sharded strategies.

    Args:
        X: global (n, d) feature matrix (numpy array or tensor).
        mesh: the ``DeviceMesh`` to run on (flattened over every
            dimension).
        metric: one of ``features.METRICS``.
        strategy: "allgather" (one all-gather of X; each rank derives the
            (n, n) distances) or "ring" (the "auto" default; X blocks
            rotate and each step's distance rows are recomputed from the
            (m, d) block in flight: memory O(n^2/p)).
        normalize / impl / block / block_z / ties / weight / on_error /
            device: as in ``pald_distributed``.

    Returns:
        (n, n) float32 C on ``device``, equal to single-device
        ``pald.from_features(X, metric=metric, ties=ties)``.

    Raises:
        ValueError: unknown strategy, metric or ties.
    """
    from .features import METRICS

    if strategy == "auto":
        strategy = "ring"
    if strategy not in ("allgather", "ring"):
        raise ValueError(
            f"unknown feature strategy {strategy!r} "
            "(expected 'allgather' or 'ring')")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r} (expected one of "
                         f"{METRICS})")
    axis_names = _names(mesh)
    p = math.prod(mesh.mesh.shape)
    dev = _device_of(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    n0, d = X.shape
    m = -(-n0 // p) * p
    Xp = torch.zeros((m, d), dtype=torch.float32, device=dev)
    Xp[:n0] = X
    n_valid = n0 if m != n0 else None
    local_plan = _engine.plan_local(m // p, impl=impl, ties=ties,
                                    weight=weight, block=block,
                                    block_z=block_z, on_error=on_error,
                                    device=dev)
    if strategy == "allgather":
        body = lambda x: _feat_allgather_body(  # noqa: E731
            x, mesh=mesh, axis=axis_names, metric=metric, n_valid=n_valid,
            plan=local_plan)
    else:
        body = lambda x: _feat_ring_body(  # noqa: E731
            x, mesh=mesh, axis=axis_names, p=p, metric=metric,
            n_valid=n_valid, plan=local_plan)
    spec = P(axis_names, None)
    _group(mesh, _names(mesh))  # the agreement's group, before any failure
    C = _agreed(mesh, dev, lambda: shard_map_compat(
        body, mesh=mesh, in_specs=spec, out_specs=spec)(Xp))[:n0, :n0]
    if normalize:
        C = C / max(n0 - 1, 1)
    return C
