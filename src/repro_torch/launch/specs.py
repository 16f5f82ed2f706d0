"""Stand-ins for every (arch x shape) dry-run cell, and each cell's per-rank
program (counterpart of ``repro.launch.specs``).

The reference describes a cell with ``jax.eval_shape`` and
``ShapeDtypeStruct``s carrying ``NamedSharding``s, and lowers the jitted
step over the whole mesh.  Here a leaf is a tensor on ``torch.device("meta")``
(its global shape and dtype, never allocated) beside its ``PartitionSpec``
(``core.distributed.P``) over a ``launch.mesh.MeshSpec``, and
:func:`block_shape` gives the block a rank holds: the shapes that
``train_step.shard_state`` and ``NamedSharding.shard_shape`` give.

:func:`cell_step` is the counterpart of ``cell_lowerable``: the program one
rank of the port's sharded step runs between its collectives, and its
arguments.

- train: the port's sharded step itself (``train_step.make_train_step(
  mesh=...)``) as the rank at mesh coordinate 0 runs it, with local
  stand-ins for its collectives (``train_step.Collectives``): every leaf
  gathered whole in bfloat16 is handed in (the gathers are the step's
  collectives, so the gathered leaves are arguments), and each gradient
  block's sum is the rank's own work of ``distributed._sum_block`` (the
  all-to-all's buffer written locally: a copy); then the loss and
  backward on the rank's rows, the grad norm and AdamW on the rank's
  float32 blocks, microbatches as the step runs them.  Compute along
  ``model`` is replicated, as in the port's step: nothing is divided by
  the ``model`` dimension's size.
- prefill / decode: the serve step (``train.serve_step``) on the rank's
  rows of the batch and of the caches, with the whole bfloat16 serving
  copy.  The port has no sharded serve step: serving computes replicated
  along every dimension that does not split the batch, and its caches are
  the rank's rows whole (``cache_specs`` gives the reference's layout,
  which the port's serving does not use).

With ``device="meta"`` nothing is allocated; with ``"cuda"`` (or
``"cpu"``) the same function builds real tensors from ``seed``.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from types import SimpleNamespace

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import distributed as D
from repro_torch.core.distributed import P
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.sharding import partition
from repro_torch.train import serve_step, train_step

__all__ = ["block_shape", "state_specs", "param_specs",
           "cache_specs", "batch_specs", "batch_rows", "cell_step"]

META = torch.device("meta")


def _layout_mesh(mesh):
    """A stand-in ``DeviceMesh`` of ``mesh``'s shape for
    ``core.distributed``'s layout helpers (``_block``, ``_check_divides``,
    ``_is_owner``), which read only the dimension names, the rank grid and
    the rank's coordinates: here the rank at coordinate 0 on every
    dimension (rank 0, which owns a block of every leaf)."""
    sizes = mesh_shape(mesh)
    return SimpleNamespace(
        mesh_dim_names=tuple(sizes),
        mesh=torch.arange(math.prod(sizes.values())).reshape(
            tuple(sizes.values())),
        get_coordinate=lambda: [0] * len(sizes))


def block_shape(shape, mesh, spec) -> tuple:
    """The block of a global ``shape`` that every rank holds under
    ``spec`` (raises where a dimension does not divide, as
    ``jax.device_put`` does)."""
    D._check_divides(tuple(shape), _layout_mesh(mesh), spec)
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in D._entry_axes(entry):
            out[dim] //= sizes[a]
    return tuple(out)


def _meta_params(cfg: ModelConfig, dtype=None) -> dict:
    with torch.device("meta"):
        params = transformer.Transformer(cfg)
    return {n: p.detach() if dtype is None else p.detach().to(dtype)
            for n, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# model / optimizer state
# ---------------------------------------------------------------------------
def state_specs(cfg: ModelConfig, mesh):
    """(state, specs): the train state's leaves on meta (float32
    parameters, AdamW moments, the int32 step) and each leaf's
    ``PartitionSpec`` (``train_step.param_layout``)."""
    layout = train_step.param_layout(cfg, mesh)
    params = _meta_params(cfg)
    moments = {n: torch.empty_like(p) for n, p in params.items()}
    state = {"params": params,
             "opt": {"m": moments, "v": dict(moments)},
             "step": torch.empty((), dtype=torch.int32, device=META)}
    specs = {"params": layout, "opt": {"m": layout, "v": layout},
             "step": P()}
    return state, specs


def param_specs(cfg: ModelConfig, mesh, dtype=torch.bfloat16):
    """(params, specs): the serving copy's leaves (``dtype``) on meta and
    their ``PartitionSpec``s."""
    return (_meta_params(cfg, dtype), train_step.param_layout(cfg, mesh))


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """(caches, specs): ``Model.init_caches``' leaves on meta and the
    reference's layout of them (``serve_step.cache_shardings``)."""
    caches = transformer.init_caches(cfg, batch, max_len, torch.bfloat16,
                                     META)
    return caches, serve_step.cache_shardings(cfg, mesh, batch, max_len)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(batch, specs): the inputs of one step of the shape's kind on meta,
    each split over the data dimensions that divide the batch
    (``partition.batch_pspec``).

    train    {"tokens"|"embeds", "labels"}: full (B, S) sequences
    prefill  {"tokens"|"embeds"}: the prompt batch
    decode   one new token (B, 1) (or (B, 1, d) embeds)
    """
    B = shape.global_batch
    S = {"train": shape.seq_len, "prefill": shape.seq_len,
         "decode": 1}[shape.kind]
    b = partition.batch_pspec(mesh, B)[0]
    batch, specs = {}, {}
    if cfg.modality in ("audio", "vlm"):
        batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
        specs["embeds"] = P(b, None, None)
    else:
        batch["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
        specs["tokens"] = P(b, None)
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
        specs["labels"] = P(b, None)
    return batch, specs


def batch_rows(shape: ShapeConfig, mesh) -> int:
    """The rows of the global batch one rank runs."""
    sizes = mesh_shape(mesh)
    b = partition.batch_pspec(mesh, shape.global_batch)[0]
    return shape.global_batch // math.prod(sizes[a]
                                           for a in D._entry_axes(b))


# ---------------------------------------------------------------------------
# the per-rank program
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _weights(cfg: ModelConfig, dev: torch.device, seed: int) -> dict:
    """The whole bfloat16 leaves: on meta, shapes only; else drawn from
    ``seed`` with the model's own distributions, each leaf made in
    bfloat16 (no float32 copy of the model is ever held)."""
    if dev.type == "meta":
        return _meta_params(cfg, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with _default_dtype(torch.bfloat16), torch.no_grad():
        params = transformer.init(gen, cfg, dev)
    return {n: p.detach() for n, p in params.named_parameters()}


def _inputs(cfg: ModelConfig, kind: str, rows: int, seq: int,
            dev: torch.device, seed: int) -> dict:
    """The rank's rows of one step's batch (``batch_specs``' keys)."""
    S = 1 if kind == "decode" else seq
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed + 1))

    def toks():
        if gen is None:
            return torch.empty((rows, S), dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, (rows, S), generator=gen,
                             device=dev, dtype=torch.int32)

    out = {}
    if cfg.modality in ("audio", "vlm"):
        e = (torch.empty((rows, S, cfg.d_model), device=dev) if gen is None
             else torch.randn((rows, S, cfg.d_model), generator=gen,
                              device=dev) * 0.02)
        out["embeds"] = e.to(torch.bfloat16)
    else:
        out["tokens"] = toks()
    if kind == "train":
        out["labels"] = toks()
    return out


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.core.engine import resolve_device

        dev = resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("meta", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected 'meta', "
                         "'cuda' or 'cpu')")
    return dev


def _local_sum(g, mesh, axes, spec, dtype=torch.float32):
    """The rank's own work of ``distributed._sum_block(g, mesh, axes,
    spec)`` without a world: the blocks of ``g`` it sends its peers along
    ``axes`` stacked, the buffer the all-to-all fills (a copy here), and
    their sum in ``dtype`` in rank order (the values are not the world's:
    the peers' blocks stand in for the blocks the peers would send)."""
    D._check_divides(g.shape, mesh, spec)
    me = D._coord(mesh)
    axes = D._in_order(mesh, axes) if axes else ()
    if not axes:
        return D._block_at(g, mesh, spec, me).to(dtype, copy=True)
    sizes = D._sizes(mesh)
    send = torch.stack([
        D._block_at(g, mesh, spec, dict(me, **dict(zip(axes, idx))))
        for idx in itertools.product(*(range(sizes[a]) for a in axes))])
    recv = send.clone()
    total = recv[0].to(dtype, copy=True)
    for part in recv[1:]:
        total.add_(part.to(dtype))
    return total


def _train_program(cfg, mesh, global_batch, *, q_chunk, microbatches,
                   opt_cfg):
    """``train_step.make_train_step(mesh=...)`` itself, run as the rank at
    mesh coordinate 0 without a world: the gathers hand back the leaves
    given as an argument, each block sum is :func:`_local_sum`, and the
    failure agreement runs the body alone."""
    held: dict = {}
    local = train_step.Collectives(
        gather=lambda name, block, m, spec: held[name],
        sum_block=_local_sum,
        agreed=lambda m, dev, fn: fn())
    step = train_step.make_train_step(
        cfg, opt_cfg, microbatches=microbatches, q_chunk=q_chunk,
        mesh=_layout_mesh(mesh),
        batch_spec=partition.batch_pspec(mesh, global_batch),
        collectives=local)

    def train_rank(state: dict, leaves: dict, batch: dict) -> dict:
        held.update(leaves)
        try:
            return step(state, batch)[1]
        finally:
            held.clear()

    return train_rank


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              device="meta", q_chunk: int = 1024, microbatches: int = 1,
              seed: int = 0, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """(fn, args): the per-rank program of one cell over ``mesh`` (a
    ``MeshSpec``) and its arguments (module docstring); ``fn(*args)``
    runs one step.  Train: ``args = (state, leaves, batch)`` (the rank's
    float32 blocks and moments, the gathered bfloat16 leaves, the rank's
    rows); prefill: ``(params, batch, caches)``; decode: ``(params,
    token, caches, pos)``."""
    dev = _device(device)
    rows = batch_rows(shape, mesh)
    leaves = _weights(cfg, dev, seed)
    batch = _inputs(cfg, shape.kind, rows, shape.seq_len, dev, seed)
    if shape.kind == "train":
        if rows % microbatches:
            raise ValueError(f"{rows} rows a rank do not split into "
                             f"{microbatches} microbatches")
        layout = train_step.param_layout(cfg, mesh)
        lm = _layout_mesh(mesh)
        params = {n: D._block(t, lm, layout[n], n).to(
            torch.float32, copy=True).contiguous() for n, t in leaves.items()}
        state = {"params": params, "opt": adamw.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        fn = _train_program(cfg, mesh, shape.global_batch, q_chunk=q_chunk,
                            microbatches=microbatches, opt_cfg=opt_cfg)
        return fn, (state, leaves, batch)
    params = train_step._module(cfg, leaves).requires_grad_(False)
    caches = transformer.init_caches(cfg, rows, shape.seq_len,
                                     torch.bfloat16, dev)
    if shape.kind == "prefill":
        return (serve_step.make_prefill_step(cfg, q_chunk=q_chunk),
                (params, batch, caches))
    token = batch.get("tokens", batch.get("embeds"))
    return (serve_step.make_decode_step(cfg),
            (params, token, caches, shape.seq_len - 1))
