"""Train-step factory: loss, gradients, AdamW update (counterpart of
``repro.train.train_step``), on one device or sharded over a mesh.

Mixed precision as in the reference: float32 master parameters, a bfloat16
compute copy made inside the loss (``transformer.unbound(params,
torch.bfloat16)``: autograd runs through the cast, so the float32
parameters receive float32 gradients), float32 softmax and loss.  Each
repeat of the model is rematerialized as ``cfg.remat`` says.
``microbatches > 1`` splits the batch into micro slices whose backward
passes add their float32 gradients into ``.grad``; the sums are divided by
the count and the loss and aux averaged, as the reference's scan does.

The train state is ``{"params": Transformer (float32), "opt": {"m": {name:
tensor}, "v": {name: tensor}}, "step": 0-d int32 tensor}``, ``name`` a
parameter's dotted name.  The step updates it in place (the reference
donates its state to the jitted step to the same end).  Flattened by the
checkpointer it gives the reference's keys (``params/<key>``,
``opt/m/<key>``, ``opt/v/<key>``, ``step``), so each package restores the
other's training checkpoints (``load_state``); ``state_from_reference`` /
``state_to_reference`` carry a state across as numpy arrays.

Sharded over a mesh (``mesh=``: a ``DeviceMesh`` over a
``torch.distributed`` world, one rank a device)
-----------------------------------------------------------------
The layout is the reference's: each rank holds, for every leaf of
``params``, ``opt.m`` and ``opt.v``, the block that its ``NamedSharding``
(``sharding.partition.param_shardings`` of ``logical_specs(cfg)`` under
``cfg.sharding_profile``) puts on the device at the same row-major mesh
position; a dimension that does not divide its mesh dimensions raises, as
``jax.device_put`` does.  The sharded state is ``{"params": {name:
block}, "opt": {"m": {name: block}, "v": {name: block}}, "step": 0-d
int32}``, every block a plain float32 tensor on the rank's device
(``init_state(..., mesh=)``, ``shard_state``; ``gather_state`` makes the
single-device state again).  The batch is split over the data axes of
``batch_spec`` (``partition.batch_pspec``); each rank is handed its own
rows (``data.pipeline.SyntheticTokens(..., mesh=)``).  A step:

1. casts each float32 block to bfloat16 and all-gathers the leaf whole;
2. runs the single-device loss (``make_loss_fn``: the ``unbound`` path,
   ``cfg.remat``, microbatches) on the rank's rows, the gathered bfloat16
   leaves standing where the cast leaves stand on one device;
3. sums each bfloat16 gradient over the batch's mesh dimensions in
   float32, leaf by leaf: each rank sends each peer that peer's block and
   adds the blocks it receives in rank order (as microbatch gradients
   accumulate on one device), frees the leaf before the next one, then
   divides by the number of row slices;
4. takes the global grad norm over the blocks, each block counted on one
   rank of those that hold it;
5. runs AdamW on the rank's blocks in place.

Compute along ``model`` (and any dimension that does not split the batch)
is replicated: those ranks run the same rows and nothing sums over them;
the reference's tensor-parallel splits of heads and ff are compiler
placement, not function.  Metrics are global and the same on every rank.
Collectives go through ``core.distributed``'s helpers (staged through
the host under gloo), and a failure in one rank raises in every rank.
The step takes them as a :class:`Collectives` (``collectives=``): the dry
run (``launch.specs.cell_step``) runs this same step as one rank's
program with local stand-ins for them.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as D
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.sharding import partition

__all__ = ["cross_entropy", "make_loss_fn", "init_state", "backward",
           "make_train_step", "load_state", "state_from_reference",
           "state_to_reference", "param_layout", "shard_state",
           "gather_state", "sharded_backward", "Collectives",
           "COLLECTIVES"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32.  The gold logit is a
    gather: the reference's masked sum (``where`` over a one-hot mask)
    keeps a vocabulary-sharded layout under GSPMD, and on one device picks
    the same value through a (B, S, V) temporary."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def make_loss_fn(cfg: ModelConfig, *, q_chunk: int = 512):
    """``loss_fn(params, batch) -> (loss + aux, (loss, aux))`` on a bfloat16
    copy of the float32 ``params`` (a ``Transformer``)."""
    model = Model(cfg)

    def loss_fn(params, batch):
        p = transformer.unbound(params, torch.bfloat16)
        if "embeds" in batch:
            b = {"embeds": batch["embeds"].to(torch.bfloat16)}
        else:
            b = {"tokens": batch["tokens"]}
        logits, aux = model.apply(p, b, q_chunk=q_chunk)
        loss = cross_entropy(logits, batch["labels"])
        return loss + aux, (loss, aux)

    return loss_fn


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda",
               mesh=None) -> dict:
    """float32 parameters drawn from ``seed`` (``Model.init``), zero AdamW
    moments and step 0, on ``device``.  With ``mesh``: this rank's blocks
    of that state (the whole parameters are drawn, then freed)."""
    params = Model(cfg).init(seed, device)
    dev = params.embed.embedding.device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if mesh is None:
        return {"params": params,
                "opt": adamw.init(dict(params.named_parameters())),
                "step": step}
    local = _blocks(dict(params.named_parameters()),
                    param_layout(cfg, mesh), mesh)
    del params
    return {"params": local, "opt": adamw.init(local), "step": step}


def param_layout(cfg: ModelConfig, mesh) -> dict:
    """{parameter name: PartitionSpec}: where ``cfg.sharding_profile`` lays
    each parameter (and its moments) over ``mesh`` (a ``DeviceMesh`` or a
    ``MeshSpec``), the reference's ``param_shardings`` entry for entry."""
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in
                  transformer.Transformer(cfg).named_parameters()}
    return partition.param_shardings(transformer.logical_specs(cfg),
                                     cfg.sharding_profile, mesh, shapes)


def _blocks(leaves: Mapping[str, torch.Tensor], layout: Mapping, mesh) -> dict:
    """Each leaf's block on this rank, a tensor of its own."""
    return {n: D._block(t.detach(), mesh, layout[n], n).clone(
        memory_format=torch.contiguous_format) for n, t in leaves.items()}


def shard_state(state: dict, mesh, cfg: ModelConfig) -> dict:
    """This rank's blocks of a single-device train state (copies)."""
    layout = param_layout(cfg, mesh)
    return {"params": _blocks(dict(state["params"].named_parameters()),
                              layout, mesh),
            "opt": {m: _blocks(state["opt"][m], layout, mesh)
                    for m in ("m", "v")},
            "step": state["step"].detach().clone()}


def _module(cfg: ModelConfig, leaves: Mapping[str, torch.Tensor]):
    """A ``Transformer`` whose parameters are ``leaves`` themselves."""
    with torch.device("meta"):
        module = transformer.Transformer(cfg)
    module.load_state_dict(dict(leaves), assign=True)
    return module


@torch.no_grad()
def gather_state(state: dict, mesh, cfg: ModelConfig) -> dict:
    """The single-device train state from every rank's blocks, on every
    rank (collective: every rank calls it)."""
    layout = param_layout(cfg, mesh)

    def whole(blocks):
        return {n: D._gather_full(t, mesh, layout[n])
                for n, t in blocks.items()}

    return {"params": _module(cfg, whole(state["params"])),
            "opt": {m: whole(state["opt"][m]) for m in ("m", "v")},
            "step": state["step"].clone()}


class Collectives(NamedTuple):
    """The collectives of a sharded step: ``gather(name, block, mesh,
    spec)`` the whole leaf ``name`` from every rank's ``block``;
    ``sum_block(g, mesh, axes, spec)`` this rank's block of the float32
    sum of ``g`` over the ranks along ``axes``; ``agreed(mesh, device,
    fn)`` ``fn()``, raising on every rank if it raised on any."""
    gather: Callable
    sum_block: Callable
    agreed: Callable


def _gather_leaf(name, block, mesh, spec):
    return D._gather_full(block, mesh, spec)


COLLECTIVES = Collectives(_gather_leaf, D._sum_block, D._agreed)


def sharded_backward(loss_fn, cfg: ModelConfig, params: Mapping[str,
                     torch.Tensor], batch: dict, mesh, *, batch_spec,
                     microbatches: int = 1, dtype=torch.bfloat16,
                     collectives: Collectives = COLLECTIVES):
    """Steps 1-3 of a sharded step (module docstring): this rank's blocks
    of the float32 gradient of ``loss_fn`` over the global batch (the
    rank's rows in ``batch``, the global batch split over ``batch_spec``'s
    first entry, ``partition.batch_pspec``; each rank's rows in
    ``microbatches`` slices), and the global (loss, aux), detached.
    ``params``: this rank's blocks."""
    gather, sum_block = collectives.gather, collectives.sum_block
    layout = param_layout(cfg, mesh)
    axes = D._entry_axes(batch_spec[0]) if len(batch_spec) else ()
    rows = next(iter(batch.values())).shape[0]
    if microbatches < 1 or rows % microbatches:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    with torch.no_grad():
        module = _module(cfg, {n: gather(n, t.to(dtype), mesh, layout[n])
                               for n, t in params.items()})
    slices = {k: v.chunk(microbatches, dim=0) for k, v in batch.items()}
    grads: dict = {}
    loss = aux = 0.0
    for i in range(microbatches):
        tot, (l, a) = loss_fn(module, {k: v[i] for k, v in slices.items()})
        tot.backward()
        loss, aux = loss + l.detach(), aux + a.detach()
        with torch.no_grad():
            for n, p in module.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                p.grad = None
                blk = sum_block(g, mesh, axes, layout[n])
                del g
                grads[n] = blk if n not in grads else grads[n].add_(blk)
    del module
    q = microbatches * (D._axis_size(mesh, axes) if axes else 1)
    with torch.no_grad():
        la = sum_block(torch.stack([torch.as_tensor(loss).float(),
                                    torch.as_tensor(aux).float()]),
                       mesh, axes, D.P(None))
        if q > 1:
            for g in grads.values():
                g.div_(q)
            la = la / q
    return grads, (la[0], la[1])


def _sharded_norm(grads: Mapping[str, torch.Tensor], layout, mesh,
                  sum_block=D._sum_block):
    """The global L2 norm of the gradient blocks: each leaf's sum of
    squares taken on one rank of those that hold a block (zero on the
    others), summed over the mesh.  On one rank it is ``adamw.global_norm``
    bit for bit (the same sums in the same order)."""
    sq = torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
        if D._is_owner(mesh, layout[n])
        else torch.zeros((), dtype=torch.float32, device=g.device)
        for n, g in grads.items()]).sum()
    return torch.sqrt(sum_block(sq, mesh, D._names(mesh), D.P()))


def backward(loss_fn, params: torch.nn.Module, batch: dict,
             microbatches: int = 1):
    """The float32 gradients of ``loss_fn`` over ``batch`` into each
    parameter's ``.grad`` (set anew), summed over ``microbatches`` micro
    slices of the batch and divided by their count.  Returns the (loss,
    aux) averaged over the slices, detached.  A parameter the loss does
    not read gets a zero gradient, as under ``jax.grad``."""
    rows = next(iter(batch.values())).shape[0]
    if microbatches < 1 or rows % microbatches:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    for p in params.parameters():
        p.grad = None
    slices = {k: v.chunk(microbatches, dim=0) for k, v in batch.items()}
    loss = aux = 0.0
    for i in range(microbatches):
        tot, (l, a) = loss_fn(params, {k: v[i] for k, v in slices.items()})
        tot.backward()
        loss, aux = loss + l.detach(), aux + a.detach()
    with torch.no_grad():
        for p in params.parameters():
            if p.grad is None:      # unused (the audio / vlm archs' table)
                p.grad = torch.zeros_like(p)
            elif microbatches > 1:
                p.grad.div_(microbatches)
    return loss / microbatches, aux / microbatches


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
                    microbatches: int = 1, q_chunk: int = 512, mesh=None,
                    batch_spec=None,
                    collectives: Collectives = COLLECTIVES):
    """``train_step(state, batch) -> (state, metrics)``: one AdamW step of
    ``state`` in place; metrics {"loss", "aux", "grad_norm", "lr"} are 0-d
    float32 tensors on the state's device.  With ``mesh``: the sharded
    step of a sharded state on this rank's rows of the batch, the global
    batch split over ``batch_spec`` (``partition.batch_pspec``), every
    rank calling it (module docstring), through ``collectives``."""
    loss_fn = make_loss_fn(cfg, q_chunk=q_chunk)
    if mesh is not None:
        if batch_spec is None:
            raise ValueError("a sharded step needs the batch's "
                             "batch_spec (partition.batch_pspec)")
        return _sharded_step(cfg, opt_cfg, loss_fn, mesh, batch_spec,
                             microbatches, collectives)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        loss, aux = backward(loss_fn, params, batch, microbatches)
        named = dict(params.named_parameters())
        metrics = adamw.apply(opt_cfg, named,
                              {k: p.grad for k, p in named.items()},
                              state["opt"], state["step"])
        for p in params.parameters():
            p.grad = None
        state["step"].add_(1)
        return state, {"loss": loss, "aux": aux, **metrics}

    return train_step


def _sharded_step(cfg, opt_cfg, loss_fn, mesh, batch_spec, microbatches,
                  collectives):
    layout = param_layout(cfg, mesh)

    def body(state, batch):
        grads, (loss, aux) = sharded_backward(
            loss_fn, cfg, state["params"], batch, mesh,
            batch_spec=batch_spec, microbatches=microbatches,
            collectives=collectives)
        gnorm = _sharded_norm(grads, layout, mesh, collectives.sum_block)
        metrics = adamw.apply(opt_cfg, state["params"], grads, state["opt"],
                              state["step"], grad_norm=gnorm)
        state["step"].add_(1)
        return state, {"loss": loss, "aux": aux, **metrics}

    def train_step(state: dict, batch: dict):
        dev = state["step"].device
        return collectives.agreed(mesh, dev, lambda: body(state, batch))

    return train_step


@torch.no_grad()
def load_state(state: dict, path: str) -> None:
    """Overwrite ``state`` in place, leaf by leaf, with the training
    checkpoint at ``path`` (a ``step_<N>`` directory of either package).
    Every leaf of the state must be in it with its shape and dtype."""
    manifest = checkpointer.read_manifest(path)
    for key, t in checkpointer._flatten(state).items():
        if key not in manifest["leaves"]:
            raise KeyError(f"{path}: no leaf {key!r}")
        leaf = checkpointer.read_leaf(path, key, t.device, manifest)
        if leaf.shape != t.shape or leaf.dtype != t.dtype:
            raise ValueError(f"{path}: leaf {key!r} is {leaf.dtype} "
                             f"{tuple(leaf.shape)}, the state's {t.dtype} "
                             f"{tuple(t.shape)}")
        t.copy_(leaf)


def state_from_reference(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                         device="cpu") -> dict:
    """The port's train state holding a reference train state flattened
    with its checkpointer's keys (numpy leaves)."""
    params = params_from_reference(
        {k[len("params/"):]: v for k, v in flat.items()
         if k.startswith("params/")}, cfg, device)
    keys = [n.replace(".", "/") for n, _ in params.named_parameters()]
    want = {"step"} | {f"{pre}/{k}" for pre in ("params", "opt/m", "opt/v")
                       for k in keys}
    if set(flat) != want:
        raise ValueError(f"not a train state of {cfg.name}: missing "
                         f"{sorted(want - set(flat))}, unexpected "
                         f"{sorted(set(flat) - want)}")
    dev = params.embed.embedding.device
    opt = {m: {k.replace("/", "."): torch.tensor(
        np.asarray(flat[f"opt/{m}/{k}"]), device=dev) for k in keys}
           for m in ("m", "v")}
    step = torch.tensor(np.asarray(flat["step"]), dtype=torch.int32,
                        device=dev)
    return {"params": params, "opt": opt, "step": step}


def state_to_reference(state: dict) -> dict[str, np.ndarray]:
    """The reference's flattened train state (numpy leaves) from the
    port's."""
    return {k: v.detach().cpu().numpy()
            for k, v in checkpointer._flatten(state).items()}
