"""Train-step factory: loss, gradients, AdamW update (counterpart of
``repro.train.train_step``, on one device).

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
``state_to_reference`` carry a state across as numpy arrays.  The
reference's logical sharding specs belong to the sharded training
(ROADMAP.md queue 1, item 12b).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model
from repro_torch.optim import adamw

__all__ = ["cross_entropy", "make_loss_fn", "init_state", "backward",
           "make_train_step", "load_state", "state_from_reference",
           "state_to_reference"]


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


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """float32 parameters drawn from ``seed`` (``Model.init``), zero AdamW
    moments and step 0, on ``device``."""
    params = Model(cfg).init(seed, device)
    dev = params.embed.embedding.device
    return {"params": params,
            "opt": adamw.init(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


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
                    microbatches: int = 1, q_chunk: int = 512):
    """``train_step(state, batch) -> (state, metrics)``: one AdamW step of
    ``state`` in place; metrics {"loss", "aux", "grad_norm", "lr"} are 0-d
    float32 tensors on the state's device."""
    loss_fn = make_loss_fn(cfg, q_chunk=q_chunk)

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
