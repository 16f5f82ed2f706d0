"""Training driver: mesh setup, sharded state, checkpoint/restart, logging
(counterpart of ``repro.launch.train``).

Runs real steps on the card (``--device cpu`` runs them on the CPU).
``--mesh`` takes the reference's values: "1" (one device), "N" (N ranks
over ("data",)), "AxB" (data, model), "AxBxC" (pod, data, model),
"production" (16 x 16) and "production-multipod" (2 x 16 x 16).  A mesh
of more than one device trains sharded (``train.train_step``, the
state laid out by ``cfg.sharding_profile``) over a ``torch.distributed``
world of one rank a device: inside an initialized world (``torchrun``)
it uses that world, whose size must be the mesh's; otherwise it starts a
local world of ``prod(shape)`` ranks on ``--device`` (``testing.world``:
gloo, every rank on the one card, or NCCL when there are as many cards
as ranks).  The first rank logs and checkpoints.
Fault tolerance, as in the reference:

* background checkpoints every ``--ckpt-every`` steps and at the end
  (``checkpoint.AsyncCheckpointer``: atomic, the caller waits only for the
  device-to-host copy);
* on startup the latest complete checkpoint in ``--ckpt-dir`` is restored
  with the current mesh's layouts (one written by either package, from
  any mesh: the format is mesh-free) and the run continues from the step
  after it;
* the data pipeline is a pure function of (seed, step): a restarted job
  replays the exact stream, so loss curves are restart-exact.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 5 --batch 8 --seq 128                # full width, the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 50 --ckpt-dir DIR --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --mesh 2x2 --steps 6 --ckpt-dir DIR --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import mesh as meshlib
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.sharding import partition
from repro_torch.train import train_step as ts

__all__ = ["build_mesh", "run", "main"]


def build_mesh(spec: str) -> meshlib.MeshSpec:
    """The mesh ``--mesh`` names (the reference's ``build_mesh``)."""
    if spec == "production":
        return meshlib.MeshSpec(meshlib.SINGLE_POD, ("data", "model"))
    if spec == "production-multipod":
        return meshlib.MeshSpec(meshlib.MULTI_POD, ("pod", "data", "model"))
    dims = tuple(int(x) for x in spec.split("x"))
    names = (("pod", "data", "model")[-len(dims):] if len(dims) > 1
             else ("data",))
    return meshlib.MeshSpec(dims, names)


def run(cfg: ModelConfig, *, steps: int, batch: int = 8, seq: int = 128,
        lr: float = 3e-4, warmup: int = 20, microbatches: int = 1,
        ckpt_dir=None, ckpt_every: int = 50, log_every: int = 10,
        seed: int = 0, device="cuda", mesh=None):
    """Train ``cfg`` for steps [start, steps), start being the step after
    the latest checkpoint in ``ckpt_dir`` (0 without one).  Returns (the
    train state, one record a step run: {"step", "loss", "aux",
    "grad_norm", "lr", "seconds"}, seconds being the step's host time up
    to its metrics on the host).  ``mesh``: a ``DeviceMesh`` of the
    current world, every rank calling: the state is this rank's blocks,
    and only the mesh's first rank logs and writes checkpoints."""
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    shardings = bspec = None
    talk = True
    if mesh is None:
        print(f"[train] {cfg.name} on one device ({where})")
    else:
        shardings = elastic.state_shardings(cfg, mesh)
        bspec = partition.batch_pspec(mesh, batch)
        talk = checkpointer._is_root(mesh)
        if talk:
            print(f"[train] {cfg.name} mesh={meshlib.mesh_shape(mesh)} "
                  f"({cfg.sharding_profile}; {where})")
    opt_cfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=warmup,
                                total_steps=steps)
    step_fn = ts.make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                 mesh=mesh, batch_spec=bspec)

    start = 0
    ckpt = state = None
    done = checkpointer.available_steps(ckpt_dir) if ckpt_dir else []
    if ckpt_dir:
        ckpt = checkpointer.AsyncCheckpointer(ckpt_dir, mesh=mesh)
    if done and mesh is not None:
        state, _, _ = elastic.resume(cfg, ckpt_dir, mesh=mesh, device=dev)
    else:
        state = ts.init_state(cfg, seed, dev, mesh=mesh)
        if done:
            ts.load_state(state, os.path.join(ckpt_dir,
                                              f"step_{done[-1]:08d}"))
    if done:
        start = done[-1] + 1
        if talk:
            print(f"[train] restored step {done[-1]} from {ckpt_dir}")

    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed, device=dev,
                           mesh=mesh, batch_spec=bspec)
    lo, hi = data.rows
    records = []
    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(start, steps):
        t_step = time.perf_counter()
        b = data.batch_at(step)
        if cfg.modality in ("audio", "vlm"):
            # modality stub: embeddings instead of tokens (the frontend is
            # precomputed per the brief); the labels stay token ids
            gen = torch.Generator(device=dev).manual_seed(step)
            emb = torch.randn((batch, seq, cfg.d_model), generator=gen,
                              device=dev) * 0.02
            b = {"embeds": emb[lo:hi], "labels": b["labels"]}
        state, metrics = step_fn(state, b)
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        records.append({"step": step, **m,
                        "seconds": time.perf_counter() - t_step})
        tokens_done += batch * seq
        if talk and (step % log_every == 0 or step == steps - 1):
            dt = time.perf_counter() - t0
            print(f"  step {step:5d} loss {m['loss']:8.4f} "
                  f"gnorm {m['grad_norm']:7.3f} lr {m['lr']:.2e} "
                  f"tok/s {tokens_done / max(dt, 1e-9):,.0f}")
        if ckpt and step > 0 and step % ckpt_every == 0:
            ckpt.save(step, state, shardings)
    if ckpt:
        ckpt.save(steps - 1, state, shardings)
        ckpt.wait()
        if talk:
            print(f"[train] final checkpoint at {ckpt_dir}")
    return state, records


def _run_records(cfg, mesh, kwargs):
    """``run`` in a rank of a local world: its records only (the state
    stays in the rank)."""
    return run(cfg, mesh=mesh, **kwargs)[1]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    kwargs = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                  lr=args.lr, warmup=args.warmup,
                  microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, log_every=args.log_every,
                  seed=args.seed, device=args.device)
    spec = build_mesh(args.mesh)
    n = math.prod(spec.shape)
    dist = torch.distributed
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"--mesh {args.mesh} needs a world of {n} "
                             f"ranks, this one has {dist.get_world_size()}")
        return run(cfg, mesh=meshlib.make_test_mesh(*spec), **kwargs)[1]
    if n == 1:
        return run(cfg, **kwargs)[1]
    from repro_torch.testing.world import World

    nccl = args.device == "cuda" and torch.cuda.device_count() >= n
    with World(n, device=args.device, backend="nccl" if nccl else "gloo",
               timeout=600.0,
               threads=max(1, (os.cpu_count() or 1) // n)) as w:
        return w.run(_run_records, cfg, spec, kwargs, deadline=math.inf)[0]


if __name__ == "__main__":
    main()
