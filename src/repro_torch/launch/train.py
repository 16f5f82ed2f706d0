"""Training driver: state on one device, checkpoint/restart, logging
(counterpart of ``repro.launch.train``).

Runs real steps on the card (``--device cpu`` runs them on the CPU).
Fault tolerance, as in the reference:

* background checkpoints every ``--ckpt-every`` steps and at the end
  (``checkpoint.AsyncCheckpointer``: atomic, the caller waits only for the
  device-to-host copy);
* on startup the latest complete checkpoint in ``--ckpt-dir`` is restored
  (one written by either package: one layout) and the run continues from
  the step after it;
* the data pipeline is a pure function of (seed, step): a restarted job
  replays the exact stream, so loss curves are restart-exact.

The reference's ``--mesh`` places the state over a device mesh with its
GSPMD shardings; here only ``--mesh 1`` (one device) runs, and any other
mesh raises: the sharded training is ROADMAP.md queue 1, item 12b.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 5 --batch 8 --seq 128                # full width, the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 50 --ckpt-dir DIR --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

__all__ = ["run", "main"]


def run(cfg: ModelConfig, *, steps: int, batch: int = 8, seq: int = 128,
        lr: float = 3e-4, warmup: int = 20, microbatches: int = 1,
        ckpt_dir=None, ckpt_every: int = 50, log_every: int = 10,
        seed: int = 0, device="cuda"):
    """Train ``cfg`` for steps [start, steps), start being the step after
    the latest checkpoint in ``ckpt_dir`` (0 without one).  Returns (the
    train state, one record a step run: {"step", "loss", "aux",
    "grad_norm", "lr", "seconds"}, seconds being the step's host time up
    to its metrics on the host)."""
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] {cfg.name} on one device ({where})")
    opt_cfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=warmup,
                                total_steps=steps)
    step_fn = ts.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    state = ts.init_state(cfg, seed, dev)

    start = 0
    ckpt = None
    if ckpt_dir:
        ckpt = checkpointer.AsyncCheckpointer(ckpt_dir)
        done = checkpointer.available_steps(ckpt_dir)
        if done:
            ts.load_state(state, os.path.join(ckpt_dir,
                                              f"step_{done[-1]:08d}"))
            start = done[-1] + 1
            print(f"[train] restored step {done[-1]} from {ckpt_dir}")

    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed, device=dev)
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
            b = {"embeds": emb, "labels": b["labels"]}
        state, metrics = step_fn(state, b)
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        records.append({"step": step, **m,
                        "seconds": time.perf_counter() - t_step})
        tokens_done += batch * seq
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            print(f"  step {step:5d} loss {m['loss']:8.4f} "
                  f"gnorm {m['grad_norm']:7.3f} lr {m['lr']:.2e} "
                  f"tok/s {tokens_done / max(dt, 1e-9):,.0f}")
        if ckpt and step > 0 and step % ckpt_every == 0:
            ckpt.save(step, state)
    if ckpt:
        ckpt.save(steps - 1, state)
        ckpt.wait()
        print(f"[train] final checkpoint at {ckpt_dir}")
    return state, records


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

    if args.mesh != "1":
        raise ValueError(
            f"--mesh {args.mesh}: the port trains on one device; the "
            f"sharded training is ROADMAP.md queue 1, item 12b")
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, records = run(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        warmup=args.warmup, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every, seed=args.seed, device=args.device)
    return records


if __name__ == "__main__":
    main()
