"""Paper §7 re-created: semantic communities in embedding space with the
distributed pipeline, wired into the LM stack: the "embeddings" are rows
of a checkpoint's token-embedding table (or synthetic stand-ins when there
is no checkpoint) (counterpart of ``examples/pald_text_analysis.py``).

    PYTHONPATH=src python -m repro_torch.examples.pald_text_analysis [--ckpt DIR]
    PYTHONPATH=src python -m repro_torch.examples.pald_text_analysis --device cpu

Point it at a checkpoint written by either package
(``repro_torch.checkpoint``, ``repro.checkpoint``: one layout) and it
reports which token neighborhoods have formed strong relative-distance
communities.  Cohesion runs through ``core.distributed.pald_distributed``
(ring) with the port's default kernels on a world of one rank: NCCL on the
card (it refuses two ranks on one card), gloo on the CPU.
"""
import argparse
import os
import time

import numpy as np

from repro_torch.core import analysis


def embeddings_from_checkpoint(ckpt_dir: str, max_tokens: int) -> np.ndarray:
    from repro_torch.checkpoint import checkpointer

    steps = checkpointer.available_steps(ckpt_dir)
    if not steps:
        raise SystemExit(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{steps[-1]:08d}")
    man = checkpointer.read_manifest(path)
    key = next(k for k in man["leaves"] if k.endswith("embed/embedding"))
    emb = checkpointer.read_leaf(path, key, device="cpu", manifest=man)
    return emb[:max_tokens].float().numpy()


def synthetic_vocabulary(n: int = 2712, dim: int = 64) -> np.ndarray:
    rng = np.random.default_rng(7)
    topics = rng.normal(size=(48, dim)) * 4
    out = []
    for i in range(n):
        t = i % 48
        spread = 0.2 + (t % 5) * 0.35     # topic density varies 8x
        out.append(topics[t] + rng.normal(size=dim) * spread)
    return np.asarray(out, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--max-tokens", type=int, default=2712)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from repro_torch.core.engine import resolve_device
    from repro_torch.testing.world import MeshSpec, World

    dev = resolve_device(args.device).type
    X = (embeddings_from_checkpoint(args.ckpt, args.max_tokens)
         if args.ckpt else synthetic_vocabulary(args.max_tokens))
    n = X.shape[0]
    D = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    print(f"[pald-text] n={n} embedding_dim={X.shape[1]}")

    backend = "nccl" if dev == "cuda" else "gloo"
    with World(1, device=dev, backend=backend, spawn=False) as w:
        t0 = time.perf_counter()
        C = w.run("repro_torch.core.distributed:pald_distributed", D,
                  MeshSpec((1,), ("data",)), strategy="ring", device=dev)[0]
    print(f"[pald-text] distributed cohesion on 1 {dev} rank ({backend}): "
          f"{time.perf_counter()-t0:.2f}s")

    tau = analysis.universal_threshold(C)
    comms = analysis.communities(C)
    big = [c for c in comms if len(c) > 1]
    print(f"[pald-text] tau={tau:.5f}  communities>1: {len(big)}  "
          f"sizes: {sorted((len(c) for c in big), reverse=True)[:10]} ...")

    # the paper's word-cloud: strongest ties of a couple of probe tokens
    for probe in (0, n // 2):
        ties = analysis.top_ties(C, probe, k=8)
        shown = ", ".join(f"tok{i}:{v:.4f}" for i, v in ties if v > tau)
        print(f"[pald-text] strong ties of tok{probe}: {shown or '(none)'}")


if __name__ == "__main__":
    main()
