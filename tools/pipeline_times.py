#!/usr/bin/env python3
"""Time the main paths end to end with whichever ``repro_torch`` is on the
path.

    PYTHONPATH=src python3 tools/pipeline_times.py

``pald.cohesion(D, method="kernel", ties="ignore")`` on the dense and the
tri schedule at n = 8192 (a bitwise-symmetric Euclidean D of seeded
normal points, d = 8), ``pald.from_features(X)`` at n = 8192, d = 64, and
``ops.select_cohere(X, k=32)`` at n = 50,000, d = 8: each a median of 3
CUDA-event timings after a warm-up, inputs already on the card.  Prints
the card's name and power limit, then one JSON line ``{"dense": ms,
"tri": ms, "fused": ms, "select_cohere": ms}``.

It uses only entry points that every slice of the port since the k-NN
slice has, so it times two trees in one call on one card: run it with
``PYTHONPATH`` set to each tree's ``src`` in turns (base, new, new,
base).  Needs a CUDA GPU.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

N, N_KNN, K_KNN, REPS, SEED = 8192, 50_000, 32, 3, 0


def symmetric_distances(X: torch.Tensor) -> torch.Tensor:
    """Euclidean D by the difference formula: (i, j) and (j, i) take the
    same operations, so D is bitwise symmetric with a zero diagonal."""
    n = X.shape[0]
    D = torch.empty((n, n), dtype=torch.float32, device=X.device)
    for s in range(0, n, 512):
        diff = X[s:s + 512, None, :] - X[None, :, :]
        D[s:s + 512] = torch.sqrt((diff * diff).sum(-1))
    D.fill_diagonal_(0.0)
    return D


def time_ms(fn) -> float:
    """Median of REPS CUDA-event timings after one warm-up call."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    from repro_torch.core import pald
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    X8 = torch.as_tensor(rng.normal(size=(N, 8)), dtype=torch.float32,
                         device="cuda")
    D = symmetric_distances(X8)
    out = {}
    for sched in ("dense", "tri"):
        out[sched] = time_ms(lambda: pald.cohesion(
            D, method="kernel", schedule=sched, ties="ignore"))
    del D, X8
    X64 = torch.as_tensor(rng.normal(size=(N, 64)), dtype=torch.float32,
                          device="cuda")
    out["fused"] = time_ms(lambda: pald.from_features(X64))
    del X64
    Xk = torch.as_tensor(rng.normal(size=(N_KNN, 8)), dtype=torch.float32,
                         device="cuda")
    out["select_cohere"] = time_ms(lambda: ops.select_cohere(Xk, k=K_KNN))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
