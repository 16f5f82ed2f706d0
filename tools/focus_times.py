#!/usr/bin/env python3
"""Time the focus kernels of whichever ``repro_torch`` is on the path.

    PYTHONPATH=src python3 tools/focus_times.py

For each built-in weight family: ``ops.focus(D)`` on the card (the dense
entry) and ``ops.focus(D, schedule="tri")``, median of 3 CUDA-event
timings after a warm-up, on a bitwise-symmetric Euclidean D of n = 8192
seeded normal points (d = 8), the main path's size.  Prints the card's name and power limit, then one
JSON line ``{"n": ..., "dense": {family: ms}, "tri": {family: ms}}``.

It uses only entry points that every slice of the port has, so it times
two trees in one call on one card: run it with ``PYTHONPATH`` set to each
tree's ``src`` in turns (base, new, new, base).  Needs a CUDA GPU.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

N, REPS, SEED = 8192, 3, 0


def symmetric_distances(n: int, d: int, seed: int) -> torch.Tensor:
    """Euclidean D by the difference formula: (i, j) and (j, i) take the
    same operations, so D is bitwise symmetric with a zero diagonal."""
    X = torch.as_tensor(np.random.default_rng(seed).normal(size=(n, d)),
                        dtype=torch.float32, device="cuda")
    D = torch.empty((n, n), dtype=torch.float32, device="cuda")
    for s in range(0, n, 512):
        diff = X[s:s + 512, None, :] - X[None, :, :]
        D[s:s + 512] = torch.sqrt((diff * diff).sum(-1))
    D.fill_diagonal_(0.0)
    return D


def median_ms(fn) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("focus_times: needs a CUDA GPU")
    from repro_torch.core.weights import kernelized, soft_threshold
    from repro_torch.kernels import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    D = symmetric_distances(N, 8, SEED)
    if not torch.equal(D, D.T):
        raise SystemExit("focus_times: D is not bitwise symmetric")
    out = {"n": N, "dense": {}, "tri": {}}
    for w in ("drop", "split", "ignore", soft_threshold(), kernelized()):
        name = w if isinstance(w, str) else w.name
        for sched in ("dense", "tri"):
            out[sched][name] = median_ms(
                lambda: ops.focus(D, impl="cuda", schedule=sched, ties=w))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
