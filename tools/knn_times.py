#!/usr/bin/env python3
"""Time the k-NN path of whichever ``repro_torch`` is on the path.

    PYTHONPATH=src python3 tools/knn_times.py [--big] [--large [--split]]
                                              [--wide]

On the k-NN example's mixture (n = 50,000 points in communities of 25,
d = 8, seed 0; ``examples/pald_knn_clusters.py``): ``ops.topk_select(X,
k)`` at k in {1, 32, 256, 1024}, ``ops.knn_values(X, graph,
kind="features")`` at k = 32 (the stage "gather + values": the plain
gather and the cube kernel before the values kernel built its own tiles)
and ``ops.select_cohere(X, k=32)``, each the median of 3 CUDA-event
timings after a warm-up.  The same points in a random order (seed 0;
``"shuffled"``): the selection at k = 1 and 32 and ``select_cohere``; the
mixture lists its communities in turn, so in its own order a block's
nearby rows share most of their neighbors.  At n in {8192, 10000}
(``"small"``), where the card holds fewer row blocks than it has slots:
the selection and ``select_cohere`` at k = 32, median of 11; on a tree
whose selection splits its candidates into segments, also the selection
at S in {1, 2, 4, 8} and ``select_cohere`` with the split turned off
(``pald_topk.default_segments`` pinned to 1; ``"S"`` is the default's
choice).  ``--big`` adds ``select_cohere`` at n = 10^6 (one timed call
after a warm-up).  ``--large`` times past k = 1024 instead, on the same
mixture: the selection (median of 3 after a warm-up), the values
(``ops.knn_values(X, graph, kind="features")``, one call) and
``ops.select_cohere(X, k)`` (one call) at k in {1025, 2048, 4096}, after
one values call on 64 rows has loaded the kernel; ``--split`` adds, at k =
2048, the selection (median of 3) and the values (one call) for each
metric, the values for each built-in family (euclidean), and the values
at d = 16 (the points with 8 zero features: the features source's width
16), under ``"split"``.  ``--wide`` times the values past k = 1024 at
the widths ``pald_knn_wide.cu`` and ``pald_knn_piece.cu`` take and the D
source: the features source (``ops.knn_values(X, graph,
kind="features")``, the median of 3 after a warm-up on 64 rows) at n =
2100, k = 2048 on a mixture (communities of 25, seed 5) at d = 17, 32, 64
and 100, and at d = 8 and 16 (``pald_knn_large.cu``'s widths); and at n =
8192 on four planted clusters (``chip_smoke.py``'s phase 3 points and D:
its ``clustered_points``, d = 8, seed 0, and ``distances_on_device``) the
D source (``knn_values_from_distances_cuda`` on ``knn_from_distances(D,
2048)``, median of 3 after a warm-up) and ``cohesion(D, method="knn",
k=2048)`` (one call after a warm-up); then both again on the same points
in a random order (seed 0; ``"_shuffled"``): each cluster is a run of
consecutive rows, so in their own order a row's neighbors sorted by
index are nearly contiguous columns of D, and shuffled they are spread
over the row.  Prints the card's name
and power limit, then one JSON line ``{"n": ..., "topk": {k: ms},
"values": ms, "select_cohere": ms, "shuffled": {...}, "small": {n:
{...}}, ...}`` (``--large``: ``{"n": ..., "large": {k: {"topk": ms,
"values": ms, "select_cohere": ms}}, "split": {...}}``; ``--wide``:
``{"wide": {"values_d8": ms, ..., "values_D": ms, "cohesion_D": ms,
"values_D_shuffled": ms, "cohesion_D_shuffled": ms}}``).

It uses only entry points that every slice of the port has, so it times
two trees in one call on one card: run it with ``PYTHONPATH`` set to each
tree's ``src`` in turns (base, new, new, base); it prints the package it
timed.  Needs a CUDA GPU.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

# chip_smoke.py puts its own tree's src first on the path when imported:
# the path is put back, so that the tree on PYTHONPATH is the one timed
_PATH = list(sys.path)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import clustered_points, distances_on_device  # noqa: E402

sys.path[:] = _PATH

N, K, D, COMM, SEED, REPS = 50_000, 32, 8, 25, 0, 3
N_BIG = 1_000_000
N_SMALL, REPS_SMALL = (8192, 10_000), 11
LARGE_KS = (1025, 2048, 4096)
N_WIDE, K_WIDE, D_WIDE = 2100, 2048, (8, 16, 17, 32, 64, 100)
N_DSRC = 8192


def mixture(n: int, comm: int, d: int, seed: int) -> torch.Tensor:
    """examples/pald_knn_clusters.py::make_mixture on the card."""
    rng = np.random.default_rng(seed)
    c = max(n // comm, 1)
    centers = rng.normal(size=(c, d)) * (6.0 * c ** (1.0 / d))
    X = np.concatenate([centers[i] + rng.normal(size=(comm, d))
                        for i in range(c)])
    return torch.as_tensor(X.astype(np.float32), device="cuda")


def median_ms(fn, reps: int = REPS, warm: bool = True) -> float:
    if warm:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def small_times(ops, n: int) -> dict:
    """The selection and select_cohere at n, k = K; with the candidate
    split turned off too where the tree has one."""
    from repro_torch.kernels import pald_topk

    X = mixture(n, COMM, D, SEED)
    out = {"topk": median_ms(lambda: ops.topk_select(X, K), REPS_SMALL),
           "select_cohere": median_ms(lambda: ops.select_cohere(X, k=K),
                                      REPS_SMALL)}
    split = getattr(pald_topk, "default_segments", None)
    if split is not None:
        out["S"] = split(n, K, torch.cuda.get_device_properties(
            0).multi_processor_count)
        out["topk_by_S"] = {s: median_ms(lambda: pald_topk.topk_select_cuda(
            X, K, segments=s), REPS_SMALL) for s in (1, 2, 4, 8)}
        pald_topk.default_segments = lambda *a: 1
        try:
            out["select_cohere_S1"] = median_ms(
                lambda: ops.select_cohere(X, k=K), REPS_SMALL)
        finally:
            pald_topk.default_segments = split
    return out


def large_times(ops, X) -> dict:
    """The selection, the values and select_cohere past k = 1024."""
    from repro_torch.core.knn import NeighborGraph

    g = ops.topk_select(X, LARGE_KS[0])
    ops.knn_values(X, NeighborGraph(g.indices[:64], g.distances[:64]),
                   kind="features")
    out = {}
    for k in LARGE_KS:
        t = {"topk": median_ms(lambda: ops.topk_select(X, k))}
        g = ops.topk_select(X, k)
        t["values"] = median_ms(lambda: ops.knn_values(X, g, kind="features"),
                                1, warm=False)
        del g
        t["select_cohere"] = median_ms(lambda: ops.select_cohere(X, k=k), 1,
                                       warm=False)
        out[k] = t
        print(f"k={k}: {t}", flush=True)
    return out


def large_split(ops, X, k: int = 2048) -> dict:
    """The selection and the values at k by metric, the values by family
    (euclidean) and at d = 16 (X with zero features appended)."""
    out = {}
    for metric in ("euclidean", "sqeuclidean", "cosine", "manhattan"):
        t = {"topk": median_ms(lambda: ops.topk_select(X, k, metric=metric))}
        g = ops.topk_select(X, k, metric=metric)
        t["values"] = median_ms(lambda: ops.knn_values(
            X, g, kind="features", metric=metric), 1)
        out[metric] = t
        print(f"k={k} {metric}: {t}", flush=True)
    g = ops.topk_select(X, k)
    for ties in ("split", "ignore", "soft", "kernelized"):
        out[f"values_{ties}"] = median_ms(lambda: ops.knn_values(
            X, g, kind="features", ties=ties), 1)
    X16 = torch.cat([X, torch.zeros_like(X)], 1).contiguous()
    out["values_d16"] = median_ms(lambda: ops.knn_values(
        X16, g, kind="features"), 1)
    print(f"k={k}: {out}", flush=True)
    return out


def wide_times(ops) -> dict:
    """The values past k = 1024: the features source at each of D_WIDE,
    the D source and cohesion(D, method="knn") at N_DSRC, on the planted
    clusters in their own order and shuffled."""
    from repro_torch.core import knn, pald
    from repro_torch.core.knn import NeighborGraph
    from repro_torch.kernels import pald_knn

    out = {}
    for d in D_WIDE:
        X = mixture(N_WIDE, COMM, d, SEED + 5)
        g = ops.topk_select(X, K_WIDE)
        ops.knn_values(X, NeighborGraph(g.indices[:64], g.distances[:64]),
                       kind="features")
        out[f"values_d{d}"] = median_ms(
            lambda: ops.knn_values(X, g, kind="features"), warm=False)
        print(f"n={N_WIDE} k={K_WIDE} d={d}: values {out[f'values_d{d}']} "
              "ms", flush=True)
        del X, g
    dsrc = pald_knn.knn_values_from_distances_cuda
    X = clustered_points(N_DSRC, 8, SEED)[0]
    perm = np.random.default_rng(SEED).permutation(N_DSRC)
    for tag, Xd in (("", X), ("_shuffled", X[perm])):
        D = distances_on_device(torch.as_tensor(Xd, device="cuda"))
        g = knn.knn_from_distances(D, K_WIDE)
        out[f"values_D{tag}"] = median_ms(
            lambda: dsrc(D, g.distances, g.indices))
        out[f"cohesion_D{tag}"] = median_ms(lambda: pald.cohesion(
            D, method="knn", k=K_WIDE, normalize=False), 1)
        print(f"n={N_DSRC} k={K_WIDE}{tag}: D source "
              f"{out[f'values_D{tag}']} ms, cohesion(D, method='knn') "
              f"{out[f'cohesion_D{tag}']} ms", flush=True)
        del D, g
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("knn_times: needs a CUDA GPU")
    import repro_torch
    from repro_torch.kernels import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"timing {os.path.dirname(os.path.abspath(repro_torch.__file__))}")
    if "--wide" in sys.argv[1:]:
        print(json.dumps({"wide": wide_times(ops)}))
        return 0
    X = mixture(N, COMM, D, SEED)
    if "--large" in sys.argv[1:]:
        out = {"n": N, "d": D, "large": large_times(ops, X)}
        if "--split" in sys.argv[1:]:
            out["split"] = large_split(ops, X)
        print(json.dumps(out))
        return 0
    out = {"n": N, "d": D, "topk": {}}
    for k in (1, K, 256, 1024):
        out["topk"][k] = median_ms(lambda: ops.topk_select(X, k))
    graph = ops.topk_select(X, K)
    out["values"] = median_ms(
        lambda: ops.knn_values(X, graph, kind="features"))
    out["select_cohere"] = median_ms(lambda: ops.select_cohere(X, k=K))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.select_cohere(X, k=K)
    torch.cuda.synchronize()
    out["select_cohere_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    perm = torch.as_tensor(np.random.default_rng(SEED).permutation(N),
                           device="cuda")
    Xs = X[perm].contiguous()
    out["shuffled"] = {f"topk_{k}": median_ms(lambda: ops.topk_select(Xs, k))
                       for k in (1, K)}
    out["shuffled"]["select_cohere"] = median_ms(
        lambda: ops.select_cohere(Xs, k=K))
    del Xs
    out["small"] = {n: small_times(ops, n) for n in N_SMALL}
    if "--big" in sys.argv[1:]:
        del graph
        Xb = mixture(N_BIG, COMM, D, SEED)
        out["select_cohere_big_ms"] = median_ms(
            lambda: ops.select_cohere(Xb, k=K), 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
