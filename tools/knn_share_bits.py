"""Dump the k-NN values kernel's output for every built-in family, or
compare two dumps bit for bit: how a change to the kernel's weight traits
is held to the tree before it on one card.

    PYTHONPATH=src python3 tools/knn_share_bits.py --out FILE.npz
    python3 tools/knn_share_bits.py --compare A.npz B.npz

The dump runs the three sources (the gathered cube, features, D) at k in
{7, 32, 100} on seeded, tie-heavy quantized features (n = 2000, d = 5),
and a chunk of three graphs through the features and D sources.  The
comparison prints each array's verdict and exits 1 unless all are bitwise
equal.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

FAMILIES = ("drop", "split", "ignore", "soft", "kernelized")


def _features(n, d, seed):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    dup = np.arange(5, n, 5)
    X[dup] = X[rng.integers(0, 5, size=dup.size)]
    return X.astype(np.float32)


def dump(path: str) -> None:
    import torch
    from repro_torch.core import knn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_knn, pald_topk

    dev = torch.device("cuda", 0)
    out = {}
    for k in (7, 32, 100):
        X = torch.as_tensor(_features(2000, 5, k), device=dev)
        g = pald_topk.topk_select_cuda(X, k)
        D = cdist_reference(X)
        cube = ops._gather_tiles(X, g.indices, "features", "euclidean")
        Xb = torch.as_tensor(np.stack([_features(300, 5, 10 * k + i)
                                       for i in range(3)]), device=dev)
        Db = torch.stack([cdist_reference(x) for x in Xb])
        gb = knn.knn_from_distances(Db, k)
        for w in FAMILIES:
            runs = {
                "cube": pald_knn.knn_values_cuda(g.distances, cube,
                                                 g.indices, ties=w),
                "features": pald_knn.knn_values_from_features_cuda(
                    X, g.distances, g.indices, ties=w),
                "distances": pald_knn.knn_values_from_distances_cuda(
                    D, g.distances, g.indices, ties=w),
                "features_chunk": pald_knn.knn_values_from_features_cuda(
                    Xb, gb.distances, gb.indices, ties=w),
                "distances_chunk": pald_knn.knn_values_from_distances_cuda(
                    Db, gb.distances, gb.indices, ties=w)}
            for src, v in runs.items():
                out[f"{w}/{src}/k{k}"] = v.cpu().numpy()
    np.savez(path, **out)
    print(f"knn_share_bits: {len(out)} arrays to {path} "
          f"({torch.cuda.get_device_name(0)})")


def compare(a: str, b: str) -> int:
    A, B = np.load(a), np.load(b)
    bad = 0
    for key in sorted(set(A.files) | set(B.files)):
        same = (key in A.files and key in B.files
                and A[key].shape == B[key].shape
                and np.array_equal(A[key].view(np.uint32),
                                   B[key].view(np.uint32)))
        bad += not same
        print(f"knn_share_bits: {key}: {'bitwise' if same else 'DIFFERS'}")
    print(f"knn_share_bits: {bad} of {len(set(A.files) | set(B.files))} "
          "arrays differ")
    return int(bad > 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    dump(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
