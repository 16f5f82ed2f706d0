"""Large-n community detection with sparse k-NN PaLD (counterpart of
``examples/pald_knn_clusters.py``).

    PYTHONPATH=src python -m repro_torch.examples.pald_knn_clusters         # n = 50,000
    PYTHONPATH=src python -m repro_torch.examples.pald_knn_clusters --n 4000
    PYTHONPATH=src python -m repro_torch.examples.pald_knn_clusters --mesh 4
    PYTHONPATH=src python -m repro_torch.examples.pald_knn_clusters --device cpu --n 2000

A synthetic mixture of many small gaussian communities at a size that is
INFEASIBLE for every dense path: at n = 50k the distance matrix alone is
10 GiB and the dense pipelines perform ~1.2e14 triplet comparisons, while
the k-NN restriction (Baron et al., arXiv:2108.08864) needs O(n*d) memory
for selection, O(n*k^2) comparisons for cohesion, and never materializes
D.  The whole result lives in the sparse (n, k+1) value layout.

Selection and cohesion run as one pipeline (``ops.select_cohere``: on the
card the selection kernel, then the values kernel building each row's
neighbor tile from the features), and the NeighborGraph comes back
alongside the values for the community pass.  ``--unfused`` runs the
two-stage path (standalone selection, then ``ops.pald_knn``); both are
bitwise identical.

Communities are recovered with k >= the community size — the regime the
restriction is designed for (each point's neighborhood covers its whole
community, so within-community support survives while cross-community
pairs are never even candidates).

``--mesh P`` runs the same pipeline row-sharded over a local
``torch.distributed`` world of P spawned ranks sharing the device
(``testing/world.py``; gloo), feature blocks moving by ``--strategy``
(allgather / ring / 2d, O(n*d) words in all): only the sparse (n, k+1)
result is gathered, bitwise the single-device path's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import knn
from repro_torch.kernels import ops


def make_mixture(n: int, comm_size: int, d: int, seed: int = 0):
    """~n points in n // comm_size well-separated gaussian communities."""
    rng = np.random.default_rng(seed)
    c = max(n // comm_size, 1)
    centers = rng.normal(size=(c, d)) * (6.0 * c ** (1.0 / d))
    X = np.concatenate(
        [centers[i] + rng.normal(size=(comm_size, d)) for i in range(c)])
    labels = np.repeat(np.arange(c), comm_size)
    return X.astype(np.float32), labels


def _sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--comm-size", type=int, default=25)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--row-chunk", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--unfused", action="store_true",
                    help="two-stage path (standalone selection, then "
                         "cohesion) instead of the one pipeline")
    ap.add_argument("--mesh", type=int, default=0, metavar="P",
                    help="shard rows over a local world of P ranks")
    ap.add_argument("--strategy", default="ring",
                    choices=["allgather", "ring", "2d"],
                    help="feature-movement strategy for --mesh "
                         "(2d needs even P)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU available; pass --device cpu")

    X, labels = make_mixture(args.n, args.comm_size, args.d, args.seed)
    n, c = len(X), labels.max() + 1
    dense_gib = n * n * 4 / 2**30
    print(f"[knn] n={n} in {c} communities of {args.comm_size}; "
          f"dense D would be {dense_gib:.1f} GiB + ~{n**3 / 2:.1e} "
          f"comparisons — not attempted")

    Xd = torch.as_tensor(X, device=dev)
    if args.unfused:
        _sync(dev)
        t0 = time.time()
        graph = knn.knn_from_features(Xd, args.k, metric="euclidean",
                                      row_chunk=args.row_chunk)
        _sync(dev)
        t_sel = time.time() - t0
        print(f"[knn] neighbor selection (standalone, D never "
              f"materialized): {t_sel:.1f}s -> ({n}, {args.k}) graph")

        t0 = time.time()
        _, vals = ops.pald_knn(Xd, k=args.k, kind="features",
                               graph=graph, normalize=True)
        _sync(dev)
        t_coh = time.time() - t0
        print(f"[knn] sparse cohesion (O(n*k^2)): {t_coh:.1f}s")
        t_pipe = t_sel + t_coh
    elif args.mesh > 1:
        from repro_torch.testing.world import MeshSpec, World

        p = args.mesh
        if args.strategy == "2d":
            if p % 2:
                raise SystemExit("--strategy 2d needs an even --mesh P")
            shape, axnames = (p // 2, 2), ("rows", "cols")
        else:
            shape, axnames = (p,), ("data",)
        t0 = time.time()
        with World(p, device=dev, timeout=600.0) as w:
            t_world = time.time() - t0
            t0 = time.time()
            graph, vals = w.run(
                "repro_torch.core.distributed_knn:pald_knn_sharded", X,
                MeshSpec(shape, axnames), k=args.k, strategy=args.strategy,
                block=args.row_chunk, normalize=True, device=dev)[0]
            t_pipe = time.time() - t0
        print(f"[knn] mesh-sharded select->cohere ({args.strategy}, "
              f"mesh {shape}, {p} ranks started in {t_world:.1f}s): "
              f"{t_pipe:.1f}s -> ({n}, {args.k}) graph + values, "
              f"bitwise-equal to the single-device path")
    else:
        _sync(dev)
        t0 = time.time()
        graph, vals = ops.select_cohere(Xd, k=args.k, metric="euclidean",
                                        block=args.row_chunk,
                                        normalize=True)
        _sync(dev)
        t_pipe = time.time() - t0
        print(f"[knn] select->cohere (one pass, the selection's graph "
              f"feeds the values kernel): {t_pipe:.1f}s -> "
              f"({n}, {args.k}) graph + values")
    if isinstance(vals, torch.Tensor):
        vals = vals.cpu().numpy()
    nbytes = vals.size * 4 / 2**20
    print(f"[knn] pipeline total (select + O(n*k^2) cohesion): "
          f"{t_pipe:.1f}s -> ({n}, {args.k + 1}) values, {nbytes:.0f} MiB "
          f"(vs {dense_gib:.0f} GiB dense C)")

    depths = knn.local_depths(torch.as_tensor(vals)).numpy()
    tau = knn.universal_threshold(vals)
    print(f"[knn] local depth mean={depths.mean():.4f}  tau={tau:.5f}")

    t0 = time.time()
    comms = knn.communities(graph, vals)
    big = [cc for cc in comms if len(cc) > 1]
    pure = sum(1 for cc in comms if len({labels[m] for m in cc}) == 1)
    covered = sum(len(cc) for cc in big
                  if len(cc) >= 0.5 * args.comm_size
                  and len({labels[m] for m in cc}) == 1)
    print(f"[knn] communities: {time.time() - t0:.1f}s -> "
          f"{len(big)} strong components "
          f"(purity {pure / max(len(comms), 1):.1%}, "
          f"{covered / n:.1%} of points in a majority-recovered community)")
    assert pure == len(comms), "a strong component spans two true communities"
    print("no strong tie ever crosses communities ✓")


if __name__ == "__main__":
    main()
