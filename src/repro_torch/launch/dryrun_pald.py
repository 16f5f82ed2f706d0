"""Analytic cost model of distributed PaLD (the counterpart of the analytic
part of ``repro.launch.dryrun_pald``).

The reference lowers and compiles the dense shard bodies for a TPU pod and
reads the collectives from XLA's output; neither has a counterpart here.
What carries over is the arithmetic: the dense form's operation count
(:func:`pald_ops`), the sharded k-NN form's (:func:`knn_pald_ops`) and the
per-rank estimate of one mesh-sharded k-NN cell (:func:`knn_shard_estimate`),
whose communication term is ``core/distributed_knn.comm_estimate``.

The rates are the card's own, from NVIDIA's data sheet for one H100 SXM
at its full power limit of 700 W (a card set below it runs slower; the
smoke prints the limit it ran at): :data:`PEAK_OPS`, float32 outside the
tensor cores (the PaLD passes are compares and adds, no matrix product),
and :data:`LINK_BYTES_PER_S`, NVLink to the other cards of the host, each
way.  Ranks that share one card exchange through the host instead (the
``gloo`` staging of ``core/distributed.py``), which this model does not
describe.

    python -m repro_torch.launch.dryrun_pald --n 100000 --knn-k 32
"""
from __future__ import annotations

import argparse
import json

__all__ = ["PEAK_OPS", "LINK_BYTES_PER_S", "PEAK_SOURCE", "pald_ops",
           "knn_pald_ops", "knn_shard_estimate", "main"]

PEAK_OPS = 67e12            # float32 op/s, H100 SXM, 700 W (data sheet)
LINK_BYTES_PER_S = 450e9    # NVLink, each way, H100 SXM (data sheet)
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet, 700 W: 67 TFLOP/s float32 "
               "outside the tensor cores, NVLink 900 GB/s (450 GB/s each "
               "way)")


def pald_ops(n: int) -> float:
    """Branch-free dense-pairwise op count (compare + select + add), the
    reference's DESIGN.md section 7: pass 1 2 compares + 1 or + 1 add = 4,
    pass 2 2 compares + 1 and + 2 multiply-adds = 5 per (pair, z): ~9 n^3
    over the full cube (the regular dense form does n^3, not n^3/2)."""
    return 9.0 * n ** 3


def knn_pald_ops(n: int, k: int) -> float:
    """Sharded k-NN op count: selection scores every (row, candidate) pair
    (~3 ops a pair: difference, multiply-add, amortized compare) and the
    sparse cohesion runs the dense form's 9-op inner loop over (k+1)-cliques
    only: O(n k^2) instead of O(n^3)."""
    return 3.0 * n * n + 9.0 * n * (k + 1) ** 2


def knn_shard_estimate(n: int, d: int, k: int, *, strategy: str,
                       pr: int, pc: int, dtype_bytes: int = 4) -> dict:
    """Cost model of one mesh-sharded k-NN cell (no run needed).

    Communication is ``distributed_knn.comm_estimate``'s: every strategy
    moves O(n d) feature words a rank, never the O(n^2) distances.
    Compute is the selection term (n^2 d / p distance ops) and the sparse
    cohesion term (n k^2 / p), over :data:`PEAK_OPS`; the collective term
    is the received bytes over :data:`LINK_BYTES_PER_S`.
    """
    from repro_torch.core import distributed_knn as dknn

    p = pr * pc
    comm = dknn.comm_estimate(strategy, n=n, d=d, k=k, p=p, pr=pr, pc=pc)
    sel_ops = 3.0 * n * n * d / p
    coh_ops = 9.0 * n * (k + 1) ** 2 / p
    coll_bytes = comm["per_device_words"] * dtype_bytes
    terms = {
        "compute_s": (sel_ops + coh_ops) / PEAK_OPS,
        "collective_s": coll_bytes / LINK_BYTES_PER_S,
    }
    terms["bottleneck"] = max(
        ("compute_s", "collective_s"), key=lambda kk: terms[kk]
    ).removesuffix("_s")
    return {
        "workload": f"pald-knn-n{n}-k{k}", "strategy": comm["strategy"],
        "mesh": f"{pr}x{pc}", "chips": p, "status": "ok",
        "selection_ops_per_chip": sel_ops,
        "cohesion_ops_per_chip": coh_ops,
        "comm": comm,
        "coll_bytes_per_chip": coll_bytes,
        "roofline": terms,
        "rates": PEAK_SOURCE,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun_pald",
        description="per-rank estimates of mesh-sharded k-NN PaLD cells")
    ap.add_argument("--n", type=int, default=102400)
    ap.add_argument("--knn-k", type=int, default=32)
    ap.add_argument("--knn-d", type=int, default=64)
    ap.add_argument("--strategies", default="allgather,ring,2d")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both",
                    help="the reference's production shapes: 16x16, and "
                         "32x16 for two pods")
    args = ap.parse_args(argv)
    meshes = {"single": [(16, 16)], "multi": [(32, 16)],
              "both": [(16, 16), (32, 16)]}[args.mesh]
    print(f"# rates: {PEAK_SOURCE}")
    for pr, pc in meshes:
        for strat in args.strategies.split(","):
            cell = knn_shard_estimate(args.n, args.knn_d, args.knn_k,
                                      strategy=strat, pr=pr, pc=pc)
            print(json.dumps(cell))


if __name__ == "__main__":
    main()
