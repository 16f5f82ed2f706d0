"""Quickstart: PaLD in five lines + the knobs that matter (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import analysis, pald


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args().device

    # two communities with VERY different scales — absolute-distance methods
    # need per-dataset tuning here; PaLD does not
    rng = np.random.default_rng(0)
    tight = rng.normal(size=(15, 2)) * 0.1
    loose = rng.normal(size=(25, 2)) * 5.0 + 30.0
    X = np.vstack([tight, loose])
    D = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))

    # --- the whole API ----------------------------------------------------
    C = pald.cohesion(D, device=dev)                  # cohesion matrix
    depths = pald.local_depths(C)                     # l_x = sum_z c_xz
    Cn = C.cpu().numpy()
    comms = analysis.communities(Cn)                  # strong-tie components
    # NB: analysis.universal_threshold assumes the NORMALIZED C (the
    # default normalize=True above carries the 1/(n-1) factor)

    print(f"n={len(X)}  sum(l_x)={float(depths.sum()):.2f}  (= n/2 exactly)")
    print(f"universal threshold tau={analysis.universal_threshold(Cn):.4f}")
    print(f"communities found: {[len(c) for c in comms if len(c) > 1]}")

    # method selection: 'dense' (vectorized), 'pairwise' (blocked Fig.5),
    # 'triplet' (block-symmetric), 'kernel' (the CUDA kernels on the card;
    # their plain torch versions on the CPU)
    for method in ("dense", "pairwise", "triplet", "kernel"):
        Cm = pald.cohesion(D, method=method, device=dev)
        assert np.allclose(Cm.cpu().numpy(), Cn, atol=1e-5)
    print("all four methods agree ✓")

    # --- the execution plan: resolve once, run anywhere -------------------
    # every knob (auto method, "auto" tiles, impl, tie semantics) is
    # resolved exactly once into a frozen plan; cohesion()/from_features()
    # are plan(...).execute(x) underneath.  explain() shows what resolved
    # and where it came from (tuning cache hit / nearest-n / default) —
    # the thing to paste into a perf bug report.
    p = pald.plan(D, method="auto", device=dev)
    info = p.explain()
    print(f"plan: method={info['method']} ({info['method_source']}), "
          f"block={info['block']}, padded n={info['padded_n']}, "
          f"executor={info['executor'].rsplit('.', 1)[-1]}")
    assert np.allclose(p.execute(D).cpu().numpy(), Cn)

    # batched serving shape: (B, n, n) -> (B, n, n) works on EVERY method
    # (the tri kernels included); batch= bounds how many items run per
    # chunk, i.e. peak memory ~ batch * n^2 floats
    Db = np.stack([D] * 4)
    Cb4 = pald.cohesion(Db, method="kernel", schedule="tri", batch=2,
                        device=dev)
    print(f"batched cohesion: {Db.shape} -> {tuple(Cb4.shape)}")

    # input validation lives at the same boundary: non-square / nonzero-diag
    # D always errors; check=True adds finite+symmetry+nonnegativity
    try:
        pald.cohesion(D + 1.0, device=dev)  # broken diagonal
    except ValueError as e:
        print(f"caught bad input: {str(e)[:60]}...")

    # --- straight from features (no D matrix) -----------------------------
    # the fused pipeline computes distance tiles from feature tiles: D
    # never exists whole.  metrics: sqeuclidean / euclidean / cosine /
    # manhattan
    Cf = pald.from_features(X, metric="euclidean", device=dev)
    assert np.allclose(Cf.cpu().numpy(), Cn, atol=1e-5)
    print("fused from-features path agrees ✓")

    # batched workloads: (B, n, d) -> (B, n, n)
    Xb = np.stack([X] * 3)
    Cb = pald.from_features(Xb, metric="euclidean", batch=2, device=dev)
    print(f"batched from_features: {Xb.shape} -> {tuple(Cb.shape)}")

    # --- tie handling (integer / quantized / duplicated data) -------------
    # exact distance ties get ONE semantic across every method and backend,
    # chosen by ties=:
    #   'drop'   (default) tied support goes to neither point — strict
    #            comparisons, cheapest, the paper's optimized convention
    #   'split'  ties split 0.5/0.5 (theoretical PaLD; conserves total
    #            cohesion mass exactly even on heavily tied data)
    #   'ignore' Algorithm 1's sequential tie-goes-to-y branch
    # On tie-free data (like X above) all three agree; on quantized data
    # they differ and 'split' is the principled choice.
    Xq = np.round(X)                       # quantized features -> exact ties
    Cq = {t: pald.from_features(Xq, ties=t, device=dev)
          for t in ("drop", "split", "ignore")}
    spread = max(float(torch.abs(Cq[a] - Cq[b]).max())
                 for a in Cq for b in Cq)
    mass = float(Cq["split"].sum()) * (len(Xq) - 1)
    print(f"tie modes on quantized data: max spread {spread:.4f}, "
          f"split mass {mass:.1f} (= n(n-1)/2 exactly)")

    # --- sparse k-NN restriction (the large-n escape hatch) ---------------
    # method="knn" restricts conflict foci to each point's k nearest
    # neighbors: O(n*k^2) work instead of O(n^3), exact at k = n-1
    # (repro_torch.examples.pald_knn_clusters runs it at n = 50,000)
    Cknn = pald.cohesion(D, method="knn", k=len(X) - 1, device=dev)
    Cdense = pald.cohesion(D, method="dense", device=dev)
    assert torch.equal(Cknn, Cdense)  # bitwise at full k
    err = float(torch.abs(pald.cohesion(D, method="knn", k=10, device=dev)
                          - C).max())
    print(f"knn restriction: exact at k=n-1 ✓, max error {err:.4f} at k=10")

    # strongest ties of point 0 (inside the tight community)
    print("top ties of point 0:", analysis.top_ties(Cn, 0, k=3))


if __name__ == "__main__":
    main()
