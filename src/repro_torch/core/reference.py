"""Entry-wise reference implementations of PaLD (Algorithms 1 and 2).

This package's own copy of ``repro.core.reference`` (numpy only, so the
port imports without JAX; the tests hold the two copies equal).  These
mirror the paper's pseudocode as directly as possible and serve as the
correctness oracles for every optimized path (plain torch, CUDA kernels).
They are O(n^3) python loops over numpy arrays and are only intended for n
up to a few hundred.

Semantics (documented in DESIGN.md §9; implemented for the optimized paths
by the shared predicates in ``core/ties.py``):
  * ``ties='drop'`` (the pipeline default): strict ``<`` comparisons,
    matching the paper's optimized code which "ignores equality in
    pairwise/triplet distance comparisons" — both strict masks are false on
    a tie, so the tied z supports neither point;
  * ``ties='split'`` implements the theoretical formulation where support is
    split 0.5/0.5 on exact distance ties, INCLUDING the focus-size pass: a z
    exactly on the focus boundary (d_xz == d_xy or d_yz == d_xy) joins the
    focus with weight 0.5, so U is fractional;
  * ``ties='ignore'`` is Algorithm 1's sequential if/else: on a support tie
    the higher-index point wins (the else-branch assigns y, the loop runs
    x < y);
  * ``normalize=True`` applies the 1/(n-1) factor of Eq. (3.3) so that row
    sums of C equal the local depths l_x.
"""
from __future__ import annotations

import numpy as np

from .ties import DEFAULT_TIES, validate_ties

__all__ = [
    "pald_pairwise_reference",
    "pald_triplet_reference",
    "local_focus_reference",
]


def _half_step(d: np.ndarray, thr: float) -> np.ndarray:
    """h(d, thr) = 1 if d < thr, 0.5 if d == thr, else 0 (split-mode weight)."""
    return np.where(d < thr, 1.0, np.where(d == thr, 0.5, 0.0))


def local_focus_reference(D: np.ndarray, *, ties: str = DEFAULT_TIES) -> np.ndarray:
    """Local-focus size matrix U (Algorithm 1, lines 3-6).

    Strict modes ('drop', 'ignore'):
    U[x, y] = |{z : d_xz < d_xy or d_yz < d_xy}| for x != y.  Both x and y
    are always members (d_xx = 0 < d_xy), so U >= 2 off-diagonal for positive
    distances.  'split': boundary ties join with weight 0.5, so U is a
    fractional (multiple-of-0.5) count.  The diagonal is left at 0 and is
    never used.
    """
    validate_ties(ties)
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    U = np.zeros((n, n), dtype=np.float64)
    for x in range(n):
        for y in range(n):
            if x == y:
                continue
            dxy = D[x, y]
            if ties == "split":
                U[x, y] = float(np.sum(
                    np.maximum(_half_step(D[x, :], dxy), _half_step(D[y, :], dxy))
                ))
            else:
                U[x, y] = float(np.sum((D[x, :] < dxy) | (D[y, :] < dxy)))
    return U


def pald_pairwise_reference(
    D: np.ndarray, *, ties: str = DEFAULT_TIES, normalize: bool = False
) -> np.ndarray:
    """Algorithm 1 (pairwise sequential), entry-wise.

    ties='drop'    -> (default) exact ties support neither point: the two
                      strict masks (d_xz < d_yz) and (d_yz < d_xz) are both
                      false on a tie -- the vector analogue of the paper's
                      "ignoring equality in distance comparisons".
    ties='split'   -> exact ties split support 0.5/0.5 (theoretical PaLD /
                      generalized PaLD triplet weights), and a z exactly on
                      the focus boundary joins the focus with weight 0.5.
    ties='ignore'  -> strict focus; on a support tie d_xz == d_yz the
                      support goes to y (the else branch), exactly as
                      Algorithm 1's sequential control flow.

    All optimized paths (plain torch, CUDA kernels) match this oracle
    entry-wise for the SAME ``ties`` mode (tests/test_torch_pald.py).
    """
    validate_ties(ties)
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    C = np.zeros((n, n), dtype=np.float64)
    for x in range(n - 1):
        for y in range(x + 1, n):
            dxy = D[x, y]
            if ties == "split":
                m = np.maximum(_half_step(D[x, :], dxy), _half_step(D[y, :], dxy))
                u = float(m.sum())
                if u == 0.0:
                    continue
                w = 1.0 / u
                for z in range(n):
                    if m[z] == 0.0:
                        continue
                    if D[x, z] < D[y, z]:
                        C[x, z] += m[z] * w
                    elif D[y, z] < D[x, z]:
                        C[y, z] += m[z] * w
                    else:
                        C[x, z] += 0.5 * m[z] * w
                        C[y, z] += 0.5 * m[z] * w
                continue
            infocus = (D[x, :] < dxy) | (D[y, :] < dxy)
            u = int(np.sum(infocus))
            if u == 0:
                continue
            w = 1.0 / u
            for z in range(n):
                if not infocus[z]:
                    continue
                if D[x, z] == D[y, z]:
                    if ties == "ignore":
                        C[y, z] += w
                    # 'drop': neither
                elif D[x, z] < D[y, z]:
                    C[x, z] += w
                else:
                    C[y, z] += w
    if normalize:
        C /= max(n - 1, 1)  # n=1: no pairs, C stays zero (not nan)
    return C


def pald_triplet_reference(D: np.ndarray, *, normalize: bool = False) -> np.ndarray:
    """Algorithm 2 (triplet sequential), entry-wise, ties ignored.

    Initializes U = 2 off-diagonal (each pair's two endpoints), then for each
    unordered triplet attributes focus membership / cohesion support to the
    two non-minimal pairs.  Matches pald_pairwise_reference(ties='ignore')
    on distance matrices without exact ties.
    """
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    U = np.full((n, n), 2.0)
    np.fill_diagonal(U, 0.0)
    for x in range(n - 1):
        for y in range(x + 1, n):
            for z in range(y + 1, n):
                dxy, dxz, dyz = D[x, y], D[x, z], D[y, z]
                if dxy < dxz and dxy < dyz:      # (x, y) closest
                    U[x, z] += 1
                    U[z, x] += 1
                    U[y, z] += 1
                    U[z, y] += 1
                elif dxz < dyz:                  # (x, z) closest
                    U[x, y] += 1
                    U[y, x] += 1
                    U[y, z] += 1
                    U[z, y] += 1
                else:                            # (y, z) closest
                    U[x, y] += 1
                    U[y, x] += 1
                    U[x, z] += 1
                    U[z, x] += 1
    C = np.zeros((n, n), dtype=np.float64)
    for x in range(n - 1):
        for y in range(x + 1, n):
            # z in {x, y} contributions of Algorithm 1's z-loop: z=x supports x
            # (d_xx=0 < d_yx) and z=y supports y -- Algorithm 2's triplet loop
            # only covers z > y, so add the endpoint support explicitly.
            C[x, x] += 1.0 / U[x, y]
            C[y, y] += 1.0 / U[x, y]
            for z in range(n):
                if z == x or z == y:
                    continue
                dxy, dxz, dyz = D[x, y], D[x, z], D[y, z]
                if dxy < dxz and dxy < dyz:
                    continue                     # z outside the (x,y) focus
                if dxz < dyz:
                    C[x, z] += 1.0 / U[x, y]
                else:
                    C[y, z] += 1.0 / U[x, y]
    if normalize:
        C /= max(n - 1, 1)
    return C
