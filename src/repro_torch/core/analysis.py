"""Cohesion-matrix analysis: universal threshold, strong ties, communities.

This package's own copy of ``repro.core.analysis`` (numpy only, so the
port imports without JAX; the tests hold the two copies equal).

Follows Berenhaut, Moore & Melvin (PNAS 2022), the paper's reference [2]:

* the *universal threshold* for distinguishing strong from weak ties is half
  the mean self-cohesion:  tau = mean(diag(C)) / 2;
* the strong-tie matrix keeps symmetrized cohesion min(c_xy, c_yx) where it
  exceeds tau;
* communities are the connected components of the strong-tie graph.
"""
from __future__ import annotations

import numpy as np

__all__ = ["universal_threshold", "strong_ties", "communities",
           "connected_components", "top_ties"]


def universal_threshold(C: np.ndarray) -> float:
    """The universal strong/weak tie threshold: half the mean self-cohesion.

    Args:
        C: (n, n) NORMALIZED cohesion matrix (``pald.cohesion`` /
            ``from_features`` with the default ``normalize=True``, i.e.
            entries carry the 1/(n-1) factor).  On an un-normalized C
            every entry — diagonal and off-diagonal alike — scales by
            (n-1), so the *partition* into strong and weak ties is
            unchanged, but the returned tau is on the un-normalized scale
            and must not be compared against normalized cohesion values.

    Returns:
        tau = mean(diag(C)) / 2, the parameter-free threshold of
        Berenhaut, Moore & Melvin (PNAS 2022).

    Example:
        >>> import numpy as np
        >>> float(universal_threshold(np.eye(4) * 0.5))
        0.25
    """
    return float(np.mean(np.diag(C))) / 2.0


def strong_ties(C: np.ndarray, threshold: float | None = None) -> np.ndarray:
    """Symmetrized cohesion, zeroed below the universal threshold.

    Args:
        C: (n, n) normalized cohesion matrix.
        threshold: tau override; default ``universal_threshold(C)``.

    Returns:
        (n, n) matrix S = min(C, C.T) with a zero diagonal and entries
        below tau zeroed — the adjacency of the strong-tie graph.

    Example:
        >>> import numpy as np
        >>> C = np.asarray([[.5, .4], [.45, .5]])
        >>> strong_ties(C).tolist()
        [[0.0, 0.4], [0.4, 0.0]]
    """
    C = np.asarray(C)
    tau = universal_threshold(C) if threshold is None else threshold
    S = np.minimum(C, C.T)
    np.fill_diagonal(S, 0.0)
    S[S < tau] = 0.0
    return S


def communities(C: np.ndarray, threshold: float | None = None) -> list[list[int]]:
    """Community detection: connected components of the strong-tie graph.

    Args:
        C: (n, n) normalized cohesion matrix.
        threshold: tau override; default ``universal_threshold(C)``.

    Returns:
        List of components in deterministic order: sorted by size
        (largest first), equal sizes broken by smallest member index;
        members within a component in increasing index order.  Sorting by
        size alone would leave equal-size communities in union-find-root
        order — an artifact of edge iteration, not of the data.

    Example:
        >>> import numpy as np
        >>> C = np.asarray([[.5, .4, 0], [.4, .5, 0], [0, 0, .5]])
        >>> communities(C)
        [[0, 1], [2]]
    """
    S = strong_ties(C, threshold)
    return connected_components(S.shape[0], zip(*np.nonzero(S)))


def connected_components(n: int, edges) -> list[list[int]]:
    """Union-find components over ``edges`` with the deterministic output
    contract of the strong-tie analyses (``communities``): components
    sorted by (-size, smallest member), members ascending.

    Args:
        n: number of nodes (0..n-1).
        edges: iterable of (x, y) pairs (any int-castable).

    Returns:
        The components as lists of node indices.

    Example:
        >>> connected_components(4, [(0, 2), (2, 3)])
        [[0, 2, 3], [1]]
    """
    parent = list(range(n))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for x, y in edges:
        ra, rb = find(int(x)), find(int(y))
        if ra != rb:
            parent[ra] = rb
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return sorted(groups.values(), key=lambda g: (-len(g), g[0]))


def top_ties(C: np.ndarray, x: int, k: int = 10) -> list[tuple[int, float]]:
    """Strongest symmetric ties of point x (paper §7 word-cloud analogue).

    Args:
        C: (n, n) cohesion matrix.
        x: the point whose ties to rank.
        k: how many partners to return; clamped to the n-1 real partners
            (a point has no tie to itself, so asking for more must not
            pad the list with the -inf self-sentinel).

    Returns:
        Up to k ``(partner_index, min(c_xy, c_yx))`` pairs, strongest
        first.

    Example:
        >>> import numpy as np
        >>> C = np.asarray([[.5, .4, .1], [.4, .5, .1], [.1, .1, .5]])
        >>> top_ties(C, 0, k=5)
        [(1, 0.4), (2, 0.1)]
    """
    C = np.asarray(C)
    n = C.shape[0]
    k = min(k, n - 1)
    if k <= 0:
        return []
    S = np.minimum(C, C.T)
    row = S[x].copy()
    row[x] = -np.inf
    idx = np.argsort(row)[::-1][:k]
    return [(int(i), float(row[i])) for i in idx]
