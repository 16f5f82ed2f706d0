"""Sparse k-NN PaLD: neighborhood selection, struct and tile semantics
(counterpart of ``repro.core.knn``).

PaLD restricted to k-nearest-neighbor conflict foci (Baron, Darling, Davis
& Pfeifer, arXiv:2108.08864) keeps the community structure of the full
computation at O(n k^2) work and O(n k) result memory, where the dense
passes need O(n^3) work and an (n, n) matrix.  The semantics are the
reference's, for every directed conflict pair (x, y) with y in N_k(x):

    U_k[x, y] = sum_{z in {x} + N_k(x)} focus_weight(d_xz, d_yz, d_xy)
    C[x, z]  += support_weight(d_xz, d_yz, d_xy) / U_k[x, y]

so row x of C is supported only at z in {x} + N_k(x): the sparse (n, k+1)
value layout, column 0 the self support and column 1+j neighbor j.  At
k = n-1 the restriction is the identity and the values scatter to the
dense C.

``NeighborGraph``
    ``indices (n, k)`` int32 and ``distances (n, k)`` float32, row x
    holding x's k nearest OTHER points ascending by (distance, index).
``knn_from_distances(D, k)`` / ``knn_from_features(X, k, metric=...)``
    Selection from a materialized D (a stable ``torch.sort`` per row slab,
    the reference's ``lax.top_k``) or streamed from features
    (``kernels.ops.topk_select``: the CUDA kernel of ``pald_topk.cu``).
``knn_values_tile(dn, g, own_wins, ties)``
    The plain tile body of the k-NN cohesion kernel (``pald_knn.cu``).
``gather_tile_from_distances`` / ``gather_tile_from_features``
    The (b, k, k) neighbor-to-neighbor distances the tile body reads.
``scatter_dense``, ``local_depths``, ``universal_threshold``,
``strong_ties``, ``communities``
    The sparse analyses, on the (n, k+1) values.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .features import dist_step, finish_dist, row_norms
from .weights import (DEFAULT_TIES, focus_weight, resolve_weight,
                      support_weight)

__all__ = [
    "NeighborGraph",
    "empty_graph",
    "knn_from_distances",
    "knn_from_features",
    "knn_values_tile",
    "gather_tile_from_distances",
    "gather_tile_from_features",
    "gather_tile_from_neighbors",
    "scatter_dense",
    "local_depths",
    "universal_threshold",
    "strong_ties",
    "communities",
]


class NeighborGraph(NamedTuple):
    """k-nearest-neighbor structure of n points.

    Attributes:
        indices: (n, k) int32; row x holds the indices of x's k nearest
            OTHER points (self always excluded), ascending by distance with
            exact ties broken toward the lower index.
        distances: (n, k) float32; ``distances[x, j] == d(x, indices[x, j])``.
    """

    indices: torch.Tensor
    distances: torch.Tensor

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]


def empty_graph(n: int, device=None, lead: tuple = ()) -> NeighborGraph:
    """The (n, 0) graph of k = 0 (``lead`` + (n, 0) for a chunk)."""
    shape = tuple(lead) + (n, 0)
    return NeighborGraph(torch.zeros(shape, dtype=torch.int32, device=device),
                         torch.zeros(shape, dtype=torch.float32,
                                     device=device))


def check_k(k: int, n: int) -> None:
    if k > max(n - 1, 0):
        raise ValueError(f"k={k} exceeds the n-1={n - 1} available neighbors")


def _top_k_rows(rows: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(distances, int32 indices) of the k smallest entries of each row
    (along the last axis), ascending by (value, column): a stable sort, so
    equal values keep the lower column first (the reference's stable
    ``lax.top_k`` on the negated rows).  ``torch.topk`` is not documented
    as stable and is not used."""
    vals, idx = torch.sort(rows, dim=-1, stable=True)
    # copies: a view would hold the whole sorted slab alive
    return vals[..., :k].clone(), idx[..., :k].to(torch.int32)


def knn_from_distances(D: torch.Tensor, k: int, *,
                       row_chunk: int = 1024) -> NeighborGraph:
    """Each point's k nearest neighbors from a distance matrix.

    Args:
        D: (n, n) distances with a zero diagonal (cast to float32), or a
            (b, n, n) chunk of them: each row slab is then the chunk's
            (b, rows, n) and the graph (b, n, k), bitwise its items' (a
            stable sort orders each row alone).
        k: ``0 <= k <= n-1``; k = 0 gives the (n, 0) graph.
        row_chunk: rows per sorted slab (bounds the sort's memory; the
            result does not depend on it).

    The self entry is +inf before the sort, as in the reference (where it
    is -inf among the negated rows), so on a row whose real distances reach
    +inf, self takes its index's place among them.

    Raises:
        ValueError: ``k > n-1``.
    """
    D = torch.as_tensor(D).to(torch.float32)
    n = D.shape[-1]
    check_k(k, n)
    if k <= 0:
        return empty_graph(n, D.device, D.shape[:-2])
    dist, idx = [], []
    for s in range(0, n, row_chunk):
        rows = D[..., s:s + row_chunk, :].clone()
        r = torch.arange(rows.shape[-2], device=D.device)
        rows[..., r, s + r] = float("inf")
        dv, di = _top_k_rows(rows, k)
        dist.append(dv)
        idx.append(di)
    return NeighborGraph(torch.cat(idx, dim=-2), torch.cat(dist, dim=-2))


def knn_from_features(X, k: int, *, metric: str = "euclidean",
                      row_chunk: int | str = 1024,
                      impl: str | None = None,
                      tile: int | str = "auto") -> NeighborGraph:
    """k nearest neighbors straight from (n, d) features, D never
    materialized: a facade over ``kernels.ops.topk_select`` (the CUDA
    kernel for CUDA tensors).  ``row_chunk`` is the plain version's rows
    per slab and ``tile`` its tile-min prefilter's width (>= n: the
    direct sort; the result does not depend on either); "auto" resolves
    both under the ``pald_topk:k<k>:d<d>`` tuning-cache pass."""
    from repro_torch.kernels.ops import topk_select

    return topk_select(X, k, metric=metric, impl=impl, block=row_chunk,
                       tile=tile)


# ---------------------------------------------------------------------------
# the plain tile body of the k-NN cohesion kernel
# ---------------------------------------------------------------------------
def knn_values_tile(dn: torch.Tensor, g: torch.Tensor,
                    own_wins: torch.Tensor | None,
                    ties=DEFAULT_TIES) -> torch.Tensor:
    """Sparse cohesion values of one (b, k) row tile of the graph.

    Args:
        dn: (b, k) neighbor distances d(x, nbr_j).
        g: (b, k, k) gathered ``g[i, a, c] = d(nbr_a(x_i), nbr_c(x_i))``
            with an exactly zero diagonal.
        own_wins: (b, k) bool, "index of x > index of nbr_j": the tiebreak
            of functionals with ``needs_index_tiebreak`` (None otherwise).
        ties: the weight functional (name or instance).

    Returns:
        (b, k+1) float32: column 0 is z = x, column 1+j is z = nbr_j;
        un-normalized.

    For functionals with a ``share`` (soft), the support is ``share *
    focus`` on the same triples, so the focus cube is reused (bitwise the
    support on finite distances), as in the reference.
    """
    zero = torch.zeros_like(dn)
    # pass 1: the focus size of each directed pair (x, nbr_j); z = x gives
    # focus(0, d_yx, d_xy), z = nbr_m the cube term
    fw_self = focus_weight(zero, dn, dn, ties)                      # (b, k)
    fw_nbr = focus_weight(dn[:, None, :], g, dn[:, :, None], ties)  # (b, j, m)
    U = fw_self + torch.sum(fw_nbr, dim=-1, dtype=torch.float32)
    pos = U > 0
    W = torch.where(pos, 1.0 / torch.where(pos, U, 1.0), 0.0)
    # pass 2: the support of every candidate z against the same pairs
    wfun = resolve_weight(ties)
    if wfun.share is not None:
        sw_nbr = wfun.share(dn[:, None, :], g) * fw_nbr
        sw_self = wfun.share(zero, dn) * fw_self
    else:
        ow = None if own_wins is None else own_wins[:, :, None]
        sw_nbr = support_weight(dn[:, None, :], g, dn[:, :, None], ties, ow)
        sw_self = support_weight(zero, dn, dn, ties, own_wins)
    cv_nbr = torch.sum(sw_nbr * W[:, :, None], dim=1, dtype=torch.float32)
    cv_self = torch.sum(sw_self * W, dim=1, dtype=torch.float32)
    return torch.cat([cv_self[:, None], cv_nbr], dim=1)


def gather_tile_from_distances(D: torch.Tensor,
                               idx: torch.Tensor) -> torch.Tensor:
    """(b, k, k) neighbor-to-neighbor distances gathered from dense D."""
    idx = idx.long()
    return D[idx[:, :, None], idx[:, None, :]]


def gather_tile_from_features(X: torch.Tensor, idx: torch.Tensor,
                              metric: str) -> torch.Tensor:
    """(b, k, k) neighbor-to-neighbor distances recomputed from features.

    A batched ``features.dist_tile``: the same operations in the same order
    per entry, so entry (a, c) is bitwise ``cdist_reference(X)[idx[a],
    idx[c]]``; the same-index entries (the diagonal) are forced to exactly
    0, as ``cdist_reference``'s diagonal is."""
    return gather_tile_from_neighbors(X.to(torch.float32)[idx.long()], idx,
                                      metric)


def gather_tile_from_neighbors(Xn: torch.Tensor, idx: torch.Tensor,
                               metric: str) -> torch.Tensor:
    """:func:`gather_tile_from_features` from the (b, k, d) neighbor rows
    themselves (``Xn[i, a]`` the features of ``idx[i, a]``), as a shard
    that holds only the rows it gathered computes it; the same bits."""
    idx = idx.long()
    b, k = idx.shape
    Xn = Xn.to(torch.float32)
    if k == 0:
        return torch.zeros((b, 0, 0), dtype=torch.float32, device=Xn.device)
    acc = torch.zeros((b, k, k), dtype=torch.float32, device=Xn.device)
    for f in range(Xn.shape[2]):
        acc = dist_step(acc, Xn[:, :, None, f], Xn[:, None, :, f], metric)
    if metric == "manhattan":
        G = acc
    else:
        nrm = row_norms(Xn.reshape(b * k, -1), metric).reshape(b, k)
        G = finish_dist(acc, nrm[:, :, None], nrm[:, None, :], metric)
    same = idx[:, :, None] == idx[:, None, :]
    return torch.where(same, 0.0, G)


# ---------------------------------------------------------------------------
# sparse-result utilities
# ---------------------------------------------------------------------------
def scatter_dense(graph: NeighborGraph, values: torch.Tensor) -> torch.Tensor:
    """Expand (n, k+1) values to the dense (n, n) C: ``C[x, x] =
    values[x, 0]``, ``C[x, indices[x, j]] = values[x, 1+j]``, exact zeros
    elsewhere.  A chunk's (b, n, k) graph and (b, n, k+1) values give
    (b, n, n) in one indexed write, bitwise each item's own."""
    lead = tuple(graph.indices.shape[:-2])
    n, k = graph.indices.shape[-2:]
    C = torch.zeros(lead + (n, n), dtype=torch.float32, device=values.device)
    dev = values.device
    rows = torch.arange(n, device=dev)
    # the item index of a chunk's writes, broadcast against (n, k) / (n,)
    item = torch.arange(lead[0], device=dev) if lead else None
    if k:
        at = (item[:, None, None],) if lead else ()
        C[at + (rows[:, None], graph.indices.long())] = (
            values[..., 1:].to(torch.float32))
    at = (item[:, None],) if lead else ()
    C[at + (rows, rows)] = values[..., 0].to(torch.float32)
    return C


def local_depths(values: torch.Tensor) -> torch.Tensor:
    """l_x = sum_z c_xz over the stored entries (all others are 0)."""
    return torch.sum(torch.as_tensor(values), dim=-1)


def universal_threshold(values) -> float:
    """tau = mean(self-cohesion) / 2 on the sparse layout (column 0 is the
    diagonal of C); assumes normalized values."""
    v = _numpy(values)
    return float(np.mean(v[..., 0])) / 2.0


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def strong_ties(graph: NeighborGraph, values, threshold: float | None = None):
    """Symmetrized strong ties on the sparse structure: (x, y) is strong
    when ``min(c_xy, c_yx) >= tau``, an unstored direction counting as 0,
    so only mutual neighbors can be strong.

    Returns:
        (src, dst, weight) numpy arrays of the strong ties with src < dst.
    """
    idx = _numpy(graph.indices)
    n, k = idx.shape
    v = _numpy(values)
    tau = universal_threshold(v) if threshold is None else threshold
    if k == 0:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = idx.ravel().astype(np.int64)
    w = v[:, 1:].ravel().astype(np.float64)
    key = src * n + dst
    order = np.argsort(key)
    skey = key[order]
    pos = np.searchsorted(skey, dst * n + src)
    pos_c = np.minimum(pos, len(skey) - 1)
    has_rev = skey[pos_c] == dst * n + src
    w_rev = np.where(has_rev, w[order][pos_c], 0.0)
    sym = np.minimum(w, w_rev)
    keep = (sym >= tau) & (src < dst)
    return src[keep], dst[keep], sym[keep]


def communities(graph: NeighborGraph, values,
                threshold: float | None = None) -> list[list[int]]:
    """Connected components of the sparse strong-tie graph, sorted by size
    (largest first, ties by smallest member), members ascending."""
    from .analysis import connected_components

    src, dst, _ = strong_ties(graph, values, threshold)
    return connected_components(graph.indices.shape[0], zip(src, dst))
