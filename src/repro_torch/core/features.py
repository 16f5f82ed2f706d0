"""Distances from feature vectors (counterpart of ``repro.core.features``).

``dist_tile(XA, XB, metric)``
    (ma, d) x (mb, d) -> (ma, mb) float32 distances.
``masked_dist_tile(XA, XB, metric, row_off, col_off, n_valid)``
    The same with the padding contract of ``pad_distance_matrix``: +inf at
    global index >= ``n_valid``, exactly 0 on the global diagonal.
``cdist_reference(X, metric=...)``
    The square form with a zero diagonal: the materialize-then-PaLD paths
    and the oracle the fused kernels are held to.
``pad_features(X, quantum)``
    Zero rows up to a multiple of ``quantum``.

The formulas are the reference's: sqeuclidean ``max((na + nb) - 2 dot,
0)``, euclidean its square root, cosine ``1 - dot / (na nb)`` with ``na =
sqrt(max(sum a^2, 1e-30))``, manhattan ``sum |a - b|``.  The order of the
operations is fixed, unlike the reference's matrix products (whose sums
XLA orders by shape): every dot, squared norm and absolute sum is a loop
over the feature axis from 0 to d-1, one rounded multiply (or difference)
and one rounded add per feature, with no ``matmul``.  Each entry then
depends only on its two rows, never on the tile it lies in, and the CUDA
kernels (``csrc/pald_dist.cuh``) repeat the same operations in the same
order, so their distances are bitwise these.  On the CPU each operation
is taken in float64 and rounded to float32 at once (:func:`_rn`): the
float64 result of one multiply, add, subtract or divide of float32
operands rounds to the correctly rounded float32 one (53 >= 2 * 24 + 2
bits), so the bits do not depend on how a CPU's float32 kernels evaluate
(on the card torch's float32 operations are the correctly rounded ones).
Against the reference's they differ by a few ulps (ROADMAP.md, queue 3).
"""
from __future__ import annotations

import operator
from typing import Literal

import torch

METRICS = ("sqeuclidean", "euclidean", "cosine", "manhattan")

Metric = Literal["sqeuclidean", "euclidean", "cosine", "manhattan"]

_NORM_EPS = 1e-30  # cosine guard: zero vectors get distance 1, not nan

__all__ = ["METRICS", "cdist_reference", "dist_step", "dist_tile",
           "finish_dist",
           "masked_dist_tile", "pad_features", "row_norms"]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device: the
    float64 root, rounded once to float32.  (torch's vectorized float32
    sqrt on the CPU is not always correctly rounded, and then an entry
    would depend on where in the tensor it lies; CUDA's __fsqrt_rn is.)"""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _rn(op, a, b) -> torch.Tensor:
    """``op(a, b)`` of float32 operands (tensors or Python floats) as the
    correctly rounded float32, as the kernels' ``_rn`` intrinsics round it:
    on the CPU taken in float64 and rounded once; elsewhere torch's float32
    operation, which is correctly rounded there."""
    t = a if isinstance(a, torch.Tensor) else b
    if t.device.type != "cpu":
        return op(a, b)
    a = a.to(torch.float64) if isinstance(a, torch.Tensor) else a
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else b
    return op(a, b).to(torch.float32)


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r} (expected one of "
                         f"{METRICS})")


def row_norms(X: torch.Tensor, metric: str) -> torch.Tensor:
    """(m,) per-row norm term of ``metric``, summed over the features in
    order: ``sum a^2`` for the Euclidean metrics, ``sqrt(max(sum a^2,
    1e-30))`` for cosine (manhattan has none; its rows give zeros)."""
    _check_metric(metric)
    X = X.to(torch.float32)
    s = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    if metric == "manhattan":
        return s
    for k in range(X.shape[1]):
        s = _rn(operator.add, s, _rn(operator.mul, X[:, k], X[:, k]))
    if metric == "cosine":
        s = _sqrt_rn(torch.where(s < _NORM_EPS, _NORM_EPS, s))
    return s


def dist_tile(XA: torch.Tensor, XB: torch.Tensor, metric: str) -> torch.Tensor:
    """(ma, d) x (mb, d) -> (ma, mb) distances, float32, each entry a
    fixed-order loop over the d features."""
    _check_metric(metric)
    XA = XA.to(torch.float32)
    XB = XB.to(torch.float32)
    acc = torch.zeros((XA.shape[0], XB.shape[0]), dtype=torch.float32,
                      device=XA.device)
    for k in range(XA.shape[1]):
        acc = dist_step(acc, XA[:, k, None], XB[None, :, k], metric)
    if metric == "manhattan":
        return acc
    return finish_dist(acc, row_norms(XA, metric)[:, None],
                       row_norms(XB, metric)[None, :], metric)


def dist_step(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              metric: str) -> torch.Tensor:
    """One feature of the pair sums: ``acc + a * b`` (manhattan: ``acc +
    |a - b|``), broadcast, each operation rounded to float32."""
    term = (torch.abs(_rn(operator.sub, a, b)) if metric == "manhattan"
            else _rn(operator.mul, a, b))
    return _rn(operator.add, acc, term)


def finish_dist(acc: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
                metric: str) -> torch.Tensor:
    """The distance from the pair sums ``acc`` and the two rows' norm terms
    (broadcast against it), for the metrics with norms."""
    if metric == "cosine":
        q = _rn(operator.truediv, acc, _rn(operator.mul, na, nb))
        return _rn(operator.sub, 1.0, q)
    d2 = _rn(operator.sub, _rn(operator.add, na, nb),
             _rn(operator.mul, 2.0, acc))
    d2 = torch.where(d2 < 0, 0.0, d2)  # nan passes, as jnp.maximum's does
    return _sqrt_rn(d2) if metric == "euclidean" else d2


def masked_dist_tile(XA: torch.Tensor, XB: torch.Tensor, metric: str,
                     row_off: int, col_off: int, n_valid: int) -> torch.Tensor:
    """Distance tile with the padding contract applied: rows/cols at global
    index >= n_valid are +inf (padded points are infinitely far from
    everything) and the exact global diagonal is 0."""
    D = dist_tile(XA, XB, metric)
    ma, mb = D.shape
    rows = row_off + torch.arange(ma, device=D.device)[:, None]
    cols = col_off + torch.arange(mb, device=D.device)[None, :]
    D = torch.where((rows >= n_valid) | (cols >= n_valid), float("inf"), D)
    return torch.where(rows == cols, 0.0, D)


def cdist_reference(X: torch.Tensor, Y: torch.Tensor | None = None, *,
                    metric: str = "euclidean") -> torch.Tensor:
    """Pairwise distances in plain torch, float32.  With ``Y=None`` the
    square form zeroes its diagonal exactly (the dot-product form of
    d(x, x) is only zero up to rounding).  The ``features.cdist`` fault
    point (``core/resilience``) is here."""
    from .resilience import fault_point

    fault_point("features.cdist", metric=metric)
    X = torch.as_tensor(X).to(torch.float32)
    if Y is not None:
        return dist_tile(X, torch.as_tensor(Y, device=X.device), metric)
    n = X.shape[0]
    return masked_dist_tile(X, X, metric, 0, 0, n)


def pad_features(X: torch.Tensor, quantum: int) -> tuple[torch.Tensor, int]:
    """Pad rows of X up to a multiple of ``quantum`` with zero vectors;
    the +inf contract is re-imposed per tile by ``masked_dist_tile``.
    Returns (padded X, original n)."""
    n = X.shape[0]
    m = -(-n // quantum) * quantum
    if m == n:
        return X, n
    pad = torch.zeros((m - n, X.shape[1]), dtype=X.dtype, device=X.device)
    return torch.cat([X, pad]), n
