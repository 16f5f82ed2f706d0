"""Branch-free pairwise PaLD in plain torch (counterpart of
``repro.core.pairwise``): the in-port oracles of the kernel pipeline.

``pald_dense(D)``
    Un-blocked formulation; materializes (n, n, z_chunk) masks per chunk.
``pald_blocked(D, block=...)``
    The paper's blocked loop structure (Fig. 5): a loop over (X, Y) block
    pairs, each streaming every third point at once.

Both compute, with W = 1/U (zero diagonal):

    U[x, y] = sum_z focus_weight(D[x,z], D[y,z], D[x,y])
    C[x, z] = sum_y support_weight(D[x,z], D[y,z], D[x,y]) * W[x,y]

with the focus/support contributions of the resolved weight functional
(``core/weights.py``).
"""
from __future__ import annotations

import torch

from .weights import (DEFAULT_TIES, focus_weight, index_xwins, resolve_weight,
                      support_weight)

__all__ = ["local_focus_dense", "pald_dense", "pald_blocked"]


def _z_chunks(D: torch.Tensor, z_chunk: int):
    """Rows of D in chunks of ``z_chunk`` (d_zx == d_xz by symmetry)."""
    for s in range(0, D.shape[0], z_chunk):
        yield s, D[s:s + z_chunk]


def local_focus_dense(D: torch.Tensor, *, z_chunk: int | None = None,
                      ties=DEFAULT_TIES) -> torch.Tensor:
    """U[x,y] = #{z : d_xz < d_xy or d_yz < d_xy}, computed in z-chunks
    (fractional boundary-tie membership under ``ties='split'``)."""
    D = D.to(torch.float32)
    n = D.shape[0]
    U = torch.zeros((n, n), dtype=torch.float32, device=D.device)
    for _, Dz in _z_chunks(D, z_chunk or max(n, 1)):
        dxz = Dz.T  # (n, zc): d_xz for x in rows
        m = focus_weight(dxz[:, None, :], dxz[None, :, :], D[:, :, None], ties)
        U += torch.sum(m, dim=-1, dtype=torch.float32)
    return U


def _weights(U: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """W = 1/U with a zero diagonal; ``n_valid`` zeroes rows/columns of
    padded points so a padded partner never lends support."""
    n = U.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=U.device)
    zero = U == 0
    W = torch.where(eye | zero, 0.0, 1.0 / torch.where(zero, 1.0, U))
    if n_valid is not None:
        valid = torch.arange(n, device=U.device) < n_valid
        W = W * valid[:, None] * valid[None, :]
    return W


def pald_dense(D: torch.Tensor, *, z_chunk: int | None = None,
               normalize: bool = False, ties=DEFAULT_TIES) -> torch.Tensor:
    """Branch-free dense-pairwise PaLD; O(n^2 * chunk) temporaries."""
    ties = resolve_weight(ties)
    D = D.to(torch.float32)
    n = D.shape[0]
    U = local_focus_dense(D, z_chunk=z_chunk, ties=ties)
    W = _weights(U)
    # the ordered (x, y) grid visits both orders, so the x-role index
    # tiebreak suffices
    xwins = (index_xwins(0, n, 0, n, device=D.device)[:, :, None]
             if ties.needs_index_tiebreak else None)
    C = torch.empty((n, n), dtype=torch.float32, device=D.device)
    for s, Dz in _z_chunks(D, z_chunk or max(n, 1)):
        dxz = Dz.T  # (n, zc)
        g = support_weight(dxz[:, None, :], dxz[None, :, :], D[:, :, None],
                           ties, xwins)
        C[:, s:s + Dz.shape[0]] = torch.einsum("xyz,xy->xz", g, W)
    if normalize:
        C = C / (n - 1)
    return C


def pald_blocked(D: torch.Tensor, *, block: int = 128,
                 normalize: bool = False, n_valid: int | None = None,
                 ties=DEFAULT_TIES) -> torch.Tensor:
    """Blocked pairwise PaLD (paper Fig. 5 structure).  n must be a
    multiple of ``block`` (the executor pads)."""
    ties = resolve_weight(ties)
    D = D.to(torch.float32)
    n = D.shape[0]
    if n % block:
        raise ValueError(f"n={n} is not a multiple of block={block}; pad "
                         "first (engine.pad_distance_matrix)")
    blocks = [(b * block, (b + 1) * block) for b in range(n // block)]

    U = torch.zeros((n, n), dtype=torch.float32, device=D.device)
    for x0, x1 in blocks:
        Dx = D[x0:x1]  # d_xz (block, n)
        for y0, y1 in blocks:
            Dy = D[y0:y1]
            m = focus_weight(Dx[:, None, :], Dy[None, :, :],
                             Dx[:, y0:y1, None], ties)
            U[x0:x1, y0:y1] = torch.sum(m, dim=-1, dtype=torch.float32)
    W = _weights(U, n_valid)

    C = torch.zeros((n, n), dtype=torch.float32, device=D.device)
    for x0, x1 in blocks:
        Dx = D[x0:x1]
        for y0, y1 in blocks:
            Dy = D[y0:y1]
            xw = None
            if ties.needs_index_tiebreak:
                xw = index_xwins(x0, block, y0, block,
                                 device=D.device)[:, :, None]
            g = support_weight(Dx[:, None, :], Dy[None, :, :],
                               Dx[:, y0:y1, None], ties, xw)
            C[x0:x1] += torch.einsum("xyz,xy->xz", g, W[x0:x1, y0:y1])
    if normalize:
        C = C / (n - 1)
    return C


# ---------------------------------------------------------------------------
# engine executors: this module's contributions to the dispatch registry.
# ---------------------------------------------------------------------------
from . import engine as _engine  # noqa: E402  (registry import, cycle-free)


@_engine.register_executor("distance", "dense", "dense")
def _exec_dense(D, plan):
    D = D.to(torch.float32)  # explicit boundary cast
    n = D.shape[0]
    C = pald_dense(D, z_chunk=plan.z_chunk, normalize=False, ties=plan.weight)
    return C / max(n - 1, 1) if plan.normalize else C


@_engine.register_executor("distance", "pairwise", "dense")
def _exec_pairwise(D, plan):
    Dp, n0 = _engine.pad_distance_matrix(D, plan.block)  # f32 boundary cast
    nv = n0 if Dp.shape[0] != n0 else None
    C = pald_blocked(Dp, block=plan.block, n_valid=nv, ties=plan.weight)
    C = C[:n0, :n0]
    return C / max(n0 - 1, 1) if plan.normalize else C
