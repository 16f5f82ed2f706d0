"""Plain torch oracles for the PaLD kernels (counterpart of
``repro.kernels.ref``).

Kept deliberately naive (one O(n^3) broadcast) so kernel tests compare
against straight-line torch semantics, independent of the chunked plain
versions beside the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.weights import (DEFAULT_TIES, focus_weight,
                                      resolve_weight, support_weight)

__all__ = ["focus_ref", "cohesion_ref", "weights_ref"]


def focus_ref(D: torch.Tensor, *, ties=DEFAULT_TIES) -> torch.Tensor:
    D = D.to(torch.float32)
    m = focus_weight(D[:, None, :], D[None, :, :], D[:, :, None], ties)
    return torch.sum(m, dim=-1, dtype=torch.float32)


def weights_ref(U: torch.Tensor, n_valid=None) -> torch.Tensor:
    """W = 1/U with a zero diagonal, zero where U == 0, and zero rows and
    columns for padded points (index >= ``n_valid``); U may be a (b, n, n)
    chunk, each item taken alike.

    Built in place in the one (n, n) output, so the step holds U, W and an
    (n, n) bool mask, no float temporaries: at n = 8192 each float buffer
    is 256 MiB.  ``reciprocal`` is the IEEE quotient 1/U on the CPU and the
    card, as ``1.0 / U`` is.
    """
    zero = U == 0
    W = torch.where(zero, 1.0, U.to(torch.float32))
    W.reciprocal_()
    W.masked_fill_(zero, 0.0)
    del zero
    W.diagonal(dim1=-2, dim2=-1).fill_(0.0)
    if n_valid is not None:
        W[..., n_valid:, :] = 0.0
        W[..., :, n_valid:] = 0.0
    return W


def cohesion_ref(D: torch.Tensor, W: torch.Tensor, *,
                 ties=DEFAULT_TIES) -> torch.Tensor:
    ties = resolve_weight(ties)
    D = D.to(torch.float32)
    n = D.shape[0]
    ids = torch.arange(n, device=D.device)
    xw = ((ids[:, None] > ids[None, :])[:, :, None]
          if ties.needs_index_tiebreak else None)
    # g[x, y, z] = support_weight(d_xz, d_yz, d_xy)
    g = support_weight(D[:, None, :], D[None, :, :], D[:, :, None], ties, xw)
    return torch.einsum("xyz,xy->xz", g, W.to(torch.float32))
