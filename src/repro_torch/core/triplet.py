"""Block-symmetric ("triplet-flavoured") PaLD: the executor of
``method="triplet"`` (counterpart of ``repro.core.triplet``).

The paper's triplet algorithm (Algorithm 2) exploits the symmetry of
unordered triplets at the cost of scattered writes.  Lifted from scalars
to blocks, only the nb(nb+1)/2 upper-triangular (X, Y) block pairs are
visited, and each off-diagonal visit performs both role updates

    C[x, z] += support_weight(d_xz, d_yz, d_xy) * W[x, y]   (x-role)
    C[y, z] += support_weight(d_yz, d_xz, d_xy) * W[x, y]   (y-role)

so every unordered pair is touched once.  Diagonal blocks apply the
one-sided x-role, which covers both orders of the pairs inside the block.
Pass 1 computes the upper focus tiles and mirrors them.  ``ignore``'s index
tiebreak is "x > y" for the x-role and its converse for the y-role.

That is the tri schedule's algorithm, so :func:`pald_block_symmetric`
runs ``kernels/ops.pald_tri`` on its plain torch versions
(``focus_tri_torch``, ``cohesion_tri_torch``) with the reduced axis in one
chunk, as the reference's ``pald_block_symmetric`` (``jnp`` and
``einsum``, no kernel) takes it.  The executor runs the same pipeline on
D's device: the plain versions on the CPU, the tri CUDA kernels on the
card (what ``method="kernel", schedule="tri"`` runs), whose C equals the
plain versions' within rounding.  On the card a (b, n, n) chunk runs
as one (``ops.pald_tri``); the plain versions take it item by item.
"""
from __future__ import annotations

import torch

from . import engine as _engine
from .weights import DEFAULT_TIES

__all__ = ["pald_block_symmetric"]


def pald_block_symmetric(D, *, block: int = 128, normalize: bool = False,
                         n_valid: int | None = None,
                         ties=DEFAULT_TIES) -> torch.Tensor:
    """C (n, n) of a symmetric (n, n) D over the upper block pairs, the
    reference's ``pald_block_symmetric`` with its signature: n must be a
    multiple of ``block`` (the caller pads), ``n_valid`` zeroes the
    weights of padded points.  Runs on D's device, on the plain versions."""
    from repro_torch.kernels.ops import pald_tri

    D = torch.as_tensor(D).to(torch.float32)
    n = D.shape[0]
    assert n % block == 0, "caller must pad to a block multiple"
    return pald_tri(D, block=block, block_z=n, normalize=normalize,
                    n_valid=n_valid, impl="torch", ties=ties)


@_engine.register_executor("distance", "triplet", "dense", chunks=True)
def _exec_triplet(D, plan):
    from repro_torch.kernels.ops import pald_tri

    Dp, n0 = _engine.pad_distance_matrix(D, plan.block)  # f32 boundary cast
    nv = n0 if Dp.shape[-1] != n0 else None
    C = _engine.chunk_or_items(
        lambda d: pald_tri(d, block=plan.block, block_z=Dp.shape[-1],
                           n_valid=nv, ties=plan.weight),  # D's device's impl
        Dp, None)
    C = C[..., :n0, :n0]
    return C / max(n0 - 1, 1) if plan.normalize else C
