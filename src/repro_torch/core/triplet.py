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

That is the tri schedule's algorithm, so this cell runs
``kernels/ops.pald_tri`` on its plain torch versions
(``focus_tri_torch``, ``cohesion_tri_torch``) with the reduced axis in one
chunk, as the reference's ``pald_block_symmetric`` (``jnp`` and
``einsum``, no kernel) takes it; ``method="kernel", schedule="tri"`` is the
same schedule on the CUDA kernels.
"""
from __future__ import annotations

from . import engine as _engine


@_engine.register_executor("distance", "triplet", "dense")
def _exec_triplet(D, plan):
    from repro_torch.kernels.ops import pald_tri

    Dp, n0 = _engine.pad_distance_matrix(D, plan.block)  # f32 boundary cast
    nv = n0 if Dp.shape[0] != n0 else None
    C = pald_tri(Dp, block=plan.block, block_z=Dp.shape[0], n_valid=nv,
                 impl="torch", ties=plan.weight)
    C = C[:n0, :n0]
    return C / max(n0 - 1, 1) if plan.normalize else C
