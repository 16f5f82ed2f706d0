"""PaLD pass 1 on the upper-triangular block schedule: the CUDA kernel's
wrapper and its plain torch version.

    U[x, y] = sum_z focus_weight(D[x, z], D[y, z], D[x, y])    (D symmetric)

U is symmetric, so only the nb(nb+1)/2 block pairs X <= Y are computed and
each off-diagonal tile is mirrored into U[Y, X]: about half the triples of
the dense grid.  The kernel that replaces the TPU kernel
``repro/kernels/pald_focus_tri.py::focus_tri_pallas`` is the dense focus
kernel's square entry (``csrc/pald_focus.cu``, launched by
``pald_focus.launch_square``), one thread block per upper pair storing the
tile and its transpose (the TPU kernel's packed buffer and scatter are
gone), so its U is bitwise the dense kernel's.  The source notes have the
details.

D must be symmetric; on an asymmetric D the result is unspecified and
differs between the two routes: the kernel gives the dense U of that D
(its per-tile test sends an asymmetric tile's mirror to a second z loop),
the plain version mirrors the upper 128-row blocks.

:func:`focus_tri_cuda` dispatches on the tensor's device: CUDA tensors
launch the kernel (or raise), CPU tensors take :func:`focus_tri_torch`,
the counterpart of the reference's ``ops._focus_tri_jnp``.
The kernel also takes a (b, n, n) chunk of items, in one grid; the plain
version takes one item.
"""
from __future__ import annotations

import torch

from repro_torch.core.weights import DEFAULT_TIES, focus_weight, kernel_spec

from .pald_focus import (SMEM_PER_CTA, adaptive_chunk, check_operands,
                         item_grids, launch_square)

__all__ = ["focus_tri_cuda", "focus_tri_torch", "tri_pairs", "SMEM_PER_CTA"]


def tri_pairs(n: int, block: int):
    """The upper-triangular block pairs of an n x n matrix cut into
    ``block`` rows, X-major as ``numpy.triu_indices`` orders them, as
    ((x0, x1), (y0, y1)) row ranges with x0 <= y0.  The last block is
    ragged when ``block`` does not divide n (the counterpart of the
    reference's ``ops._tri_pairs``, which needs a padded n)."""
    edges = [(s, min(s + block, n)) for s in range(0, n, block)]
    return [(edges[i], edges[j]) for i in range(len(edges))
            for j in range(i, len(edges))]


def focus_tri_torch(D, *, block: int = 128, block_z: int = 512,
                    ties=DEFAULT_TIES) -> torch.Tensor:
    """Plain torch U (n, n) over the upper block pairs, each tile mirrored
    (any device); z in chunks of at most ``block_z``."""
    n = D.shape[0]
    U = torch.empty((n, n), dtype=torch.float32, device=D.device)
    for (x0, x1), (y0, y1) in tri_pairs(n, block):
        Dx, Dy = D[x0:x1], D[y0:y1]
        thr = Dx[:, y0:y1, None]
        c = adaptive_chunk(x1 - x0, y1 - y0, block_z)
        blk = torch.zeros((x1 - x0, y1 - y0), dtype=torch.float32,
                          device=D.device)
        for s in range(0, n, c):
            m = focus_weight(Dx[:, None, s:s + c], Dy[None, :, s:s + c], thr,
                             ties)
            blk += torch.sum(m, dim=-1, dtype=torch.float32)
        U[x0:x1, y0:y1] = blk
        U[y0:y1, x0:x1] = blk.T
    return U


def focus_tri_cuda(D, *, ties=DEFAULT_TIES) -> torch.Tensor:
    """U (n, n) through the CUDA kernel for CUDA tensors, through
    :func:`focus_tri_torch` for CPU tensors.

    D must be a contiguous float32 (n, n) tensor, or a (b, n, n) chunk
    (``ops`` prepares it); anything else raises, as does a weight
    functional that does not compile.  D must be symmetric (see the module
    notes).  Each launch adds one to ``focus_tri_cuda.launches`` (and to
    ``.grid_launches``: one grid for a whole chunk); the kernel counts its
    nb (nb + 1) / 2 thread blocks per item (:func:`pald_focus.tile_counts`).
    """
    dev = D.device
    if dev.type == "cpu":
        return focus_tri_torch(D, ties=ties)
    if dev.type != "cuda":
        raise ValueError(f"focus_tri_cuda: unsupported device {dev}")
    spec = kernel_spec(ties)
    lead, n = (tuple(D.shape[:1]) if D.ndim == 3 else ()), D.shape[-1]
    check_operands("focus_tri_cuda", dev, D=(D, lead + (n, n),
                                             torch.float32))
    U = torch.empty(lead + (n, n), dtype=torch.float32, device=dev)
    if U.numel() == 0:
        return U
    launch_square(D, U, spec)
    focus_tri_cuda.launches += 1
    focus_tri_cuda.grid_launches += item_grids(D.shape[0] if lead else 1)
    return U


focus_tri_cuda.launches = 0
focus_tri_cuda.grid_launches = 0
