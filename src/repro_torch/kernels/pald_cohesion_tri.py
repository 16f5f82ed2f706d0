"""PaLD pass 2 on the upper-triangular block schedule: the CUDA kernel's
wrapper and its plain torch version.

Cohesion support is a property of the unordered pair, so the reference
visits only the block pairs X <= Y, and each off-diagonal visit applies
both role updates from the upper tiles D[X, Y] and W[X, Y]:

    x-role:  C[x, z] += support_weight(D[x, z], D[y, z], D[x, y]) * W[x, y]
    y-role:  C[y, z] += support_weight(D[y, z], D[x, z], D[x, y]) * W[x, y]

A diagonal block applies the x-role alone, over both orders of every pair
inside it.  ``ignore``'s index tiebreak is "x > y" for the x-role and its
converse for the y-role.  D and W are taken as symmetric (the tri
pipeline's U, hence W, is symmetric by construction): their lower tiles
are never read.

The kernel (``csrc/pald_cohesion_tri.cu``) replaces the TPU kernel
``repro/kernels/pald_cohesion_tri.py::cohesion_tri_pallas``.  It is the
dense cohesion kernel (``csrc/pald_cohesion.cuh``) reading each pair tile
from the upper triangle: a thread block owns C[R, Z] for a row block R
and walks the partner rows in ascending order, those below R as y-roles
(the upper tile D[Q, R] as it lies), the others as x-roles.  One grid, C
written once, no atomics: C is the same bits on every call, and on a
symmetric D and W bitwise the dense kernel's C.  The source notes have
the details.

:func:`cohesion_tri_cuda` dispatches on the tensors' device: CUDA tensors
launch the kernel (or raise), CPU tensors take :func:`cohesion_tri_torch`,
the counterpart of the reference's ``ops._cohesion_tri_jnp``.
The kernel also takes a (b, n, n) chunk of items, in one grid; the plain
version takes one item.
"""
from __future__ import annotations

import torch

from repro_torch.core.weights import (DEFAULT_TIES, index_xwins, kernel_spec,
                                      resolve_weight, support_weight)

from . import _build
from .pald_cohesion import SMEM_PER_CTA, add_form
from .pald_focus import adaptive_chunk, check_operands, item_grids
from .pald_focus_tri import tri_pairs

__all__ = ["cohesion_tri_cuda", "cohesion_tri_torch", "SMEM_PER_CTA"]


def cohesion_tri_torch(D, W, *, block: int = 128, block_z: int = 512,
                       ties=DEFAULT_TIES) -> torch.Tensor:
    """Plain torch C (n, n) over the upper block pairs, both roles per
    off-diagonal pair (any device); z in chunks of at most ``block_z``."""
    wfun = resolve_weight(ties)
    n = D.shape[0]
    dev = D.device
    C = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for (x0, x1), (y0, y1) in tri_pairs(n, block):
        bx, by = x1 - x0, y1 - y0
        Dx, Dy = D[x0:x1], D[y0:y1]
        Dxy, Wxy = D[x0:x1, y0:y1], W[x0:x1, y0:y1]
        diag = x0 == y0
        xw = yw = None
        if wfun.needs_index_tiebreak:
            xw = index_xwins(x0, bx, y0, by, device=dev)[:, :, None]
            yw = index_xwins(y0, by, x0, bx, device=dev)[:, :, None]
        c = adaptive_chunk(bx, by, block_z)
        for s in range(0, n, c):
            e = min(s + c, n)
            gx = support_weight(Dx[:, None, s:e], Dy[None, :, s:e],
                                Dxy[:, :, None], wfun, xw)
            C[x0:x1, s:e] += torch.einsum("xyz,xy->xz", gx, Wxy)
            if not diag:
                gy = support_weight(Dy[:, None, s:e], Dx[None, :, s:e],
                                    Dxy.T[:, :, None], wfun, yw)
                C[y0:y1, s:e] += torch.einsum("yxz,yx->yz", gy, Wxy.T)
    return C


def cohesion_tri_cuda(D, W, *, ties=DEFAULT_TIES) -> torch.Tensor:
    """C (n, n) through the CUDA kernel for CUDA tensors, through
    :func:`cohesion_tri_torch` for CPU tensors.

    D and W must be contiguous float32 (n, n) tensors, or (b, n, n)
    chunks, on one device (``ops`` prepares them); anything else raises,
    as does a weight functional that does not compile.  W is checked for
    non-finite entries (``pald_cohesion.add_form``, once for a chunk).
    Besides C the call allocates nothing.  Each call adds one to
    ``cohesion_tri_cuda.launches`` and to ``.grid_launches`` (one grid,
    for a whole chunk).
    """
    dev = D.device
    if dev.type == "cpu":
        return cohesion_tri_torch(D, W, ties=ties)
    if dev.type != "cuda":
        raise ValueError(f"cohesion_tri_cuda: unsupported device {dev}")
    spec = kernel_spec(ties)
    wid, p0, p1 = spec
    lead, n = (tuple(D.shape[:1]) if D.ndim == 3 else ()), D.shape[-1]
    f32 = torch.float32
    check_operands("cohesion_tri_cuda", dev, D=(D, lead + (n, n), f32),
                   W=(W, lead + (n, n), f32))
    C = torch.empty(lead + (n, n), dtype=f32, device=dev)
    if C.numel() == 0:
        return C
    items = lead[0] if lead else 1
    fn = _build.load("pald_cohesion_tri_f32", spec.functor)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(D.data_ptr(), W.data_ptr(), C.data_ptr(), n, items, wid,
                    p0, p1, add_form(wid, W), stream)
    _build.check(status, "pald_cohesion_tri_f32")
    cohesion_tri_cuda.launches += 1
    cohesion_tri_cuda.grid_launches += item_grids(items)
    return C


cohesion_tri_cuda.launches = 0
cohesion_tri_cuda.grid_launches = 0
