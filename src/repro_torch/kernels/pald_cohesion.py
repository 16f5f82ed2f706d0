"""PaLD pass 2, cohesion accumulation: the CUDA kernel's wrapper and its
plain torch version.

    C[x, z] = sum_y support_weight(DXZ[x, z], DYZ[y, z], DXY[x, y]) * W[x, y]

The kernel (``csrc/pald_cohesion.cu``, its body in
``csrc/pald_cohesion.cuh``) replaces the TPU kernel
``repro/kernels/pald_cohesion.py::cohesion_general_pallas``.  It is bound
by operations (n^3 triples, 3 lane instructions each for the strict
families, against 5 n^2 floats of memory traffic), so it is
register-blocked: a 64 x 64 (x, z) C tile per thread block, 4 x 4 outputs
per thread with their DXZ values in registers, y streamed through shared
memory with DYZ, DXY and W, the next slab copied while the current one
runs.  ``drop``, ``ignore`` and ``kernelized`` add W under a predicate
instead of multiplying it by a {0, 1} select when every W is finite
(:func:`add_form`), bitwise the same sum.  The source note in the ``.cuh``
file has the details.

Functionals that declare ``needs_index_tiebreak`` (``ignore``) need the
global "x index > y index" predicate: either an explicit (mx, my) bool
``xwins`` (callers whose row identities are data) or static ``xw_offsets
= (row_off, col_off)`` from which it is derived per tile (the square case
passes (0, 0)).

:func:`cohesion_general_cuda` dispatches on the tensors' device: CUDA
tensors launch the kernel (or raise), CPU tensors take
:func:`cohesion_general_torch`, the counterpart of the reference's
``ops._cohesion_general_jnp``.  The kernel also takes (b, ...) chunks of
operands (the engine's ``batch=`` chunks on the card) and runs every item
in one grid, the item on ``blockIdx.z``; the chunk's C is bitwise its
items' one at a time.  The plain version takes one item.
"""
from __future__ import annotations

import torch

from repro_torch.core.weights import (DEFAULT_TIES, KERNEL_DROP,
                                      KERNEL_IGNORE, KERNEL_KERNELIZED,
                                      index_xwins, kernel_spec,
                                      resolve_weight, support_weight)

from . import _build
from .pald_focus import adaptive_chunk, check_operands, item_grids

__all__ = ["cohesion_general_cuda", "cohesion_general_torch", "add_form",
           "SMEM_PER_CTA"]

# two buffers of (32, 64) DYZ, DXY and W slabs and a (32, 68) byte
# tiebreak slab, and one (64, 32) landing tile of DXY and of W
# (csrc/pald_cohesion.cuh: CohesionSmem)
SMEM_PER_CTA = 2 * (4 * 3 * 32 * 64 + 32 * 68) + 4 * 2 * 64 * 32

# the families with a predicated form (csrc/pald_weights.cuh kPredicated)
_PREDICATED = (KERNEL_DROP, KERNEL_IGNORE, KERNEL_KERNELIZED)


def add_form(wid: int, W: torch.Tensor) -> int:
    """1 when the cohesion kernels may add W under a predicate: the family
    has that form and every W is finite.  The predicated sum is bitwise the
    multiply form's on a finite W; a W with an infinite or nan entry takes
    the multiply form, which gives the reference's nan (0 * inf).  For a
    chunk of items it decides once: one non-finite item sends the whole
    chunk to the multiply form, which changes no finite item's bits.

    One read of W through ``aminmax`` (nan propagates to both ends), no
    temporary: ``torch.isfinite(W)`` would hold an (n, n) float ``abs(W)``
    and three bool masks, 1.75 n^2 float32 buffers at the pipeline's peak.
    """
    if wid not in _PREDICATED:
        return 0
    if W.numel() == 0:
        return 1
    lo, hi = torch.aminmax(W)
    return int(bool(torch.isfinite(lo) & torch.isfinite(hi)))


def _require_tiebreak(wfun, xwins, xw_offsets):
    if wfun.needs_index_tiebreak and xwins is None and xw_offsets is None:
        raise ValueError(f"weight {wfun.name!r} needs xwins or xw_offsets "
                         "(global-index tiebreak)")


def cohesion_general_torch(DXZ, DYZ, DXY, W, xwins=None, *, chunk: int = 128,
                           ties=DEFAULT_TIES, xw_offsets=None) -> torch.Tensor:
    """Plain torch C (mx, mz), y in chunks (any device).  The explicit
    ``xwins`` wins over ``xw_offsets`` when both are given."""
    wfun = resolve_weight(ties)
    _require_tiebreak(wfun, xwins, xw_offsets)
    mx, mz = DXZ.shape
    my = DYZ.shape[0]
    c = adaptive_chunk(mx, mz, chunk)
    C = torch.zeros((mx, mz), dtype=torch.float32, device=DXZ.device)
    own_d = DXZ[:, None, :]
    for s in range(0, my, c):
        e = min(s + c, my)
        own = None
        if wfun.needs_index_tiebreak:
            own = (xwins[:, s:e, None] if xwins is not None
                   else index_xwins(xw_offsets[0], mx, xw_offsets[1] + s,
                                    e - s, device=DXZ.device)[:, :, None])
        g = support_weight(own_d, DYZ[None, s:e, :], DXY[:, s:e, None], wfun,
                           own)
        C += torch.einsum("xyz,xy->xz", g, W[:, s:e])
    return C


def cohesion_general_cuda(DXZ, DYZ, DXY, W, xwins=None, *, ties=DEFAULT_TIES,
                          xw_offsets=None) -> torch.Tensor:
    """C (mx, mz) through the CUDA kernel for CUDA tensors, through
    :func:`cohesion_general_torch` for CPU tensors.

    CUDA operands must be contiguous float32 (``xwins``: bool) on one
    device (``ops`` prepares them); anything else raises, as does a weight
    functional that does not compile.  W is checked for non-finite entries
    (:func:`add_form`).  Operands with a leading item axis, (b, mx, mz),
    (b, my, mz), (b, mx, my) (W and ``xwins`` too), are a chunk: one grid
    for all b, C (b, mx, mz).  Each launch adds one to
    ``cohesion_general_cuda.launches`` (and to ``.grid_launches``: one
    grid).
    """
    dev = DXZ.device
    if dev.type == "cpu":
        return cohesion_general_torch(DXZ, DYZ, DXY, W, xwins, ties=ties,
                                      xw_offsets=xw_offsets)
    if dev.type != "cuda":
        raise ValueError(f"cohesion_general_cuda: unsupported device {dev}")
    wfun = resolve_weight(ties)
    spec = kernel_spec(wfun)
    wid, p0, p1 = spec
    _require_tiebreak(wfun, xwins, xw_offsets)
    lead = tuple(DXZ.shape[:1]) if DXZ.ndim == 3 else ()
    mx, mz = DXZ.shape[-2:]
    my = DYZ.shape[-2]
    f32 = torch.float32
    named = dict(DXZ=(DXZ, lead + (mx, mz), f32),
                 DYZ=(DYZ, lead + (my, mz), f32),
                 DXY=(DXY, lead + (mx, my), f32),
                 W=(W, lead + (mx, my), f32))
    xw_ptr, row_off, col_off = None, 0, 0
    if wfun.needs_index_tiebreak:
        if xwins is not None:
            named["xwins"] = (xwins, lead + (mx, my), torch.bool)
            xw_ptr = xwins.data_ptr()
        else:
            row_off, col_off = int(xw_offsets[0]), int(xw_offsets[1])
    check_operands("cohesion_general_cuda", dev, **named)
    C = torch.empty(lead + (mx, mz), dtype=f32, device=dev)
    if C.numel() == 0:
        return C
    items = lead[0] if lead else 1
    fn = _build.load("pald_cohesion_f32", spec.functor)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(DXZ.data_ptr(), DYZ.data_ptr(), DXY.data_ptr(),
                    W.data_ptr(), xw_ptr, C.data_ptr(), mx, my, mz, items,
                    row_off, col_off, wid, p0, p1, add_form(wid, W), stream)
    _build.check(status, "pald_cohesion_f32")
    cohesion_general_cuda.launches += 1
    cohesion_general_cuda.grid_launches += item_grids(items)
    return C


cohesion_general_cuda.launches = 0
cohesion_general_cuda.grid_launches = 0
