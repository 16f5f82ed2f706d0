"""Entry points of the PaLD kernel pipeline (counterpart of
``repro.kernels.ops``, dense schedule).

The *general* (rectangular) forms are the primitives the square pipeline
calls, and that distributed bodies will call per device:

    focus_general(DXZ, DYZ, DXY)        -> U (mx, my)
    cohesion_general(DXZ, DYZ, DXY, W)  -> C (mx, mz)

``impl`` picks the implementation: ``"cuda"`` the hand-written kernels
(``pald_focus.py`` / ``pald_cohesion.py``; on CPU tensors their wrappers
take the plain version), ``"torch"`` the plain torch versions on any
device, ``None`` the device's default (``"cuda"`` for CUDA tensors,
``"torch"`` otherwise).  The kernels take any shape: they mask ragged
edges themselves, so unlike the TPU pipeline nothing here pads to a tile
multiple, and ``block`` / ``block_z`` only set the plain versions' chunks.

``pald_fused(X)`` is the fused features pipeline: both passes straight
from (n, d) feature vectors (``pald_fused.py``), D never materialized.

Every entry point takes ``ties`` (a mode string, a registered functional
name, or a ``WeightFunctional``).  The upper-triangular schedule and the
sparse k-NN pipeline are later slices of the port (ROADMAP.md, queue 1):
their entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as _engine
from repro_torch.core.weights import DEFAULT_TIES, resolve_weight

from .pald_cohesion import cohesion_general_cuda, cohesion_general_torch
from .pald_focus import focus_general_cuda, focus_general_torch
from .pald_fused import (cohesion_fused_cuda, cohesion_fused_torch,
                         focus_fused_cuda, focus_fused_torch)
from .ref import weights_ref

__all__ = [
    "pald",
    "pald_tri",
    "pald_fused",
    "pald_knn",
    "knn_values",
    "topk_select",
    "select_cohere",
    "focus",
    "cohesion_from_weights",
    "focus_general",
    "cohesion_general",
    "IMPLS",
]

IMPLS = ("cuda", "torch")

_TRI = "schedule='tri' is the upper-triangular slice (ROADMAP.md queue 1, item 4)"
_KNN = "the sparse k-NN pipeline is its own slice (ROADMAP.md queue 1, item 6)"


def default_impl(device) -> str:
    """``"cuda"`` on a CUDA device, ``"torch"`` elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    return impl


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def focus_general(DXZ, DYZ, DXY, *, block=128, block_z=512,
                  impl: str | None = None, ties=DEFAULT_TIES) -> torch.Tensor:
    ties = resolve_weight(ties)
    impl = _check_impl(impl or default_impl(DXZ.device))
    DXZ, DYZ, DXY = _f32(DXZ), _f32(DYZ), _f32(DXY)
    if impl == "torch":
        return focus_general_torch(DXZ, DYZ, DXY, chunk=int(block_z),
                                   ties=ties)
    return focus_general_cuda(DXZ, DYZ, DXY, ties=ties)


def cohesion_general(DXZ, DYZ, DXY, W, *, block=128, block_z=512,
                     impl: str | None = None, ties=DEFAULT_TIES,
                     xwins=None, xw_offsets=None) -> torch.Tensor:
    """For ``needs_index_tiebreak`` functionals (``ties='ignore'``) the
    rectangular form needs the global-index tiebreak: ``xwins`` (mx, my)
    bool, "global index of x > global index of y", or static ``xw_offsets``
    = (row_off, col_off) from which it is derived per tile (the square case
    passes (0, 0))."""
    ties = resolve_weight(ties)
    impl = _check_impl(impl or default_impl(DXZ.device))
    DXZ, DYZ, DXY, W = _f32(DXZ), _f32(DYZ), _f32(DXY), _f32(W)
    if not ties.needs_index_tiebreak:
        xwins = xw_offsets = None
    elif xwins is not None:
        xwins, xw_offsets = xwins.to(torch.bool).contiguous(), None
    if impl == "torch":
        return cohesion_general_torch(DXZ, DYZ, DXY, W, xwins,
                                      chunk=int(block), ties=ties,
                                      xw_offsets=xw_offsets)
    return cohesion_general_cuda(DXZ, DYZ, DXY, W, xwins, ties=ties,
                                 xw_offsets=xw_offsets)


def focus(D, *, block=128, block_z=512, impl: str | None = None,
          schedule: str = "dense", ties=DEFAULT_TIES) -> torch.Tensor:
    """Square local-focus sizes U (n, n)."""
    if schedule != "dense":
        raise NotImplementedError(_TRI)
    return focus_general(D, D, D, block=block, block_z=block_z, impl=impl,
                         ties=ties)


def cohesion_from_weights(D, W, *, block=128, block_z=512,
                          impl: str | None = None, schedule: str = "dense",
                          ties=DEFAULT_TIES) -> torch.Tensor:
    """Pass 2 from precomputed reciprocal weights W = 1/U.  The square
    case derives the index tiebreak per tile (``xw_offsets=(0, 0)``)."""
    ties = resolve_weight(ties)
    if schedule != "dense":
        raise NotImplementedError(_TRI)
    offs = (0, 0) if ties.needs_index_tiebreak else None
    return cohesion_general(D, D, D, W, block=block, block_z=block_z,
                            impl=impl, ties=ties, xw_offsets=offs)


def pald(D, *, block=128, block_z=512, normalize: bool = False, n_valid=None,
         impl: str | None = None, schedule: str = "dense",
         ties=DEFAULT_TIES) -> torch.Tensor:
    """Full PaLD through the two passes: D -> U -> W = 1/U -> C.

    impl: 'cuda' (the hand-written kernels), 'torch' (plain versions), or
    None for the device's default.  ``n_valid`` zeroes the weights of
    padded points (index >= n_valid).  ties: weight functional shared by
    both passes.
    """
    if schedule != "dense":
        raise NotImplementedError(_TRI)
    U = focus(D, block=block, block_z=block_z, impl=impl, ties=ties)
    W = weights_ref(U, n_valid)
    C = cohesion_from_weights(D, W, block=block, block_z=block_z, impl=impl,
                              ties=ties)
    if normalize:
        C = C / (D.shape[0] - 1)
    return C


def pald_tri(*args, **kwargs):
    raise NotImplementedError(_TRI)


def pald_fused(X, *, metric: str = "euclidean", block=None, block_z=None,
               normalize: bool = False, impl: str | None = None,
               ties=DEFAULT_TIES) -> torch.Tensor:
    """Fused features -> cohesion pipeline: X (n, d) -> C (n, n).

    Both passes compute their distance tiles from the feature rows as they
    go (``impl="cuda"``: inside the kernels of ``pald_fused.py``; on CPU
    tensors, and with ``impl="torch"``, the plain versions' (block, n)
    slabs), so the (n, n) distance matrix never exists: U, W = 1/U and C
    are the only (n, n) buffers.  The kernels mask ragged edges
    themselves, so no row is padded.  ``block`` / ``block_z`` set the
    plain versions' row block and reduced-axis chunk (default 128 / 512);
    the kernels' tiles are fixed.  Peak memory: U, W and an (n, n) bool
    mask while W is built, then W and C.
    """
    ties = resolve_weight(ties)
    impl = _check_impl(impl or default_impl(X.device))
    X = _f32(X)  # the one boundary cast
    n = X.shape[0]
    if impl == "torch":
        kw = dict(metric=metric, block=int(block or 128),
                  block_z=int(block_z or 512), ties=ties)
        U = focus_fused_torch(X, **kw)
        W = weights_ref(U)
        del U
        C = cohesion_fused_torch(X, W, **kw)
    else:
        U = focus_fused_cuda(X, metric=metric, ties=ties)
        W = weights_ref(U)
        del U
        C = cohesion_fused_cuda(X, W, metric=metric, ties=ties)
    if normalize:
        C.div_(max(n - 1, 1))  # in place: no fourth (n, n) buffer
    return C


def pald_knn(*args, **kwargs):
    raise NotImplementedError(_KNN)


def knn_values(*args, **kwargs):
    raise NotImplementedError(_KNN)


def topk_select(*args, **kwargs):
    raise NotImplementedError(_KNN)


def select_cohere(*args, **kwargs):
    raise NotImplementedError(_KNN)


# --------------------------------------------------------------------------
# engine executor: the kernel-pipeline cell of the dispatch registry
# (repro_torch.core.engine).  It receives one unbatched item plus the
# resolved plan; tiles, impl and weight were fixed once at plan() time.
# --------------------------------------------------------------------------
def _kernel_exec(D, plan, pipeline):
    Dp, n0 = _engine.pad_distance_matrix(D, plan.block)  # f32 boundary cast
    nv = n0 if Dp.shape[0] != n0 else None
    kz = {} if plan.block_z is None else {"block_z": plan.block_z}
    C = pipeline(Dp, block=plan.block, n_valid=nv, impl=plan.impl,
                 ties=plan.weight, **kz)
    C = C[:n0, :n0]
    return C / max(n0 - 1, 1) if plan.normalize else C


@_engine.register_executor("distance", "kernel", "dense")
def _exec_kernel_dense(D, plan):
    return _kernel_exec(D, plan, pald)


@_engine.register_executor("features", "fused", "dense")
def _exec_fused(X, plan):
    return pald_fused(X, metric=plan.metric, block=plan.block,
                      block_z=plan.block_z, normalize=plan.normalize,
                      impl=plan.impl, ties=plan.weight)
