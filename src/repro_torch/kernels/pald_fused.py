"""PaLD's two passes straight from feature vectors: the CUDA kernels'
wrappers and their plain torch versions.

    U[x, y] = sum_z focus_weight(d(x, z), d(y, z), d(x, y))
    C[x, z] = sum_y support_weight(d(x, z), d(y, z), d(x, y)) * W[x, y]

with the distances d computed from the rows of X (n, d) as the passes go.
The kernels (``csrc/pald_fused.cuh``, entries in ``pald_fused.cu`` and,
for a chunk of items, ``pald_fused_chunk.cu``) replace the TPU kernels
``repro/kernels/pald_fused.py::focus_fused_pallas`` and
``cohesion_fused_pallas``.  Each pass walks the reduced axis in panels of
:func:`panel_rows` rows: a panel writer computes the panel's distances
once (``csrc/pald_dist.cuh``) into a (P, ldp) scratch buffer of at most
``PANEL_BUDGET`` bytes, then every output tile runs the dense kernels'
loops (``csrc/pald_tile.cuh``) over the panel's slabs.  So D is never
whole in device memory past n = 4096; up to there one panel holds all of
it, and the pipeline's peak is W, C and that panel, about 3 n^2 float32
buffers (2.25 n^2 from n = 8192 up).  The source note in the ``.cuh`` file has the details.

The distances are bitwise those of ``core.features.cdist_reference`` (the
same operations in the same order), so on the same X the fused U equals
the dense kernels' U on ``cdist_reference(X)``, for every panel size.
Rows at index >= ``n_valid`` are padding (+inf from everything); the
kernels mask ragged edges themselves, so nothing is padded.

:func:`focus_fused_cuda` and :func:`cohesion_fused_cuda` dispatch on the
tensors' device: CUDA tensors launch the kernel (or raise), CPU tensors
take :func:`focus_fused_torch` / :func:`cohesion_fused_torch`, the
counterparts of the reference's ``ops._focus_fused_jnp`` /
``_cohesion_fused_jnp``: (block, m) distance slabs fed to the dense plain
versions, block pair by block pair.

On the card both wrappers also take a (b, n, d) chunk of items (the
engine's ``batch=`` chunks, the reference's vmap) and run it in one launch,
the item on ``blockIdx.z`` of every grid: the chunk's U and C are bitwise
its items' one at a time.  The panel then holds a (P, ldp) slab per item,
so P shrinks with the chunk (:func:`panel_rows`), which changes no bit.
The plain versions take one item; the engine splits a chunk for them.
"""
from __future__ import annotations

import torch

from repro_torch.core.features import METRICS, masked_dist_tile
from repro_torch.core.weights import DEFAULT_TIES, kernel_spec, resolve_weight

from . import _build
from .pald_cohesion import add_form, cohesion_general_torch
from .pald_focus import (MAX_ITEMS, check_operands, focus_general_torch,
                         item_grids)

__all__ = ["focus_fused_cuda", "cohesion_fused_cuda", "focus_fused_torch",
           "cohesion_fused_torch", "dist_fused_cuda", "metric_id",
           "norm_grids", "panel_rows", "panel_stride", "fused_grids"]

# shared memory of one thread block of the fused passes, in bytes
# (csrc/pald_fused.cuh: a 64-row tile, 32-row slabs, focus's in two buffers,
# 16 features staged per step, rows padded by 4 floats); independent of d
_LD, _CHUNK, _SLAB = 68, 16, 32
_STAGE = 4 * _CHUNK * 2 * _LD
SMEM_PER_CTA = {"focus": _STAGE + 2 * 4 * 2 * _SLAB * _LD,
                "cohesion": _STAGE + 4 * _SLAB * _LD + 4 * 2 * _SLAB * 64
                + _SLAB * _LD}

_TILE = 64
# bytes of one distance panel.  A pass reads the panel from L2 a band of
# slabs at a time (the slabs its resident blocks are at), so the panel need
# not fit the H100's 50 MB L2 whole; each panel costs one recomputation of
# the tiles' fixed operand and one read-modify-write of the output.  At
# n = 8192 the sweep of chip_smoke.py phase 8 (PERF.md) gained less each
# doubling of P; 64 MiB is P = 2048 there, a quarter of an n^2 buffer,
# which the pipeline's peak (U, W and W's mask) does not reach.  Below
# that n the panel is a larger share: min(64 MiB, about n^2 * 4 B), the
# whole of D up to n = 4096, so the cohesion pass's W, C and panel reach
# about 3 n^2 buffers there (2.25 n^2 from n = 8192 up).
PANEL_BUDGET = 64 << 20


def panel_stride(n: int) -> int:
    """Floats per panel row: n rounded up to a multiple of 64, so every
    16-byte copy of a slab row is aligned."""
    return -(-int(n) // _TILE) * _TILE


def panel_rows(n: int, items: int = 1) -> int:
    """Rows P of the distance panel the fused passes hold at a time, for
    each of the ``items`` items of one grid: the most that fit
    ``PANEL_BUDGET`` at the panel's row stride for all of them (items x P
    x ldp floats), a multiple of 64 (slab boundaries, and so every sum's
    order, do not depend on P), at least 64 and at most n rounded up to
    64.  Not a knob of the facades: the reference has none."""
    ld = max(panel_stride(n), _TILE)
    p = PANEL_BUDGET // (4 * ld * max(int(items), 1)) // _TILE * _TILE
    return max(_TILE, min(p, ld))


def fused_grids(n: int, metric: str, rows: int | None = None,
                items: int = 1) -> int:
    """Grids one fused pass issues for a chunk of ``items`` items: the
    row-norm pre-pass over all of them (all metrics but manhattan), then,
    for each grid's group of up to ``MAX_ITEMS`` items, a panel writer and
    a pass per panel."""
    rows = panel_rows(n, _grid_items(items)) if rows is None else rows
    return norm_grids(metric) + item_grids(items) * 2 * -(-int(n) // rows)


def _grid_items(items: int) -> int:
    """Items of one grid: the panel holds a slab for each."""
    return max(1, min(int(items), MAX_ITEMS))


def _panel(n: int, rows, items: int = 1) -> int:
    if rows is None:
        return panel_rows(n, items)
    rows = int(rows)
    if rows < _TILE or rows % _TILE:
        raise ValueError(f"panel rows must be a positive multiple of "
                         f"{_TILE}, got {rows}")
    return min(rows, max(panel_stride(n), _TILE))


def metric_id(metric: str) -> int:
    """The kernels' id of ``metric`` (csrc/pald_dist.cuh)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r} (expected one of "
                         f"{METRICS})")
    return METRICS.index(metric)


def norm_grids(metric: str) -> int:
    """Grids of the row-norm pre-pass that a kernel call on ``metric``
    issues before its own: one for every metric but manhattan
    (``Dist<M>::kNorms`` in csrc/pald_dist.cuh)."""
    return int(metric != "manhattan")


def _n_valid(X, n_valid) -> int:
    n = X.shape[-2]
    nv = n if n_valid is None else int(n_valid)
    if not 0 <= nv <= n:
        raise ValueError(f"n_valid={nv} out of range for {n} rows")
    return nv


def _slabs(X, metric, n_valid, block):
    """The masked (block, m) distance row slabs of X, one per row block,
    computed on demand."""
    m = X.shape[0]
    for s in range(0, m, block):
        yield s, masked_dist_tile(X[s:s + block], X, metric, s, 0, n_valid)


def focus_fused_torch(X, *, metric: str = "euclidean", n_valid=None,
                      block: int = 128, block_z: int = 512,
                      ties=DEFAULT_TIES) -> torch.Tensor:
    """Plain torch U (m, m) from X (m, d) (any device): per (x, y) block
    pair, the two (block, m) distance slabs and the dense plain version."""
    metric_id(metric)
    nv = _n_valid(X, n_valid)
    X = X.to(torch.float32)
    m = X.shape[0]
    U = torch.empty((m, m), dtype=torch.float32, device=X.device)
    for x0, Dx in _slabs(X, metric, nv, block):
        for y0, Dy in _slabs(X, metric, nv, block):
            Dxy = Dx[:, y0:y0 + Dy.shape[0]].contiguous()
            U[x0:x0 + Dx.shape[0], y0:y0 + Dy.shape[0]] = focus_general_torch(
                Dx, Dy, Dxy, chunk=block_z, ties=ties)
    return U


def cohesion_fused_torch(X, W, *, metric: str = "euclidean", n_valid=None,
                         block: int = 128, block_z: int = 512,
                         ties=DEFAULT_TIES) -> torch.Tensor:
    """Plain torch C (m, m) from X (m, d) and W = 1/U (any device): per
    (x, y) block pair, the two distance slabs and the dense plain version
    with the global x > y tiebreak."""
    metric_id(metric)
    wfun = resolve_weight(ties)
    nv = _n_valid(X, n_valid)
    X = X.to(torch.float32)
    m = X.shape[0]
    C = torch.empty((m, m), dtype=torch.float32, device=X.device)
    for x0, Dx in _slabs(X, metric, nv, block):
        bx = Dx.shape[0]
        acc = torch.zeros((bx, m), dtype=torch.float32, device=X.device)
        for y0, Dy in _slabs(X, metric, nv, block):
            by = Dy.shape[0]
            offs = (x0, y0) if wfun.needs_index_tiebreak else None
            acc += cohesion_general_torch(
                Dx, Dy, Dx[:, y0:y0 + by].contiguous(),
                W[x0:x0 + bx, y0:y0 + by].contiguous(), chunk=block_z,
                ties=wfun, xw_offsets=offs)
        C[x0:x0 + bx] = acc
    return C


def _launch(symbol, functor, X, out, *ptrs_and_args):
    fn = _build.load(symbol, functor)
    dev = X.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*ptrs_and_args, stream)
    _build.check(status, symbol)
    return out


def _cuda_operands(what, X, n_valid, **more):
    """(lead, n, d, n_valid, items, norms) of a CUDA X (n, d) or chunk
    (b, n, d), the other operands checked against ``lead``: () or (b,)."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if X.ndim not in (2, 3):
        raise ValueError(f"{what}: X must be (n, d) or a (b, n, d) chunk, "
                         f"got shape {tuple(X.shape)}")
    lead = tuple(X.shape[:-2])
    n, d = X.shape[-2:]
    more = {k: (t, lead + shape, dt) for k, (t, shape, dt) in more.items()}
    check_operands(what, dev, X=(X, lead + (n, d), torch.float32), **more)
    nv = _n_valid(X, n_valid)
    items = lead[0] if lead else 1
    norms = torch.empty((items * n,), dtype=torch.float32, device=dev)
    return lead, n, d, nv, items, norms


def _panel_buffer(n: int, rows: int, items: int, dev) -> torch.Tensor:
    """The (items of a grid, P, ldp) panel; the groups of a chunk past
    ``MAX_ITEMS`` items reuse it one after another."""
    return torch.empty((_grid_items(items), rows, panel_stride(n)),
                       dtype=torch.float32, device=dev)


def focus_fused_cuda(X, *, metric: str = "euclidean", n_valid=None,
                     ties=DEFAULT_TIES, _panel_rows=None) -> torch.Tensor:
    """U (n, n) from X (n, d) through the CUDA kernel for CUDA tensors,
    through :func:`focus_fused_torch` for CPU tensors; on the card a
    (b, n, d) chunk gives U (b, n, n) from one launch, bitwise its items.

    A CUDA X must be contiguous float32 (``ops`` prepares it); anything
    else raises, as does a weight functional that does not compile.  The
    call holds one (P, ldp) float32 distance panel per item of a grid
    (:func:`panel_rows`, :func:`panel_stride`) besides U, freed when it
    returns; ``_panel_rows`` overrides P (a positive multiple of 64) for
    the card tests: U is bitwise the same for every P.  Each call that
    launches the kernel adds one to ``focus_fused_cuda.launches``, and the
    grids it issues (:func:`fused_grids`) to ``.grid_launches``.
    """
    if X.device.type == "cpu":
        return focus_fused_torch(X, metric=metric, n_valid=n_valid, ties=ties)
    spec = kernel_spec(ties)
    wid, p0, p1 = spec
    mid = metric_id(metric)
    lead, n, d, nv, items, norms = _cuda_operands("focus_fused_cuda", X,
                                                  n_valid)
    U = torch.empty(lead + (n, n), dtype=torch.float32, device=X.device)
    if U.numel() == 0:
        return U
    rows = _panel(n, _panel_rows, _grid_items(items))
    panel = _panel_buffer(n, rows, items, X.device)
    name, more = _build.entry("pald_focus_fused", items)
    _launch(name, spec.functor, X, U, X.data_ptr(), norms.data_ptr(),
            panel.data_ptr(), U.data_ptr(), n, d, nv, rows, *more, mid, wid,
            p0, p1)
    focus_fused_cuda.launches += 1
    focus_fused_cuda.grid_launches += fused_grids(n, metric, rows, items)
    return U


def cohesion_fused_cuda(X, W, *, metric: str = "euclidean", n_valid=None,
                        ties=DEFAULT_TIES, _panel_rows=None) -> torch.Tensor:
    """C (n, n) from X (n, d) and W = 1/U (n, n) through the CUDA kernel
    for CUDA tensors, through :func:`cohesion_fused_torch` for CPU tensors;
    on the card a (b, n, d) chunk and W (b, n, n) give C (b, n, n) from one
    launch (``add_form`` decides once for the chunk).  Same operand rules,
    panel and counters as :func:`focus_fused_cuda`
    (``cohesion_fused_cuda.launches``, ``.grid_launches``)."""
    if X.device.type == "cpu":
        return cohesion_fused_torch(X, W, metric=metric, n_valid=n_valid,
                                    ties=ties)
    spec = kernel_spec(ties)
    wid, p0, p1 = spec
    mid = metric_id(metric)
    n = X.shape[-2]
    lead, n, d, nv, items, norms = _cuda_operands(
        "cohesion_fused_cuda", X, n_valid, W=(W, (n, n), torch.float32))
    C = torch.empty(lead + (n, n), dtype=torch.float32, device=X.device)
    if C.numel() == 0:
        return C
    rows = _panel(n, _panel_rows, _grid_items(items))
    panel = _panel_buffer(n, rows, items, X.device)
    name, more = _build.entry("pald_cohesion_fused", items)
    _launch(name, spec.functor, X, C, X.data_ptr(), norms.data_ptr(),
            panel.data_ptr(), W.data_ptr(), C.data_ptr(), n, d, nv, rows,
            *more, mid, wid, p0, p1, add_form(wid, W))
    cohesion_fused_cuda.launches += 1
    cohesion_fused_cuda.grid_launches += fused_grids(n, metric, rows, items)
    return C


def dist_fused_cuda(X, *, metric: str = "euclidean",
                    n_valid=None) -> torch.Tensor:
    """The fused kernels' masked distances D (n, n) of a CUDA X, written
    out by the passes' panel writer: the probe that holds them bitwise to
    ``cdist_reference``."""
    mid = metric_id(metric)
    if X.ndim != 2:
        raise ValueError("dist_fused_cuda takes one item X (n, d), got "
                         f"shape {tuple(X.shape)}")
    _, n, d, nv, _, norms = _cuda_operands("dist_fused_cuda", X, n_valid)
    D = torch.empty((n, n), dtype=torch.float32, device=X.device)
    if n == 0:
        return D
    return _launch("pald_dist_fused_f32", None, X, D, X.data_ptr(),
                   norms.data_ptr(), D.data_ptr(), n, d, nv, mid)


focus_fused_cuda.launches = 0
cohesion_fused_cuda.launches = 0
focus_fused_cuda.grid_launches = 0
cohesion_fused_cuda.grid_launches = 0
