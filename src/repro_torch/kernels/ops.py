"""Entry points of the PaLD kernel pipeline (counterpart of
``repro.kernels.ops``).

The *general* (rectangular) forms are the primitives the square pipeline
calls, and that distributed bodies will call per device:

    focus_general(DXZ, DYZ, DXY)        -> U (mx, my)
    cohesion_general(DXZ, DYZ, DXY, W)  -> C (mx, mz)

``impl`` picks the implementation: ``"cuda"`` the hand-written kernels
(``pald_focus.py`` / ``pald_cohesion.py``; on CPU tensors their wrappers
take the plain version), ``"torch"`` the plain torch versions on any
device, ``None`` the device's default (``"cuda"`` for CUDA tensors,
``"torch"`` otherwise).  The kernels take any shape and mask ragged edges
themselves, so nothing here is padded; but the focus entry points give
the U of the reference's Pallas route, which pads a ragged extent with
+inf (``_padded_extent``: only where ``block`` / ``block_z`` have no
reasonable divisor of it): under ``split`` each padded z ties an +inf
pair's +inf threshold and adds 0.5 to its U, and ``_add_pad_excess``
adds exactly that, on both impls.  Padded x and y change no entry that
is kept, and padded z no C (their weights are zero), so the cohesion
entry points need nothing.  ``block`` / ``block_z`` also set the plain
versions' chunks.

``schedule="tri"`` (``focus``, ``cohesion_from_weights``, ``pald``, and
``pald_tri`` itself) runs the upper-triangular block schedule on a square,
symmetric D: pass 1 over the nb(nb+1)/2 block pairs X <= Y, each tile
mirrored (``pald_focus_tri.py``); pass 2 reads only the upper pair tiles,
both roles of every off-diagonal pair (``pald_cohesion_tri.py``).  Its U
counts the padded z of the reference's Pallas route, which pads D to a
multiple of max(block, block_z).

``pald_fused(X)`` is the fused features pipeline: both passes straight
from (n, d) feature vectors (``pald_fused.py``), D never whole past the
kernels' panel budget.

The square pipelines (``focus``, ``cohesion_from_weights``, ``pald``,
``pald_tri``) also take a (b, n, n) chunk of items on the card: the CUDA
kernels run it in one grid per pass (the item on ``blockIdx.z``), bitwise
the items one at a time.  So do ``pald_fused`` (a (b, n, d) chunk), and
the k-NN pipeline (``topk_select``, ``knn_values``' kernel route,
``pald_knn``, ``select_cohere``: a (b, n, d) or (b, n, n) chunk, a (b, n,
k) graph, one launch of each kernel).  The plain versions take one item;
the executors split a chunk for them (``engine.chunk_or_items``).

The sparse k-NN pipeline (``core/knn.py`` has the semantics):

    topk_select(X, k)                   -> NeighborGraph (n, k), streamed
                                           from features (pald_topk.py)
    knn_values(x, graph, kind=...)      -> (n, k+1) values (pald_knn.py;
                                           the kernel computes or reads
                                           each row's neighbor tile)
    pald_knn(x, k=..., kind=...)        -> (graph, values): selection, then
                                           values
    select_cohere(X, k=...)             -> (graph, values): the two kernels
                                           back to back on device tensors

``block`` / ``block_z`` (and the selection's ``block`` / ``tile``) take
``"auto"``: the tuning cache (``repro_torch.tuning.autotune``) resolves
them under the entry point's pass, keyed by the device's name, the impl
and n, as the reference's entry points resolve theirs.  The k-NN entry
points default to ``"auto"``, as the reference's do; on a cold cache that
is the size-aware default.

``topk_select(..., impl="chunked")`` is the terminal selection rung of
guarded execution (``core/resilience``): slabs of rows, each slab's
distance rows, self at +inf, a stable sort, synced before the next slab.

Every entry point takes ``ties`` (a mode string, a registered functional
name, or a ``WeightFunctional``), and carries the fault point of its
reference counterpart (``core/resilience.fault_point``) with the resolved
``impl``.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as _engine
from repro_torch.core import knn as _knn
from repro_torch.core.features import masked_dist_tile
from repro_torch.core.resilience import fault_point
from repro_torch.core.weights import DEFAULT_TIES, resolve_weight
from repro_torch.tuning import autotune as _tuner

from .pald_cohesion import cohesion_general_cuda, cohesion_general_torch
from .pald_cohesion_tri import cohesion_tri_cuda, cohesion_tri_torch
from .pald_focus import focus_general_cuda, focus_general_torch
from .pald_focus_tri import focus_tri_cuda, focus_tri_torch
from .pald_fused import (cohesion_fused_cuda, cohesion_fused_torch,
                         focus_fused_cuda, focus_fused_torch)
from .pald_knn import (check_indices, knn_values_from_distances_cuda,
                       knn_values_from_features_cuda, knn_values_torch)
from .pald_topk import topk_select_cuda, topk_select_torch
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
    "SELECTS",
]

IMPLS = ("cuda", "torch")
# the k-NN selection's impls: the kernel, the plain version, and the
# guard's terminal rung
SELECTS = IMPLS + ("chunked",)


def default_impl(device) -> str:
    """``"cuda"`` on a CUDA device, ``"torch"`` elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    return impl


def _resolve_blocks(n: int, pass_: str, block, block_z, impl: str, ties,
                    device) -> tuple[int, int]:
    """"auto" tiles from the tuning cache under ``pass_`` (the reference's
    ``ops._resolve_blocks``), keyed by ``device``'s name and ``impl``; a
    non-default functional has its own cell."""
    if block == "auto" or block_z == "auto":
        rb, rbz = _tuner.resolve_blocks(n, pass_, impl=impl, ties=ties,
                                        device=device)
        block = rb if block == "auto" else block
        block_z = rbz if block_z == "auto" else block_z
    return int(block), int(block_z)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _check_schedule(schedule: str, D) -> bool:
    """True for the tri schedule, which takes a square D (or a (b, n, n)
    chunk) only."""
    if schedule not in _engine.SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} (expected one of "
                         f"{_engine.SCHEDULES})")
    if schedule == "tri" and (D.ndim not in (2, 3)
                              or D.shape[-2] != D.shape[-1]):
        raise ValueError("schedule='tri' takes a square (n, n) D, got shape "
                         f"{tuple(D.shape)}")
    return schedule == "tri"


# --------------------------------------------------------------------------
# what the reference's Pallas route pads (repro/kernels/ops.py: _pick_block,
# _block_and_pad, _pad_square_tri), for the U it gives
# --------------------------------------------------------------------------
_INF = float("inf")


def _pick_block(m: int, want: int) -> int:
    """Largest divisor of m that is <= want."""
    b = min(want, m)
    while m % b:
        b -= 1
    return b


def _padded_extent(m: int, want: int) -> int:
    """m as ``_block_and_pad`` pads it: unpadded when it has a reasonable
    divisor (>= max(want // 2, 8)) for a tile, else up to the next
    multiple of ``want``."""
    if m <= 0:
        return m
    want = max(min(want, m), 1)
    b = _pick_block(m, want)
    if b == m or b >= max(want // 2, 8):
        return m
    return -(-m // want) * want


def _tri_padded(n: int, block, block_z) -> int:
    """n padded to a multiple of max(block, block_z), each cut to n."""
    q = max(min(int(block), n), min(int(block_z), n), 1)
    return -(-n // q) * q


def _add_pad_excess(U: torch.Tensor, DXY: torch.Tensor, pad_z: int,
                    ties) -> torch.Tensor:
    """U as it is with ``pad_z`` padded z columns, +inf from both points.
    On a finite pair such a z is outside the focus; on an +inf pair it
    ties the threshold and adds ``ties.focus(inf, inf, inf)`` (0.5 under
    ``split``, 0 for the other built-in families).  In place: U is a sum
    of halves there, so the order of the additions does not matter."""
    inf = torch.tensor(_INF)
    w = float(ties.focus(inf, inf, inf)) if pad_z else 0.0
    if w:
        U[DXY == _INF] += pad_z * w
    return U


def focus_general(DXZ, DYZ, DXY, *, block=128, block_z=512,
                  impl: str | None = None, ties=DEFAULT_TIES) -> torch.Tensor:
    ties = resolve_weight(ties)
    impl = _check_impl(impl or default_impl(DXZ.device))
    fault_point("ops.focus_general", impl=impl, ties=ties.name)
    block, block_z = _resolve_blocks(max(DXZ.shape[-2:]), "focus", block,
                                     block_z, impl, ties, DXZ.device)
    DXZ, DYZ, DXY = _f32(DXZ), _f32(DYZ), _f32(DXY)
    if impl == "torch":
        U = focus_general_torch(DXZ, DYZ, DXY, chunk=int(block_z), ties=ties)
    else:
        U = focus_general_cuda(DXZ, DYZ, DXY, ties=ties)
    mz = DXZ.shape[-1]
    return _add_pad_excess(U, DXY, _padded_extent(mz, int(block_z)) - mz,
                           ties)


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
    fault_point("ops.cohesion_general", impl=impl, ties=ties.name)
    block, block_z = _resolve_blocks(max(DXZ.shape[-2:]), "cohesion", block,
                                     block_z, impl, ties, DXZ.device)
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
    """Square local-focus sizes U (n, n).  ``schedule="tri"`` computes the
    upper block pairs and mirrors them (D must be symmetric); ``block`` /
    ``block_z`` set its plain version's tiles."""
    if _check_schedule(schedule, D):
        ties = resolve_weight(ties)
        impl = _check_impl(impl or default_impl(D.device))
        block, block_z = _resolve_blocks(D.shape[-1], "focus_tri", block,
                                         block_z, impl, ties, D.device)
        D = _f32(D)
        if impl == "torch":
            U = focus_tri_torch(D, block=int(block), block_z=int(block_z),
                                ties=ties)
        else:
            U = focus_tri_cuda(D, ties=ties)
        n = D.shape[-1]
        return _add_pad_excess(U, D, _tri_padded(n, block, block_z) - n, ties)
    D = _f32(D)  # once: the kernel's square entry takes one matrix
    return focus_general(D, D, D, block=block, block_z=block_z, impl=impl,
                         ties=ties)


def cohesion_from_weights(D, W, *, block=128, block_z=512,
                          impl: str | None = None, schedule: str = "dense",
                          ties=DEFAULT_TIES) -> torch.Tensor:
    """Pass 2 from precomputed reciprocal weights W = 1/U.  The square
    case derives the index tiebreak per tile (``xw_offsets=(0, 0)``).
    ``schedule="tri"`` visits the upper block pairs, both roles per
    off-diagonal pair, and reads only the upper tiles of D and W (both
    must be symmetric)."""
    ties = resolve_weight(ties)
    if _check_schedule(schedule, D):
        impl = _check_impl(impl or default_impl(D.device))
        block, block_z = _resolve_blocks(D.shape[-1], "cohesion_tri", block,
                                         block_z, impl, ties, D.device)
        D, W = _f32(D), _f32(W)
        if impl == "torch":
            return cohesion_tri_torch(D, W, block=int(block),
                                      block_z=int(block_z), ties=ties)
        return cohesion_tri_cuda(D, W, ties=ties)
    offs = (0, 0) if ties.needs_index_tiebreak else None
    return cohesion_general(D, D, D, W, block=block, block_z=block_z,
                            impl=impl, ties=ties, xw_offsets=offs)


def pald(D, *, block=128, block_z=512, normalize: bool = False, n_valid=None,
         impl: str | None = None, schedule: str = "dense",
         ties=DEFAULT_TIES) -> torch.Tensor:
    """Full PaLD through the two passes: D -> U -> W = 1/U -> C.

    impl: 'cuda' (the hand-written kernels), 'torch' (plain versions), or
    None for the device's default.  ``n_valid`` zeroes the weights of
    padded points (index >= n_valid).  schedule: 'dense' runs the full
    grids; 'tri' is ``pald_tri``.  ties: weight functional shared by both
    passes.  Peak memory: U, W and W's (n, n) bool mask while W is built
    (2.25 n^2 float32 buffers), then W and C.
    """
    if _check_schedule(schedule, D):
        return pald_tri(D, block=block, block_z=block_z, normalize=normalize,
                        n_valid=n_valid, impl=impl, ties=ties)
    U = focus(D, block=block, block_z=block_z, impl=impl, ties=ties)
    W = weights_ref(U, n_valid)
    del U
    C = cohesion_from_weights(D, W, block=block, block_z=block_z, impl=impl,
                              ties=ties)
    if normalize:
        C = C / (D.shape[-1] - 1)
    return C


def pald_tri(D, *, block=128, block_z=512, normalize: bool = False,
             n_valid=None, impl: str | None = None,
             ties=DEFAULT_TIES) -> torch.Tensor:
    """The tri-schedule pipeline: tri focus -> W = 1/U -> tri cohesion.
    Both passes visit only the nb(nb+1)/2 upper block pairs (the paper's
    Algorithm 2 at block granularity, DESIGN.md section 4.3).  D must be
    square and symmetric; ``block`` / ``block_z`` set the plain versions'
    tiles (the kernels' are fixed), ``n_valid`` zeroes the weights of
    padded points.  Peak memory as ``pald``'s: 2.25 n^2 float32 buffers.
    """
    ties = resolve_weight(ties)
    fault_point("ops.pald_tri", impl=_check_impl(impl or default_impl(
        D.device)), ties=ties.name)
    U = focus(D, block=block, block_z=block_z, impl=impl, schedule="tri",
              ties=ties)
    W = weights_ref(U, n_valid)
    del U
    C = cohesion_from_weights(D, W, block=block, block_z=block_z, impl=impl,
                              schedule="tri", ties=ties)
    if normalize:
        C = C / (D.shape[-1] - 1)
    return C


def pald_fused(X, *, metric: str = "euclidean", block=128, block_z=512,
               normalize: bool = False, impl: str | None = None,
               ties=DEFAULT_TIES) -> torch.Tensor:
    """Fused features -> cohesion pipeline: X (n, d) -> C (n, n); on the
    card (``impl="cuda"``) also a (b, n, d) chunk -> C (b, n, n), one launch
    a pass for the chunk, bitwise its items.

    Both passes compute their distances from the feature rows as they go
    (``impl="cuda"``: one (P, n) panel of rows at a time, at most
    ``pald_fused.PANEL_BUDGET`` bytes, read by every output tile; on CPU
    tensors, and with ``impl="torch"``, the plain versions' (block, n)
    slabs), so the (n, n) distance matrix is never whole past n = 4096:
    U, W = 1/U and C are the only (n, n) buffers.  The kernels mask
    ragged edges themselves, so no row is padded.  ``block`` /
    ``block_z`` set the plain versions' row block and reduced-axis chunk
    (default 128 / 512; "auto": the ``pald_fused:d<d>`` cache pass, a
    ``block_z`` of None riding along with ``block``); the kernels' tiles
    are fixed.  Peak memory: U, W and an (n, n) bool mask while W is
    built, then W, C and a panel of
    min(``PANEL_BUDGET``, about n^2 * 4) bytes: 2.25 n^2 float32 buffers
    from n = 8192 up, about 3 n^2 up to n = 4096.
    """
    ties = resolve_weight(ties)
    impl = _check_impl(impl or default_impl(X.device))
    fault_point("ops.pald_fused", impl=impl, ties=ties.name)
    X = _f32(X)  # the one boundary cast
    n, d = X.shape[-2:]
    if impl == "torch":
        block, block_z, _ = _tuner.resolve_fused_tiles(
            n, d, block, block_z, impl=impl, ties=ties, device=X.device)
        kw = dict(metric=metric, block=block, block_z=block_z, ties=ties)
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


# --------------------------------------------------------------------------
# sparse k-NN pipeline: selection (pald_topk.py), then the values
# (pald_knn.py), whose kernel computes (from features) or reads (from D)
# each row's neighbor-to-neighbor tile itself; the plain versions stage the
# gathered (n, k, k) tiles in memory, as the reference stages them in HBM
# --------------------------------------------------------------------------
_GATHER_ROWS = 8192  # rows per gather chunk (fewer past 2^24 / k^2 entries)


def _gather_tiles(x, idx, kind: str, metric: str) -> torch.Tensor:
    """The (n, k, k) neighbor-to-neighbor distances of the graph, gathered
    from D or recomputed from features, chunk by chunk (the plain path)."""
    n, k = idx.shape
    g = torch.empty((n, k, k), dtype=torch.float32, device=x.device)
    rows = max(1, min(_GATHER_ROWS, (1 << 24) // max(k * k, 1)))
    for s in range(0, n, rows):
        ic = idx[s:s + rows]
        g[s:s + rows] = (
            _knn.gather_tile_from_distances(x, ic) if kind == "distance"
            else _knn.gather_tile_from_features(x, ic, metric))
    return g


def _check_kind(kind: str) -> None:
    if kind not in ("distance", "features"):
        raise ValueError(f"unknown kind {kind!r} "
                         "(expected 'distance' or 'features')")


def knn_values(x, graph: "_knn.NeighborGraph", *, kind: str = "distance",
               metric: str = "euclidean", block: int | str = "auto",
               impl: str | None = None, ties=DEFAULT_TIES) -> torch.Tensor:
    """Sparse (n, k+1) cohesion values of a prebuilt neighbor graph.

    Args:
        x: what the graph was built from: the (n, n) distance matrix
            (``kind="distance"``) or the (n, d) features
            (``kind="features"``; the neighbor-to-neighbor distances are
            recomputed from them, D never materialized).
        graph: ``core.knn.NeighborGraph`` over the same ``x``.
        block: rows per chunk of the plain version; "auto" resolves
            under the ``pald_knn:k<k>`` cache pass.
        impl: "cuda" (the kernel, which computes or reads each row's
            tile itself: no (n, k, k) array), "torch" (the plain version
            over the gathered (n, k, k) tiles), or None for the device's
            default.

    Returns:
        (n, k+1) float32 values, column 0 the self support, un-normalized.

    Raises:
        ValueError: a neighbor index outside [0, n) (the kernel would
            read outside ``x``).
    """
    check_indices("knn_values", graph.indices, x.shape[-2])
    return _knn_values(x, graph, kind=kind, metric=metric, block=block,
                       impl=impl, ties=ties)


def _knn_values(x, graph, *, kind, metric, block, impl, ties):
    """:func:`knn_values` without the index check, for a graph built here."""
    ties = resolve_weight(ties)
    _check_kind(kind)
    impl = _check_impl(impl or default_impl(x.device))
    fault_point("ops.knn_values", impl=impl, ties=ties.name)
    x = _f32(x)
    n, k = graph.indices.shape[-2:]
    if k == 0:  # n == 1, or an explicit empty graph: no pairs, no support
        return torch.zeros(graph.indices.shape[:-1] + (1,),
                           dtype=torch.float32, device=x.device)
    dn = _f32(graph.distances)
    idx = graph.indices.to(torch.int32).contiguous()
    if impl == "torch":
        if block == "auto":
            block, _ = _tuner.resolve_blocks(n, "pald_knn", impl=impl,
                                             ties=ties, k=k, device=x.device)
        block = max(min(int(block), n), 1)
        g = _gather_tiles(x, idx, kind, metric)
        return knn_values_torch(dn, g, idx, ties=ties, block=block)
    if kind == "distance":
        return knn_values_from_distances_cuda(x, dn, idx, ties=ties)
    return knn_values_from_features_cuda(x, dn, idx, metric=metric,
                                         ties=ties)


def pald_knn(x, *, k: int, kind: str = "distance", metric: str = "euclidean",
             block: int | str = "auto", impl: str | None = None,
             ties=DEFAULT_TIES, normalize: bool = False,
             row_chunk: int = 1024,
             graph: "_knn.NeighborGraph | None" = None):
    """Sparse k-NN PaLD: neighbor selection, then the (n, k+1) values.

    ``k`` is clamped to n-1.  Unlike the ``method="knn"`` executors, this
    entry point runs the sparse pipeline even at k = n-1.  ``graph`` skips
    the selection; ``row_chunk`` is the selection's rows per slab and
    ``block`` the values' rows per chunk ("auto": the ``pald_knn:k<k>``
    cache pass), both the plain versions'.  Selection: a stable sort per
    row slab of D (``kind="distance"``) or ``topk_select``
    (``kind="features"``).  On the card a chunk x (b, n, n) or (b, n, d)
    runs the selection and the values once each for all b items, a (b, n,
    k) graph and (b, n, k+1) values.

    Returns:
        (graph, values); ``core.knn.scatter_dense`` expands the values to
        the dense (n, n) C, ``core.knn.communities`` reads them directly.
    """
    ties = resolve_weight(ties)
    _check_kind(kind)
    x = _f32(x)
    n = x.shape[-2]
    k = min(int(k), max(n - 1, 0))
    # a caller's graph has its indices checked; one built here does not
    values = knn_values if graph is not None else _knn_values
    if graph is None:
        if kind == "distance":
            graph = _knn.knn_from_distances(x, k, row_chunk=row_chunk)
        else:
            graph = topk_select(x, k, metric=metric, impl=impl,
                                block=row_chunk)
    vals = values(x, graph, kind=kind, metric=metric, block=block,
                  impl=impl, ties=ties)
    if normalize:
        vals = vals / max(n - 1, 1)
    return graph, vals


def _resolve_topk_tiles(n: int, d: int, k: int, block, tile, impl: str,
                        device) -> tuple[int, int]:
    """"auto" selection knobs into (rows per slab, tile) from the
    ``pald_topk:k<k>:d<d>`` cache pass (the reference's)."""
    if block == "auto" or tile == "auto":
        rb, rt = _tuner.resolve_blocks(n, "pald_topk", impl=impl, d=d, k=k,
                                       device=device)
        block = rb if block == "auto" else block
        tile = rt if tile == "auto" else tile
    return max(min(int(block), max(n, 1)), 1), int(tile)


def topk_select(X, k: int, *, metric: str = "euclidean",
                impl: str | None = None, block: int | str = "auto",
                tile: int | str = "auto") -> "_knn.NeighborGraph":
    """Streaming neighbor selection: (n, d) features -> NeighborGraph,
    rows ascending by (distance, index), the lower index first on ties,
    self excluded; D never materialized.

    impl: "cuda" (the kernel at any k, past ``pald_topk.LARGE_K`` its
    large-k variant), "torch" (the plain version, ``block`` rows per
    slab, and with ``tile`` < n the tile-min prefilter, bitwise the
    direct sort), "chunked" (the guard's terminal rung: ``block`` rows
    per slab, each synced before the next, self excluded by the reference
    rung's rule), or None for the device's default.  ``block`` / ``tile`` "auto" resolve under the
    ``pald_topk:k<k>:d<d>`` cache pass (cold: 1024 rows, tile n, direct);
    the kernel reads neither.  On the card ``impl="cuda"`` also takes a
    (b, n, d) chunk: a (b, n, k) graph from one launch.

    Raises:
        ValueError: unknown metric or impl, or ``k > n-1``.
    """
    impl = impl or default_impl(X.device)
    if impl not in SELECTS:
        raise ValueError(f"unknown impl {impl!r} (expected one of "
                         f"{SELECTS})")
    fault_point("ops.topk_select", impl=impl, metric=metric)
    X = _f32(X)
    n, d = X.shape[-2:]
    _knn.check_k(k, n)
    if impl == "cuda":
        return topk_select_cuda(X, k, metric=metric)
    block, tile = _resolve_topk_tiles(n, d, k, block, tile, impl, X.device)
    if impl == "chunked":
        return _topk_select_chunked(X, k, metric=metric, row_chunk=block)
    return topk_select_torch(X, k, metric=metric, block=block, tile=tile)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _chunked_rows(n: int, k: int, row_chunk: int, rows_of, device):
    """The rung's slabs: ``rows_of(s, e)`` gives rows [s, e) of the
    distances (a fresh tensor), self is set to +inf, the stable sort
    (``core.knn._top_k_rows``) takes the first k, and each slab is synced
    before the next starts."""
    if k <= 0:
        return _knn.empty_graph(n, device)
    dist, idx = [], []
    for s in range(0, n, row_chunk):
        rows = rows_of(s, min(s + row_chunk, n))
        r = torch.arange(rows.shape[0], device=device)
        rows[r, s + r] = _INF
        dv, di = _knn._top_k_rows(rows, k)
        del rows
        _sync(dv)
        dist.append(dv)
        idx.append(di)
    return _knn.NeighborGraph(torch.cat(idx), torch.cat(dist))


def _topk_select_chunked(X, k: int, *, metric: str, row_chunk: int = 1024):
    """The terminal selection rung from features (the reference's
    ``ops._topk_select_chunked``): each slab's full distance rows from the
    pieces of ``cdist_reference`` (``masked_dist_tile``), so on the card
    they are bitwise the selection kernel's.  Self at +inf, as in the
    reference rung: among +inf entries it takes its index's place (the
    kernel and the plain selection sort it after every candidate)."""
    n = X.shape[0]
    return _chunked_rows(
        n, k, row_chunk,
        lambda s, e: masked_dist_tile(X[s:e], X, metric, s, 0, n), X.device)


def _knn_from_distances_chunked(D, k: int, *, row_chunk: int = 1024):
    """The distance kind's terminal rung (the reference's
    ``ops._knn_from_distances_chunked``): bitwise
    ``core.knn.knn_from_distances``, slab at a time with a sync."""
    D = _f32(D)
    n = D.shape[0]
    _knn.check_k(k, n)
    return _chunked_rows(n, k, row_chunk, lambda s, e: D[s:e].clone(),
                         D.device)


def select_cohere(X, *, k: int, metric: str = "euclidean",
                  block: int | str = "auto", tile: int | str = "auto",
                  cohere_block: int | str = "auto", impl: str | None = None,
                  select: str | None = None, ties=DEFAULT_TIES,
                  normalize: bool = False):
    """Streaming selection, then sparse cohesion, from features: the two
    kernels back to back, the selection's device tensors handed straight
    to the values kernel, which computes each row's neighbor tile from X.
    Bitwise ``topk_select`` then ``pald_knn(..., graph=...)``.  Peak
    memory on the card beyond X: the graph, the values and the
    selection's (n,) norms.

    Args:
        X: (n, d) features; on the card with both impls "cuda" also a
            (b, n, d) chunk (one launch of each kernel, a (b, n, k) graph
            and (b, n, k+1) values).
        k: neighborhood size, clamped to n-1.
        block / tile: the selection's rows per slab and prefilter tile
            (plain version; see ``topk_select``).
        cohere_block: the values' rows per chunk (plain version; "auto"
            as ``knn_values``'s ``block``).
        impl: the values' impl; ``select``: the selection's (None follows
            ``impl``).
        normalize: divide the values by n-1.

    Returns:
        (graph, values), values (n, k+1) with column 0 the self support.
    """
    ties = resolve_weight(ties)
    impl = _check_impl(impl or default_impl(X.device))
    sel = select or impl
    fault_point("ops.select_cohere", impl=impl, select=sel, ties=ties.name)
    X = _f32(X)
    lead, n = tuple(X.shape[:-2]), X.shape[-2]
    k = min(int(k), max(n - 1, 0))
    if k <= 0:
        return (_knn.empty_graph(n, X.device, lead),
                torch.zeros(lead + (n, 1), dtype=torch.float32,
                            device=X.device))
    graph = topk_select(X, k, metric=metric, impl=sel, block=block,
                        tile=tile)
    vals = _knn_values(X, graph, kind="features", metric=metric,
                       block=cohere_block, impl=impl, ties=ties)
    if normalize:
        vals.div_(max(n - 1, 1))  # in place: no second (n, k+1) buffer
    return graph, vals


# --------------------------------------------------------------------------
# engine executors: the kernel-pipeline cells of the dispatch registry
# (repro_torch.core.engine).  Each receives one item, or a (b, ...) chunk
# of them (one launch per kernel for the chunk on the card, item by item
# through the plain versions), plus the resolved plan; tiles, impl and
# weight were fixed once at plan() time.
# --------------------------------------------------------------------------
def _kernel_exec(D, plan, pipeline):
    Dp, n0 = _engine.pad_distance_matrix(D, plan.block)  # f32 boundary cast
    nv = n0 if Dp.shape[-1] != n0 else None
    kz = {} if plan.block_z is None else {"block_z": plan.block_z}
    C = _engine.chunk_or_items(
        lambda d: pipeline(d, block=plan.block, n_valid=nv, impl=plan.impl,
                           ties=plan.weight, **kz), Dp, plan.impl)
    C = C[..., :n0, :n0]
    return C / max(n0 - 1, 1) if plan.normalize else C


@_engine.register_executor("distance", "kernel", "dense", chunks=True)
def _exec_kernel_dense(D, plan):
    return _kernel_exec(D, plan, pald)


@_engine.register_executor("distance", "kernel", "tri", chunks=True)
def _exec_kernel_tri(D, plan):
    return _kernel_exec(D, plan, pald_tri)


@_engine.register_executor("features", "fused", "dense", chunks=True)
def _exec_fused(X, plan):
    return _engine.chunk_or_items(
        lambda x: pald_fused(x, metric=plan.metric, block=plan.block,
                             block_z=plan.block_z, normalize=plan.normalize,
                             impl=plan.impl, ties=plan.weight), X, plan.impl)


# -- sparse k-NN cells -------------------------------------------------------
# At k >= n-1 the restriction is the identity, and gathering the (n, n-1,
# n-1) neighbor cube would be more work than the dense computation it
# reproduces: the executors run the exact dense path there, so
# ``cohesion(D, method="knn", k=n-1)`` is bitwise ``method="dense"``.
# ``pald_knn`` itself never short-circuits.  A chunk runs whole only where
# every stage is a kernel (or, for D's selection, a sort of the chunk's
# rows); the dense path, the mesh, the guard's chunked selection rung and
# the plain versions take it item by item.
def _knn_dense_fallback(D, plan):
    return _engine.get_executor("distance", "dense", "dense")(D, plan)


def _knn_chunk(body, x, plan, whole: bool):
    """``body`` over one item or a chunk: whole on the card's kernels when
    every stage takes a chunk (``whole``), else item by item."""
    return _engine.chunk_or_items(lambda xi: body(xi, plan), x,
                                  plan.impl if whole else "torch")


@_engine.register_executor("distance", "knn", "dense", chunks=True)
def _exec_knn_distance(D, plan):
    D = _f32(D)
    return _knn_chunk(_knn_distance, D, plan,
                      plan.k < D.shape[-1] - 1 and plan.select != "chunked")


def _knn_distance(D, plan):
    n = D.shape[-1]
    if plan.k >= n - 1:
        return _knn_dense_fallback(D, plan)
    graph = None
    if plan.select == "chunked":
        # the terminal selection rung: row-chunked stable sorts of D
        graph = _knn_from_distances_chunked(D, plan.k)
    graph, vals = pald_knn(D, k=plan.k, kind="distance", block=plan.block,
                           impl=plan.impl, ties=plan.weight, graph=graph)
    C = _knn.scatter_dense(graph, vals)
    return C / max(n - 1, 1) if plan.normalize else C


@_engine.register_executor("features", "knn", "dense", chunks=True)
def _exec_knn_features(X, plan):
    """Selection streamed from features straight into the values kernel
    (``select_cohere``); no (n, n) intermediate before the final scatter.
    A mesh plan runs the sharded pipeline (``core/distributed_knn.py``)."""
    X = _f32(X)
    return _knn_chunk(_knn_features, X, plan,
                      plan.k < X.shape[-2] - 1 and plan.mesh is None
                      and (plan.select or plan.impl) == "cuda")


def _knn_features(X, plan):
    n = X.shape[-2]
    if plan.k >= n - 1:
        from repro_torch.core.features import cdist_reference

        return _knn_dense_fallback(cdist_reference(X, metric=plan.metric),
                                   plan)
    if plan.mesh is not None:
        from repro_torch.core import distributed_knn as _dknn

        graph, vals = _dknn.pald_knn_sharded(
            X, plan.mesh, k=plan.k, metric=plan.metric,
            strategy=plan.strategy or "auto", normalize=False,
            weight=plan.weight, block=plan.select_block or "auto",
            tile=plan.select_tile if plan.select_tile is not None
            else "auto", on_error="raise", impl=plan.impl,
            device=plan.device)
        C = _knn.scatter_dense(graph, vals)
        return C / max(n - 1, 1) if plan.normalize else C
    graph, vals = select_cohere(
        X, k=plan.k, metric=plan.metric, block=plan.select_block,
        tile=plan.select_tile, cohere_block=plan.block, impl=plan.impl,
        select=plan.select, ties=plan.weight)
    C = _knn.scatter_dense(graph, vals)
    return C / max(n - 1, 1) if plan.normalize else C
