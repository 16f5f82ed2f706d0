"""Streaming k-nearest-neighbor selection from feature vectors: the CUDA
kernel's wrapper and its plain torch version.

For every row x of X (n, d): its k nearest OTHER rows, as (n, k) float32
distances and (n, k) int32 indices, each row ascending by (distance,
index), the lower index first on ties.  The kernel (``csrc/pald_topk.cuh``)
replaces the TPU kernel ``repro/kernels/pald_topk.py::topk_pallas``: it
computes each block's distance tiles from the feature rows
(``csrc/pald_dist.cuh``, bitwise ``cdist_reference``'s) and folds the pairs
that beat their row's current k-th best into per-row best-lists on the
composite (value, index) key, so D never exists and the result does not
depend on the order in which candidates are visited.  Bound by operations
(n^2 distances and compares); the source note in the ``.cuh`` file has the
details.

:func:`topk_select_cuda` dispatches on the tensor's device: a CUDA X
launches the kernel (or raises), a CPU X takes :func:`topk_select_torch`:
(block, n) slabs of ``cdist_reference``, self excluded, a stable sort, the
first k (or, with ``tile=``, the reference's tile-min prefilter, bitwise
the same).  Self is excluded as the kernel excludes it: it sorts after every
real candidate, even one at +inf distance.  On the card the kernel also
takes a (b, n, d) chunk of items (the engine's ``batch=`` chunks) in one
launch, the item on ``blockIdx.y``: a (b, n, k) graph whose indices are
each item's own, bitwise its items one at a time.  The plain version takes
one item.

:func:`topk_block_cuda` is the kernel's block entry: rows of one matrix
against the candidate rows of another, each with the global index of its
first row, self excluded by global index, the (m, k) lists padded with
(+inf, ``INT32_MAX``) where fewer than k candidates remain.  A shard of a
distributed run (``core/distributed_knn.py``) scores its rows against each
candidate block it holds and merges the partial lists exactly on the
(value, index) key (:func:`merge_pairs`), so its graph is bitwise the
full call's.  Its plain version is :func:`topk_block_torch`.

Every k with 1 <= k <= n - 1 runs on the card (the block entry: any
k >= 1).  Up to :data:`LARGE_K` the lists live in shared memory; past it
the kernel's large-k variant selects by threshold: histogram sweeps over
the candidates pin each row's k-th value, a last sweep writes the
candidates below it and the lowest-index ties at it, and a bitonic sort
orders them (``csrc/pald_topk.cuh``).
"""
from __future__ import annotations

import torch

from repro_torch.core.features import dist_tile, masked_dist_tile
from repro_torch.core.knn import NeighborGraph, check_k, empty_graph

from . import _build
from .pald_focus import check_operands, item_grids
from .pald_fused import metric_id, norm_grids

__all__ = ["topk_select_cuda", "topk_select_torch", "topk_block_cuda",
           "topk_block_torch", "merge_pairs", "LARGE_K", "SENTINEL",
           "smem_per_cta"]

# past it the large-k variant, selection by threshold
# (csrc/pald_topk.cuh: kLargeK)
LARGE_K = 1024
SENTINEL = 2 ** 31 - 1  # the index of an empty list entry (+inf, SENTINEL)
_CAND, _STAGES, _MAX_FEAT = 128, 2, 64  # csrc/pald_topk.cuh
# the large-k variant's histogram bins a row (kBins) and the entries it
# sorts in shared memory (kSortCap)
BINS = 2048
SORT_CAP = 16 * BINS // 2


def rows_per_block(k: int) -> int:
    """R, the rows of one thread block at ``k`` (8 warps of
    ``warp_rows(k)`` rows; 16 past 256, the large-k variant too)."""
    return 32 if k <= 32 else 64 if k <= 128 else 32 if k <= 256 else 16


def _stage_pitch(f: int) -> int:
    q = (f + 3) // 4
    return 4 * q if q % 2 else 4 * q + 4


def smem_per_cta(k: int, d: int | None = None) -> int:
    """Shared memory of one thread block of the kernel at ``k`` and ``d``,
    in bytes (csrc/pald_topk.cuh ``Layout``: the rows staged once, a ring
    of two slots of 128 candidates' features and norms, the rows'
    thresholds and norms, and R best-lists of max(k, 32) (float, int)
    entries, past k = 32 with each warp's two batches of 128; past
    :data:`LARGE_K` the rows' norms and sorted counts and their
    :data:`BINS`-bin histograms instead: the same bytes at every k);
    ``d=None``: the largest over every d (past 64 features, when the rows
    ride in each slot).  A card test holds it to the kernel's own report,
    the C entry ``pald_topk_smem_bytes``."""
    r = rows_per_block(k)
    kd = _MAX_FEAT if d is None else min(d, _MAX_FEAT)
    parts_once = d is not None and d <= _MAX_FEAT
    pitch = _stage_pitch(kd)
    rows = r * pitch if parts_once else 0
    slot = _CAND * pitch + _CAND + (0 if parts_once else r * pitch)
    if k > LARGE_K:
        return 4 * (rows + _STAGES * slot + 2 * r) + 4 * r * BINS
    batches = 8 * _CAND * 16
    lists = 8 * r * 32 if k <= 32 else 8 * r * k + batches
    return 4 * (rows + _STAGES * slot + 4 * r) + lists


def topk_select_torch(X: torch.Tensor, k: int, *, metric: str = "euclidean",
                      block: int = 1024, tile: int | None = None,
                      rows: tuple[int, int] | None = None) -> NeighborGraph:
    """Plain torch selection (any device), ``block`` rows per slab; with
    ``rows=(start, stop)`` only those rows' neighbors (against all n).

    ``tile`` picks the strategy per slab, as the reference's jnp
    selection does (``repro/kernels/ops.py::_topk_chunk``): None, ``>= n``
    or ``< 1`` sorts each full row (direct); otherwise the tile-min
    prefilter sorts only the columns of each row's k best tiles of
    ``tile`` columns, which is bitwise the direct result
    (:func:`_prefiltered`)."""
    metric_id(metric)
    X = X.to(torch.float32)
    n = X.shape[0]
    check_k(k, n)
    start, stop = (0, n) if rows is None else rows
    if k <= 0:
        return empty_graph(stop - start, X.device)
    direct = tile is None or tile >= n or tile < 1
    dist, idx = [], []
    for s in range(start, stop, block):
        slab = masked_dist_tile(X[s:min(s + block, stop)], X, metric, s, 0, n)
        r = torch.arange(slab.shape[0], device=X.device)
        # nan sorts after +inf: self loses to every real candidate
        slab[r, s + r] = float("nan")
        if direct:
            dv, di = torch.sort(slab, dim=1, stable=True)
        else:
            dv, di = _prefiltered(slab, k, int(tile))
        dist.append(dv[:, :k])
        idx.append(di[:, :k].to(torch.int32))
    return NeighborGraph(torch.cat(idx), torch.cat(dist))


def _prefiltered(slab: torch.Tensor, k: int, tile: int):
    """The first k of each row of ``slab`` (self already nan) in the order
    of the direct strategy's stable sort, from the columns of the row's k
    best tiles: (values, column indices), each (rows, >= k).

    Exact, by the reference's argument (``repro/kernels/ops.py``, the
    note above ``_topk_chunk``), taken in the direct sort's own order:
    value first, nan after +inf, then index.  A tile's key is its least
    element in that order: the least non-nan entry, or nan when all its
    entries are (a tile whose one real column is self, as every tile is
    at ``tile=1``).  A stable sort of the keys keeps the lower tile id on
    ties.  If an element e were left out, k kept tiles would rank before
    its tile, each holding an element that beats e: a strictly smaller
    one, or an equal one at a lower index.  So the row's true first k are
    among the gathered columns, which stay in index order (kept tile ids
    sorted ascending), and their stable sort is the direct one's.  Padded
    columns (the last tile's, past n) are nan with indices past every
    real column, so none is taken before a real one."""
    m, n = slab.shape
    nt = -(-n // tile)
    S = torch.nn.functional.pad(slab, (0, nt * tile - n), value=float("nan"))
    T = S.view(m, nt, tile)
    nan = torch.isnan(T)
    key = torch.where(nan, float("inf"), T).amin(dim=2)
    key[nan.all(dim=2)] = float("nan")
    kt = min(k, nt)
    tids = torch.sort(key, dim=1, stable=True)[1][:, :kt]
    tids = torch.sort(tids, dim=1)[0]
    cols = (tids[:, :, None] * tile
            + torch.arange(tile, device=slab.device)).reshape(m, kt * tile)
    dv, p = torch.sort(torch.gather(S, 1, cols), dim=1, stable=True)
    return dv, torch.gather(cols, 1, p)


def topk_select_cuda(X: torch.Tensor, k: int, *,
                     metric: str = "euclidean") -> NeighborGraph:
    """The k nearest other rows of each row of X through the CUDA kernel
    for a CUDA X, through :func:`topk_select_torch` for a CPU X.  On the
    card a (b, n, d) chunk gives a (b, n, k) graph from one launch.

    A CUDA X must be contiguous float32 (``ops`` prepares it); anything
    else raises, as does k > n - 1.  Past :data:`LARGE_K` the kernel's
    large-k variant runs (``.large_launches`` counts it too).  Each call
    that launches the kernel adds one to ``topk_select_cuda.launches``,
    and the grids it issues (the row-norm pre-pass's, then the
    selection's, one per ``MAX_ITEMS`` items) to ``.grid_launches``.
    """
    if X.device.type == "cpu":
        return topk_select_torch(X, k, metric=metric)
    mid = metric_id(metric)
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"topk_select_cuda: unsupported device {dev}")
    if X.ndim not in (2, 3):
        raise ValueError("topk_select_cuda: X must be (n, d) or a (b, n, "
                         f"d) chunk, got shape {tuple(X.shape)}")
    lead = tuple(X.shape[:-2])
    n, d = X.shape[-2:]
    check_operands("topk_select_cuda", dev,
                   X=(X, lead + (n, d), torch.float32))
    check_k(k, n)
    if k <= 0:
        return empty_graph(n, dev, lead)
    items = lead[0] if lead else 1
    dist = torch.empty(lead + (n, k), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (n, k), dtype=torch.int32, device=dev)
    if items == 0:
        return NeighborGraph(idx, dist)
    norms = torch.empty((items * n,), dtype=torch.float32, device=dev)
    name, more = _build.entry("pald_topk", items)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.load(name)(X.data_ptr(), norms.data_ptr(),
                                   dist.data_ptr(), idx.data_ptr(), n, d, k,
                                   *more, int(k > LARGE_K), mid, stream)
    _build.check(status, name)
    _count(topk_select_cuda, k, norm_grids(metric) + item_grids(items))
    return NeighborGraph(idx, dist)


def _count(wrapper, k: int, grids: int) -> None:
    """One launch (and ``grids`` grids) of ``wrapper``'s kernel, and of
    its large-k variant past :data:`LARGE_K`."""
    wrapper.launches += 1
    wrapper.large_launches += k > LARGE_K
    wrapper.grid_launches += grids


def merge_pairs(v: torch.Tensor, i: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first k of (value, index) pairs along the last axis, ascending
    by value and then index: a stable sort by index, then a stable sort by
    value (the reference's two-key ``lax.sort`` in
    ``repro/core/distributed_knn.py::_merge_pairs``).  Real candidates
    carry distinct indices, so the order is total and merging partial
    lists in any grouping gives the same first k."""
    o = torch.sort(i, dim=-1, stable=True)[1]
    v, i = torch.gather(v, -1, o), torch.gather(i, -1, o)
    o = torch.sort(v, dim=-1, stable=True)[1][..., :k]
    return torch.gather(v, -1, o), torch.gather(i, -1, o)


def _sentinels(m: int, k: int, device) -> NeighborGraph:
    return NeighborGraph(
        torch.full((m, k), SENTINEL, dtype=torch.int32, device=device),
        torch.full((m, k), float("inf"), dtype=torch.float32, device=device))


def topk_block_torch(Xr: torch.Tensor, Xc: torch.Tensor, k: int, *,
                     metric: str = "euclidean", row_off: int = 0,
                     col_off: int = 0, block: int = 1024) -> NeighborGraph:
    """Plain version of the block entry (any device), ``block`` rows per
    slab: each row of ``Xr`` (global index ``row_off + row``) against the
    rows of ``Xc`` (global index ``col_off + col``), self excluded by
    global index; (m, k) (distance, global index) lists ascending by
    (distance, index), padded with (+inf, :data:`SENTINEL`)."""
    metric_id(metric)
    Xr, Xc = Xr.to(torch.float32), Xc.to(torch.float32)
    m, w = Xr.shape[0], Xc.shape[0]
    if m == 0 or w == 0 or k <= 0:
        return _sentinels(m, max(k, 0), Xr.device)
    cols = col_off + torch.arange(w, device=Xr.device, dtype=torch.int64)
    dist, idx = [], []
    for s in range(0, m, block):
        slab = dist_tile(Xr[s:s + block], Xc, metric)
        rows = row_off + s + torch.arange(slab.shape[0], device=Xr.device)
        ids = cols.expand(slab.shape[0], w).to(torch.int32)
        self_ = rows[:, None] == cols[None, :]
        slab = torch.where(self_, float("inf"), slab)
        ids = torch.where(self_, SENTINEL, ids)
        dv, di = merge_pairs(slab, ids, k)
        dist.append(dv)
        idx.append(di)
    graph = NeighborGraph(torch.cat(idx), torch.cat(dist))
    if w < k:  # fewer candidates than k: the rest are empty entries
        pad = _sentinels(m, k - w, Xr.device)
        graph = NeighborGraph(torch.cat([graph.indices, pad.indices], 1),
                              torch.cat([graph.distances, pad.distances], 1))
    return graph


def topk_block_cuda(Xr: torch.Tensor, Xc: torch.Tensor, k: int, *,
                    metric: str = "euclidean", row_off: int = 0,
                    col_off: int = 0) -> NeighborGraph:
    """The block entry of the selection kernel for CUDA tensors, through
    :func:`topk_block_torch` for CPU ones: each row of ``Xr`` (m, d),
    global index ``row_off + row``, against the rows of ``Xc`` (w, d),
    global index ``col_off + col``; (m, k) lists as the plain version's.

    CUDA operands must be contiguous float32 on one device, k >= 1 (past
    :data:`LARGE_K` the large-k variant), every global index below
    :data:`SENTINEL`; anything else raises.  With no candidate (w = 0) the
    lists are all empty entries and nothing is launched.  Each launch adds
    one to ``topk_block_cuda.launches`` (and ``.large_launches`` past
    :data:`LARGE_K`) and its grids (the row norms of Xr and of Xc, then
    the selection) to ``.grid_launches``.
    """
    if Xr.device.type == "cpu":
        return topk_block_torch(Xr, Xc, k, metric=metric, row_off=row_off,
                                col_off=col_off)
    mid = metric_id(metric)
    dev = Xr.device
    if dev.type != "cuda":
        raise ValueError(f"topk_block_cuda: unsupported device {dev}")
    (m, d), w = Xr.shape, Xc.shape[0]
    check_operands("topk_block_cuda", dev, Xr=(Xr, (m, d), torch.float32),
                   Xc=(Xc, (w, d), torch.float32))
    if k < 1:
        raise ValueError(f"topk_block_cuda: k={k} < 1")
    if (row_off < 0 or col_off < 0 or row_off + m > SENTINEL
            or col_off + w > SENTINEL):
        raise ValueError(f"topk_block_cuda: global indices [{row_off}, "
                         f"{row_off + m}) / [{col_off}, {col_off + w}) "
                         "outside 0..2^31-2")
    if m == 0 or w == 0:
        return _sentinels(m, k, dev)
    norms_r = torch.empty((m,), dtype=torch.float32, device=dev)
    norms_c = torch.empty((w,), dtype=torch.float32, device=dev)
    dist = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    fn = _build.load("pald_topk_block_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(Xr.data_ptr(), Xc.data_ptr(), norms_r.data_ptr(),
                    norms_c.data_ptr(), dist.data_ptr(), idx.data_ptr(), m,
                    w, row_off, col_off, d, k, int(k > LARGE_K), mid, stream)
    _build.check(status, "pald_topk_block_f32")
    _count(topk_block_cuda, k, 2 * norm_grids(metric) + 1)
    return NeighborGraph(idx, dist)


for _f in (topk_select_cuda, topk_block_cuda):
    _f.launches = _f.large_launches = _f.grid_launches = 0
