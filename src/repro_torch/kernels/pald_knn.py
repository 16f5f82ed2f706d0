"""Sparse k-NN PaLD cohesion values: the CUDA kernel's wrappers and their
plain torch versions.

From a neighbor graph's (n, k) distances ``dn`` and indices ``idx`` and the
neighbor-to-neighbor distances g(j, m) = d(nbr_j, nbr_m) of each row, the
(n, k+1) values [self, nbr_0, ..., nbr_{k-1}] of ``core.knn.knn_values_tile``:
focus sizes over {x} + N_k(x) per directed pair, W = 1/U, then the support
of each candidate.  The kernel (``csrc/pald_knn.cu``) replaces the TPU
kernel ``repro/kernels/pald_knn.py::knn_values_pallas`` on the real k (no
lane padding); U and W never leave the block.  It takes g from one of
three sources, one entry point each:

- :func:`knn_values_cuda`: a gathered (n, k, k) cube, the direct
  counterpart of ``knn_values_pallas`` (the reference stages g in HBM);
- :func:`knn_values_from_features_cuda`: X (n, d) and the metric; each
  row's k x k tile is computed in the block from its neighbors' rows,
  bitwise ``core.knn.gather_tile_from_features``'s;
- :func:`knn_values_from_distances_cuda`: D (n, n); D[idx_j, idx_m] read
  straight, as ``core.knn.gather_tile_from_distances`` gathers it.

On the same g the three give bitwise the same values (one kernel body, the
same sums in the same order).  The last two write no (n, k, k) array.  The
source note in the ``.cu`` file has the details.

Every k >= 1 runs on the card.  Up to :data:`LARGE_K` four rows share a
block, each row's dn, W and idx in shared memory; past it the kernel's
large-k variant runs a block on one row, dn and idx read where they lie
and W (with the features source's norms or the D source's sorted
positions) in a scratch of 2 k float32 a block that the wrapper allocates
(:func:`large_scratch`).  The cube source runs every warp of the block
with the same sums in the same order, so the same bits; the features
source (``csrc/pald_knn_reg.cuh``: ``pald_knn_large.cu`` up to
:data:`REG_MAX_D` features, ``pald_knn_wide.cu`` up to 64 and
``pald_knn_piece.cu`` past, :func:`features_entry`) holds rows in
registers at a compile-time width (:func:`feature_width`), and the D
source sweeps each row's tile once in ascending column order
(:func:`sweep_layout`), so their values are bitwise the others' for a
functional whose focus is an exact count and within rounding for a
smooth one.

For a shard of a distributed run (``core/distributed_knn.py``) the features
source takes ``row_off``, the global index of its first row (the index
tiebreak of ``needs_index_tiebreak`` functionals compares global indices),
and :func:`knn_values_from_neighbors_cuda` is the same entry fed an
(n, k, d) block of each row's neighbor feature rows in place of X (a ring
shard never holds X whole); either gives the single-device values
bitwise.

Each wrapper dispatches on the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors take the plain version (:func:`knn_values_torch`,
``knn_values_tile`` over row chunks, each chunk's tiles gathered by the
plain ``gather_tile_from_*``).

On the card the features and D sources also take a chunk of items (the
engine's ``batch=`` chunks): X (b, m, d) or D (b, m, m) with a (b, n, k)
graph, each item's indices its own, in one launch, the item on
``blockIdx.y``; the (b, n, k+1) values are bitwise its items' one at a
time.  The cube source, the neighbor-row block and the plain versions take
one item.
"""
from __future__ import annotations

import torch

from repro_torch.core.knn import (gather_tile_from_distances,
                                  gather_tile_from_features,
                                  gather_tile_from_neighbors, knn_values_tile)
from repro_torch.core.weights import DEFAULT_TIES, kernel_spec, resolve_weight

from . import _build
from .pald_focus import MAX_ITEMS, check_operands, item_grids
from .pald_fused import metric_id

__all__ = ["knn_values_cuda", "knn_values_torch",
           "knn_values_from_features_cuda", "knn_values_from_features_torch",
           "knn_values_from_neighbors_cuda",
           "knn_values_from_neighbors_torch",
           "knn_values_from_distances_cuda",
           "knn_values_from_distances_torch", "check_indices", "tile_layout",
           "smem_per_cta", "large_scratch", "feature_width", "features_entry",
           "sweep_layout", "LARGE_K", "REG_MAX_D"]

TILE_MAX_K = 64  # csrc/pald_knn.cu kTileMaxK: the k x k tile in shared memory
_STAGE_BYTES = 16 << 10  # csrc/pald_knn.cu kStageBytes

_WARPS = 4  # rows per thread block (csrc/pald_knn.cu: one warp per row)
# past it the large-k variant, a block a row, its state out of shared
# memory (csrc/pald_knn.cu kLargeK)
LARGE_K = 1024
_BIG_GRID = 1024  # the large-k variant's row blocks a grid (kBigGrid)
# the large-k features source in register tiles (csrc/pald_knn.cuh): the
# widest d of pald_knn_large.cu's entry, the rows of a staged tile, the
# widest width held in registers, past it the features a piece and the
# staged rows a tile
REG_MAX_D, _REG_TILE, _REG_MAX_WIDTH = 16, 256, 64
_PIECE_WIDTH, _PIECE_ROWS = 32, 32
# the large-k D source's sweep (csrc/pald_knn.cu): columns a thread, the
# most threads a block, the sorted positions in shared memory up to these
# bytes, and its reduction buffer (two halves of 4 rows x 16 warps)
_SWEEP_COLS, _SWEEP_THREADS = 8, 512
_SWEEP_PERM_BYTES, _SWEEP_RED_BYTES = 64 << 10, 2 * 4 * 16 * 4


def feature_width(d: int) -> int:
    """The compile-time width the large-k features source pads ``d``
    features to (``csrc/pald_knn.cuh`` ``reg_width``): 8, 16, 32 or 64,
    held in registers; past 64 d rounded up to whole pieces of 32
    features, which stream through the pair sums in turn."""
    for w in (8, 16, 32, _REG_MAX_WIDTH):
        if d <= w:
            return w
    return -(-d // _PIECE_WIDTH) * _PIECE_WIDTH


def features_entry(k: int, d: int) -> str:
    """The C entry the features source launches at (k, d): the four-rows
    layouts up to :data:`LARGE_K` (``pald_knn.cu``), past it the register
    tiles, built as ``pald_knn_large.cu`` up to :data:`REG_MAX_D` features,
    ``pald_knn_wide.cu`` up to 64 and ``pald_knn_piece.cu`` past (three
    sources, so that they build in parallel)."""
    if k <= LARGE_K:
        return "pald_knn_values_features_f32"
    if d <= REG_MAX_D:
        return "pald_knn_values_features_large_f32"
    return ("pald_knn_values_features_wide_f32" if d <= _REG_MAX_WIDTH
            else "pald_knn_values_features_piece_f32")


def sweep_layout(k: int) -> tuple[int, int, bool]:
    """How the D source's large-k variant holds row x at k
    (``knn_dist_sweep_kernel``): (its block's threads, whole warps of 8
    columns each up to 512; the pieces of threads x 8 sorted columns, one
    (a single sweep, each entry of the row's tile read once) up to k =
    4096, else pass 1 over every piece and then pass 2 a piece at a time;
    the sorted positions in shared memory, up to 64 KB of them, else in
    the scratch beside W).  The rows of a tile (4) ride in registers."""
    warps = -(-k // (32 * _SWEEP_COLS))
    threads = min(32 * warps, _SWEEP_THREADS)
    pieces = -(-k // (threads * _SWEEP_COLS))
    return threads, pieces, 4 * k <= _SWEEP_PERM_BYTES


def tile_layout(k: int, d: int) -> tuple[bool, bool]:
    """How the features source holds row x's tile at (k, d): (the k x k
    tile computed once into shared memory (k <= 64; else each pass
    computes every entry where it reads it), the k neighbor rows staged in
    shared memory (up to 16 KB of them; else read from X through
    L1/L2))."""
    return k <= TILE_MAX_K, d > 0 and k * (d | 1) * 4 <= _STAGE_BYTES


def smem_per_cta(k: int, d: int | None = None) -> int:
    """Shared memory of one thread block of the kernel at ``k``, in bytes:
    each of its four rows' dn, W and idx (the cube and D sources,
    ``d=None``), and for the features source at width ``d`` the norms,
    the tile and the staged rows (csrc/pald_knn.cu ``feat_layout``).  Past
    :data:`LARGE_K` the large-k variant's block: the features source's
    register tiles, up to 64 features a tile of 256 rows, each its
    :func:`feature_width` features, norm, dn, index and W, past 64 a tile
    of 32 rows, each a piece of 32 features and the same four, and each of
    the block's 256 threads its owned row's piece; the D source's sweep
    (``d=None``), its reduction buffer and the sorted positions while
    they fit (:func:`sweep_layout`; the cube source's large-k variant
    holds nothing).  A card test holds it to the kernel's
    own report, the C entry ``pald_knn_smem_bytes``."""
    if k > LARGE_K and d is None:
        return _SWEEP_RED_BYTES + (4 * k if sweep_layout(k)[2] else 0)
    if k > LARGE_K:
        rows, width = ((_REG_TILE, feature_width(d)) if d <= _REG_MAX_WIDTH
                       else (_PIECE_ROWS + _REG_TILE, _PIECE_WIDTH))
        return 4 * rows * (width + 4)
    if d is None:
        return _WARPS * 3 * 4 * k
    tile, staged = tile_layout(k, d)
    per_row = 4 * k + (k * (k | 1) if tile else 0) + (k * (d | 1) if staged
                                                       else 0)
    return _WARPS * 4 * per_row


def knn_values_torch(dn: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                     *, ties=DEFAULT_TIES, block: int = 128,
                     row_off: int = 0) -> torch.Tensor:
    """Plain torch (n, k+1) values (any device), ``block`` rows per chunk;
    ``row_off`` is the global index of the first row (the ``ignore``
    tiebreak compares it with the neighbor indices)."""
    wfun = resolve_weight(ties)
    n, k = dn.shape
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dn.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        ow = None
        if wfun.needs_index_tiebreak:  # "index of x > index of nbr_j"
            rows = row_off + torch.arange(s, e, device=idx.device)
            ow = rows[:, None] > idx[s:e]
        out[s:e] = knn_values_tile(dn[s:e].to(torch.float32),
                                   g[s:e].to(torch.float32), ow, wfun)
    return out


def knn_values_from_features_torch(X: torch.Tensor, dn: torch.Tensor,
                                   idx: torch.Tensor, *,
                                   metric: str = "euclidean",
                                   ties=DEFAULT_TIES, block: int = 128,
                                   row_off: int = 0) -> torch.Tensor:
    """Plain version of the features source (any device): row chunks of
    ``block``, each chunk's tiles gathered from X, then
    :func:`knn_values_torch`; never more than a (block, k, k) tile.
    ``row_off``: the global index of the graph's first row."""
    metric_id(metric)
    n, k = dn.shape
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dn.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        g = gather_tile_from_features(X, idx[s:e], metric)
        out[s:e] = knn_values_torch(dn[s:e], g, idx[s:e], ties=ties,
                                    block=block, row_off=row_off + s)
    return out


def knn_values_from_neighbors_torch(Xn: torch.Tensor, dn: torch.Tensor,
                                    idx: torch.Tensor, *,
                                    metric: str = "euclidean",
                                    ties=DEFAULT_TIES, block: int = 128,
                                    row_off: int = 0) -> torch.Tensor:
    """Plain version of the neighbor-block source (any device): as
    :func:`knn_values_from_features_torch`, each row's tile computed from
    its own (k, d) rows of ``Xn`` (n, k, d) instead of X's rows at idx."""
    metric_id(metric)
    n, k = dn.shape
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dn.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        g = gather_tile_from_neighbors(Xn[s:e], idx[s:e], metric)
        out[s:e] = knn_values_torch(dn[s:e], g, idx[s:e], ties=ties,
                                    block=block, row_off=row_off + s)
    return out


def knn_values_from_distances_torch(D: torch.Tensor, dn: torch.Tensor,
                                    idx: torch.Tensor, *, ties=DEFAULT_TIES,
                                    block: int = 128) -> torch.Tensor:
    """Plain version of the D source (any device), chunked as
    :func:`knn_values_from_features_torch`."""
    n, k = dn.shape
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dn.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        g = gather_tile_from_distances(D, idx[s:e])
        out[s:e] = knn_values_torch(dn[s:e], g, idx[s:e], ties=ties,
                                    block=block, row_off=s)
    return out


def large_scratch(n: int, k: int, items: int = 1) -> int:
    """Floats of the large-k variant's scratch for a grid of ``n`` rows
    and ``items`` items: 2 k (W and the norms) for each of its
    min(n, 1024) row blocks an item, the items of one grid (65535 at
    most; the grids run in turn and share it)."""
    return 2 * k * min(n, _BIG_GRID) * min(items, MAX_ITEMS)


def _launch(name, functor, fn_args, out, counter, items=1):
    """Launch ``name`` with ``fn_args``, where the scratch pointer is
    None: a scratch for the large-k variant past :data:`LARGE_K`
    (:func:`large_scratch`), else null (four rows a block)."""
    fn = _build.load(name, functor)
    dev = out.device
    n, k = out.shape[-2], out.shape[-1] - 1
    large = k > LARGE_K
    scratch = (torch.empty(large_scratch(n, k, items), dtype=torch.float32,
                           device=dev) if large else None)
    ptr = 0 if scratch is None else scratch.data_ptr()
    fn_args = tuple(ptr if a is None else a for a in fn_args)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*fn_args, stream)
    _build.check(status, name)
    counter.launches += 1
    counter.large_launches += large
    counter.grid_launches += item_grids(items)
    return out


def _graph_shape(who, dn, nbr=False):
    """(lead, n, k) of the graph's dn: (n, k), or a (b, n, k) chunk where
    the entry takes one."""
    if dn.ndim not in (2, 3) or (nbr and dn.ndim == 3):
        raise ValueError(f"{who}: dn must be (n, k)"
                         + ("" if nbr else " or a (b, n, k) chunk")
                         + f", got shape {tuple(dn.shape)}")
    return tuple(dn.shape[:-2]), dn.shape[-2], dn.shape[-1]


def check_indices(who: str, idx: torch.Tensor, m: int) -> None:
    """Raise unless every neighbor index lies in [0, m): the features and
    D sources read rows of X or D at them unchecked, so ``ops.knn_values``
    checks a graph that a caller built (one ``aminmax`` of idx and one
    host sync; a graph the selection just built is not checked)."""
    if idx.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo < 0 or hi >= m:
        raise ValueError(f"{who}: neighbor indices span [{lo}, {hi}], "
                         f"outside the {m} rows they index")


def _check_k(who: str, k: int) -> None:
    if k < 1:
        raise ValueError(f"{who}: k={k} < 1")


def _features_source(who, X, dn, idx, metric, ties, row_off, nbr, counter):
    """Launch the features entry: X (m, d), or with ``nbr`` the (n, k, d)
    neighbor-row block."""
    mid = metric_id(metric)
    spec = kernel_spec(ties)
    wid, p0, p1 = spec
    dev = dn.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    lead, n, k = _graph_shape(who, dn, nbr)
    shape = lead + ((n, k, X.shape[-1]) if nbr else tuple(X.shape[-2:]))
    check_operands(who, dev, X=(X, shape, torch.float32),
                   dn=(dn, lead + (n, k), torch.float32),
                   idx=(idx, lead + (n, k), torch.int32))
    _check_k(who, k)
    if row_off < 0:
        raise ValueError(f"{who}: row_off={row_off} < 0")
    out = torch.empty(lead + (n, k + 1), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    items = lead[0] if lead else 1
    return _launch(features_entry(k, shape[-1]), spec.functor,
                   (dn.data_ptr(), X.data_ptr(), shape[-1], idx.data_ptr(),
                    out.data_ptr(), n, k, mid, row_off, int(nbr), items,
                    X[0].numel() if lead else 0, None, wid, p0, p1), out,
                   counter, items)


def knn_values_from_features_cuda(X: torch.Tensor, dn: torch.Tensor,
                                  idx: torch.Tensor, *,
                                  metric: str = "euclidean",
                                  ties=DEFAULT_TIES,
                                  row_off: int = 0) -> torch.Tensor:
    """(n, k+1) values with each row's tile computed from X in the kernel,
    for CUDA tensors; :func:`knn_values_from_features_torch` for CPU ones.
    ``row_off``: the global index of the graph's first row (a shard's).  On
    the card X (b, m, d) with dn, idx (b, n, k) is a chunk: (b, n, k+1)
    values from one launch.

    CUDA operands must be contiguous (X, dn float32; idx int32) on one
    device, with k >= 1; anything else raises, as does a weight functional
    that does not compile.  Allocates the output (and past
    :data:`LARGE_K` the large-k variant's scratch, :func:`large_scratch`).
    Every index must lie in [0, n_X): the kernel reads X's rows at them
    unchecked (:func:`check_indices`).  Each launch adds one to
    ``.launches`` (and past :data:`LARGE_K` to ``.large_launches``), and
    its grids (one per ``MAX_ITEMS`` items) to ``.grid_launches``.
    """
    if dn.device.type == "cpu":
        return knn_values_from_features_torch(X, dn, idx, metric=metric,
                                              ties=ties, row_off=row_off)
    return _features_source("knn_values_from_features_cuda", X, dn, idx,
                            metric, ties, row_off, False,
                            knn_values_from_features_cuda)


def knn_values_from_neighbors_cuda(Xn: torch.Tensor, dn: torch.Tensor,
                                   idx: torch.Tensor, *,
                                   metric: str = "euclidean",
                                   ties=DEFAULT_TIES,
                                   row_off: int = 0) -> torch.Tensor:
    """(n, k+1) values from ``Xn`` (n, k, d), row x's neighbor feature
    rows (``Xn[x, j]`` the features of ``idx[x, j]``), through the
    features entry of the kernel for CUDA tensors and
    :func:`knn_values_from_neighbors_torch` for CPU ones; bitwise
    :func:`knn_values_from_features_cuda` on the X those rows came from.
    Reads no row at an index, so idx needs no range check.  Operands and
    checks otherwise as :func:`knn_values_from_features_cuda`'s; each
    launch adds one to ``.launches`` and ``.grid_launches``."""
    if dn.device.type == "cpu":
        return knn_values_from_neighbors_torch(Xn, dn, idx, metric=metric,
                                               ties=ties, row_off=row_off)
    return _features_source("knn_values_from_neighbors_cuda", Xn, dn, idx,
                            metric, ties, row_off, True,
                            knn_values_from_neighbors_cuda)


def knn_values_from_distances_cuda(D: torch.Tensor, dn: torch.Tensor,
                                   idx: torch.Tensor, *,
                                   ties=DEFAULT_TIES) -> torch.Tensor:
    """(n, k+1) values with D[idx_j, idx_m] read straight from D in the
    kernel, for CUDA tensors; :func:`knn_values_from_distances_torch` for
    CPU ones.  Operands and counters as
    :func:`knn_values_from_features_cuda`'s (D (m, m) float32; every
    index in [0, m)); on the card D (b, m, m) with dn, idx (b, n, k) is a
    chunk, one launch."""
    if dn.device.type == "cpu":
        return knn_values_from_distances_torch(D, dn, idx, ties=ties)
    who = "knn_values_from_distances_cuda"
    spec = kernel_spec(ties)
    wid, p0, p1 = spec
    dev = dn.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    lead, n, k = _graph_shape(who, dn)
    m = D.shape[-1]
    check_operands(who, dev, D=(D, lead + (m, m), torch.float32),
                   dn=(dn, lead + (n, k), torch.float32),
                   idx=(idx, lead + (n, k), torch.int32))
    _check_k(who, k)
    out = torch.empty(lead + (n, k + 1), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    items = lead[0] if lead else 1
    return _launch("pald_knn_values_distances_f32", spec.functor,
                   (dn.data_ptr(), D.data_ptr(), m, idx.data_ptr(),
                    out.data_ptr(), n, k, items, m * m, None, wid, p0, p1),
                   out, knn_values_from_distances_cuda, items)


def knn_values_cuda(dn: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                    *, ties=DEFAULT_TIES) -> torch.Tensor:
    """(n, k+1) values through the CUDA kernel for CUDA tensors, through
    :func:`knn_values_torch` for CPU tensors.

    CUDA operands must be contiguous (dn, g float32; idx int32) on one
    device, with k >= 1; anything else raises, as does a weight functional
    that does not compile.  Each launch adds one to
    ``knn_values_cuda.launches`` (past :data:`LARGE_K` also to
    ``.large_launches``; to ``.grid_launches``: one grid).
    """
    if dn.device.type == "cpu":
        return knn_values_torch(dn, g, idx, ties=ties)
    spec = kernel_spec(ties)
    wid, p0, p1 = spec
    dev = dn.device
    if dev.type != "cuda":
        raise ValueError(f"knn_values_cuda: unsupported device {dev}")
    n, k = dn.shape
    check_operands("knn_values_cuda", dev,
                   dn=(dn, (n, k), torch.float32),
                   g=(g, (n, k, k), torch.float32),
                   idx=(idx, (n, k), torch.int32))
    _check_k("knn_values_cuda", k)
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    return _launch("pald_knn_values_f32", spec.functor,
                   (dn.data_ptr(), g.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, k, None, wid, p0, p1), out,
                   knn_values_cuda)


for _f in (knn_values_cuda, knn_values_from_features_cuda,
           knn_values_from_distances_cuda, knn_values_from_neighbors_cuda):
    _f.launches = _f.large_launches = _f.grid_launches = 0
