"""Mesh-sharded k-NN PaLD: the fused select->cohere pipeline over the ranks
of a ``DeviceMesh`` (counterpart of ``repro.core.distributed_knn``).

``core/distributed.py`` shards the dense two-pass algorithm; this module
shards the sparse O(n k^2) restriction fused with the streaming selection,
so both stages run per rank and only the (n, k+1) sparse result is ever
global.  X is row-sharded over the flattened mesh; each rank selects the
exact k nearest neighbors of its own rows with the selection kernel's
block entry (``kernels/pald_topk.py::topk_block_cuda``: rows against a
block of candidates, global indices, self excluded by global index),
merges partial lists exactly on the (value, index) key
(``pald_topk.merge_pairs``), and runs the values kernel on its rows
(``kernels/pald_knn.py``: the features source with the rows' global
offset, or the neighbor-block source where X is not held whole).  SPMD:
every rank calls :func:`pald_knn_sharded` with the same global X and gets
the global graph and values.

Strategies (comm figures are float32 words received a rank; see
:func:`comm_estimate`, the reference's model):

allgather   one all-gather of X, (p-1)/p n d words; each rank then scores
            its rows against every candidate in one selection launch.
ring        no global X copy: (m, d) feature blocks rotate one step at a
            time, twice (selection, then the neighbor rows),
            2 (p-1)/p n d words; each step's partial list merges into the
            running one.  The values kernel reads the (m, k, d) neighbor
            rows gathered in the second rotation.
2d          (pr, pc) mesh: each rank scores its row group's rows against
            the pr candidate blocks it gathers along the row dimensions
            (1/pc of the candidates), then one k-wide gather and merge
            along the column dimension finishes the selection.  (The
            reference also gathers the row ids; the port computes them,
            and the model keeps the reference's terms.)

Bitwise contract: every strategy gives the port's single-device
``kernels.ops.select_cohere`` row for row.  A distance comes from the same
fixed-order loop over the features whatever block it lies in
(``csrc/pald_dist.cuh``, ``core/features.py``), the merge orders by the
same total (value, index) key the selection kernel keeps, and the values
of a row depend only on its neighbors' rows and its global index.

Padding: n is padded to the shard quantum with zero feature rows; their
rows are never scored and their global indices are never candidates.  A
list with fewer than k real candidates is filled with (+inf,
``INT32_MAX``), which loses every comparison.

A failure in one rank is a failure of all: the entry point checks whether
any rank failed (one all-reduce) after each fault point, both before any
collective, and after the body; then every rank raises
(``on_error="raise"``) or every rank degrades to the single-device
pipeline (``"fallback"``).  The process groups' finite timeout
(``distributed.TIMEOUT_S``) bounds the wait on a peer that failed inside
a collective.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import pald_knn as kv
from repro_torch.kernels import pald_topk as ks
from repro_torch.kernels.pald_topk import merge_pairs as _merge_pairs
from repro_torch.tuning import autotune as _tuner

from . import knn as _knn
from .distributed import (P, _agreed, _all_gather, _axis_index,
                          _device_of, _group, _names, _Shift,
                          shard_map_compat)
from .features import METRICS
from .resilience import fault_point, warn_once
from .weights import DEFAULT_TIES, resolve_weight

__all__ = ["STRATEGIES", "pald_knn_sharded", "comm_estimate",
           "resolve_shard_shapes", "METRICS"]

STRATEGIES = ("auto", "allgather", "ring", "2d")

_IMAX = 2 ** 31 - 1  # the (value, index) sentinel: loses every comparison


def _kernels(impl: str):
    """(selection block entry, values from X, values from neighbor rows)
    of ``impl``: the CUDA wrappers (plain versions for CPU tensors) or the
    plain versions."""
    if impl == "torch":
        return (ks.topk_block_torch, kv.knn_values_from_features_torch,
                kv.knn_values_from_neighbors_torch)
    return (ks.topk_block_cuda, kv.knn_values_from_features_cuda,
            kv.knn_values_from_neighbors_cuda)


def _outputs(mloc, k, dev):
    """A rank's (dist, idx, values) blocks: empty entries for padded rows."""
    return (torch.full((mloc, k), float("inf"), dtype=torch.float32,
                       device=dev),
            torch.full((mloc, k), _IMAX, dtype=torch.int32, device=dev),
            torch.zeros((mloc, k + 1), dtype=torch.float32, device=dev))


def _valid(n: int, off: int, m: int) -> int:
    """Rows of a block of m rows at global offset ``off`` below n."""
    return max(0, min(m, n - off))


# ---------------------------------------------------------------------------
# shard bodies (each returns the (mloc, k) / (mloc, k+1) row-sharded triple)
# ---------------------------------------------------------------------------
def _knn_allgather_body(Xloc, *, mesh, axis, k, metric, n, wfun, impl):
    """One all-gather of X, then the rank's rows against every candidate
    (one selection launch) and the values from X at the rows' offset."""
    select, values, _ = _kernels(impl)
    mloc = Xloc.shape[0]
    Xall = _all_gather(Xloc, mesh, axis)                     # (m, d)
    off0 = _axis_index(mesh, axis) * mloc
    mv = _valid(n, off0, mloc)
    dv, di, vals = _outputs(mloc, k, Xloc.device)
    if mv:
        g = select(Xall[off0:off0 + mv], Xall[:n], k, metric=metric,
                   row_off=off0, col_off=0)
        dv[:mv], di[:mv] = g.distances, g.indices
        vals[:mv] = values(Xall[:n], g.distances, g.indices, metric=metric,
                           ties=wfun, row_off=off0)
    return dv, di, vals


def _knn_ring_body(Xloc, *, mesh, axis, p, k, metric, n, wfun, impl):
    """Streaming selection: (m, d) feature blocks rotate one step at a
    time; each step's partial list merges into the running (m, k) list on
    the (value, index) key.  A second rotation collects the selected
    neighbors' rows, then the values run on them."""
    select, _, values = _kernels(impl)
    mloc, d = Xloc.shape
    r = _axis_index(mesh, axis)
    row0 = r * mloc
    mv = _valid(n, row0, mloc)
    rows = Xloc[:mv]
    bv = torch.full((mv, k), float("inf"), dtype=torch.float32,
                    device=Xloc.device)
    bi = torch.full((mv, k), _IMAX, dtype=torch.int32, device=Xloc.device)

    def rotate(step):
        blk = Xloc
        for s in range(p):
            nxt = _Shift(blk, mesh, axis) if s < p - 1 else None
            try:
                step(((r - s) % p) * mloc, blk)  # the block of rank r - s
            finally:  # a failed step still completes its transfer
                if nxt is not None:
                    blk = nxt.result()

    def sel_step(off, blk):
        nonlocal bv, bi
        w = _valid(n, off, mloc)
        if mv and w:
            g = select(rows, blk[:w], k, metric=metric, row_off=row0,
                       col_off=off)
            bv, bi = _merge_pairs(torch.cat([bv, g.distances], 1),
                                  torch.cat([bi, g.indices], 1), k)

    rotate(sel_step)
    # rotation 2: each selected index lives in exactly one block
    Xn = torch.zeros((mv, k, d), dtype=torch.float32, device=Xloc.device)

    def gat_step(off, blk):
        loc = bi.long() - off
        inr = (loc >= 0) & (loc < mloc) & (bi < n)
        Xn[inr] = blk[loc[inr]]

    rotate(gat_step)
    dv, di, vals = _outputs(mloc, k, Xloc.device)
    if mv:
        dv[:mv], di[:mv] = bv, bi
        vals[:mv] = values(Xn, bv, bi, metric=metric, ties=wfun,
                           row_off=row0)
    return dv, di, vals


def _knn_2d_body(Xloc, *, mesh, row_axes, col_axis, k, metric, n, wfun,
                 impl, pr, pc):
    """2-D decomposition: each rank scores its row group's rows (the pc
    blocks along the column dimension) against the pr candidate blocks it
    gathers along the row dimensions, then the column dimension gathers
    and exactly merges the k-wide partial lists."""
    select, values, _ = _kernels(impl)
    mloc = Xloc.shape[0]
    allax = (*row_axes, col_axis)
    flat = _axis_index(mesh, allax)       # row-major flattened rank
    ci = _axis_index(mesh, col_axis)
    ri = _axis_index(mesh, row_axes)
    # one gather of X (the values need every neighbor's row)
    Xall = _all_gather(Xloc, mesh, allax)                    # (m, d)
    Xrow = _all_gather(Xloc, mesh, col_axis)                 # (mr, d)
    Xcand = _all_gather(Xloc, mesh, row_axes)                # (pr mloc, d)
    mr = Xrow.shape[0]
    row0 = ri * mr                        # the row group's first row
    mvr = _valid(n, row0, mr)
    pv = torch.full((mr, k), float("inf"), dtype=torch.float32,
                    device=Xloc.device)
    pi = torch.full((mr, k), _IMAX, dtype=torch.int32, device=Xloc.device)
    for b in range(pr):                   # candidate block of row rank b
        off = (b * pc + ci) * mloc
        w = _valid(n, off, mloc)
        if mvr and w:
            g = select(Xrow[:mvr], Xcand[b * mloc:b * mloc + w], k,
                       metric=metric, row_off=row0, col_off=off)
            v, i = _merge_pairs(torch.cat([pv[:mvr], g.distances], 1),
                                torch.cat([pi[:mvr], g.indices], 1), k)
            pv[:mvr], pi[:mvr] = v, i
    # merge the pc partial lists (disjoint candidate sets) exactly
    dv, di = _merge_pairs(_all_gather(pv, mesh, col_axis, dim=1),
                          _all_gather(pi, mesh, col_axis, dim=1), k)
    # this rank's own rows sit at column position ci of the row group
    off0 = flat * mloc
    mv = _valid(n, off0, mloc)
    odv, odi, vals = _outputs(mloc, k, Xloc.device)
    if mv:
        own = slice(ci * mloc, ci * mloc + mv)
        odv[:mv], odi[:mv] = dv[own], di[own]
        vals[:mv] = values(Xall[:n], odv[:mv], odi[:mv], metric=metric,
                           ties=wfun, row_off=off0)
    return odv, odi, vals


# ---------------------------------------------------------------------------
# shapes + communication model (read by engine.explain and dryrun_pald)
# ---------------------------------------------------------------------------
def resolve_shard_shapes(n: int, *, p: int, chunk: int) -> tuple[int, int, int]:
    """(chunk, quantum, m_padded): the one place the padding math lives.

    ``chunk`` is clamped to the per-shard row count; the global quantum is
    ``p * chunk`` so every shard's row count is a chunk multiple (the plain
    selection's rows per slab)."""
    chunk = max(1, min(int(chunk), -(-n // p)))
    quantum = p * chunk
    m = -(-n // quantum) * quantum
    return chunk, quantum, m


def comm_estimate(strategy: str, *, n: int, d: int, k: int, p: int,
                  pr: int | None = None, pc: int | None = None) -> dict:
    """Per-rank communication model of the sharded k-NN pipeline (the
    reference's, term for term).

    Words are float32 words RECEIVED a rank (gathers and ring steps;
    int32 index words count as one word).  Every strategy moves O(n d)
    feature words, never the O(n^2) distance matrix; the 2d strategy adds
    the O((n/pr) k) selection-merge term.

    Returns a dict with ``per_device_words``, ``per_device_bytes``,
    ``total_words`` (summed over ranks) and the per-collective
    ``breakdown``.
    """
    if strategy == "auto":
        strategy = "2d" if (pr or 0) > 0 and (pc or 0) > 1 else "ring"
    mloc = -(-n // p)
    if strategy == "allgather":
        parts = {"allgather_x": (p - 1) * mloc * d}
    elif strategy == "ring":
        parts = {"ring_select_x": (p - 1) * mloc * d,
                 "ring_gather_x": (p - 1) * mloc * d}
    elif strategy == "2d":
        pr = pr or 1
        pc = pc or p
        mr = -(-n // pr)
        kt = min(k, pr * mloc)
        parts = {"allgather_x": (p - 1) * mloc * d,
                 "allgather_ids": (p - 1) * mloc + (pc - 1) * mloc
                 + (pr - 1) * mloc,
                 "rowcand_slabs": (pc - 1) * mloc * d + (pr - 1) * mloc * d,
                 "merge_partials": 2 * (pc - 1) * mr * kt}
    else:
        raise ValueError(f"unknown strategy {strategy!r} "
                         f"(expected one of {STRATEGIES[1:]})")
    per_dev = int(sum(parts.values()))
    return {"strategy": strategy, "p": p,
            "per_device_words": per_dev,
            "per_device_bytes": 4 * per_dev,
            "total_words": per_dev * p,
            "breakdown": {kk: int(v) for kk, v in parts.items()}}


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------
def pald_knn_sharded(
    X,
    mesh,
    *,
    k: int,
    metric: str = "euclidean",
    strategy: str = "auto",
    normalize: bool = True,
    ties=None,
    weight=None,
    block: int | str = "auto",
    tile: int | str = "auto",
    on_error: str = "raise",
    impl: str | None = None,
    device="cuda",
) -> tuple["_knn.NeighborGraph", torch.Tensor]:
    """Mesh-sharded fused select->cohere k-NN PaLD from features.

    Every rank of the mesh's world calls it with the same global X.

    Args:
        X: global (n, d) feature matrix (cast to float32 once).
        mesh: the ``DeviceMesh`` to run on.  1-D strategies flatten every
            dimension; "2d" takes all-but-last as row dimensions and the
            last as the column (selection-split) dimension.
        k: neighborhood size (clamped to n-1, like ``select_cohere``).
        metric: one of ``features.METRICS``.
        strategy: "allgather" / "ring" / "2d", or "auto": "2d" on a mesh
            of >= 2 dimensions, "ring" otherwise.
        normalize: divide the values by (n-1) (the public-API default).
        ties / weight: the weight-functional knob, as in
            ``pald.from_features``.
        block: rows per selection slab of the plain versions; "auto"
            resolves through the mesh-keyed ``pald_topk:k<k>:d<d>:p<p>``
            tuning pass (falling back to the single-device cell on a
            miss); it also sets the shard quantum (the padding).
        tile: the single-device fallback's prefilter tile (the shard
            bodies' plain selection sorts whole rows: the same graph).
        on_error: "raise" propagates a sharded failure (in every rank);
            "fallback" degrades every rank to the single-device fused
            pipeline (``kernels.ops.select_cohere``) with identical
            semantics, warning once (``resilience.DegradationWarning``).
        impl: "cuda" (the kernels; the default on the card) or "torch"
            (the plain versions).
        device: "cuda" (default; the rank's current CUDA device) or "cpu".

    Returns:
        (graph, values): the exact ``NeighborGraph`` (n, k) and the (n,
        k+1) sparse cohesion values (column 0 = self), bitwise the
        single-device ``select_cohere(X, k=..., ...)``.

    Raises:
        ValueError: unknown strategy / metric, or "2d" on a 1-D mesh.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} "
                         f"(expected one of {STRATEGIES})")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r} (one of {METRICS})")
    axes = _names(mesh)
    if strategy == "auto":
        strategy = "2d" if len(axes) >= 2 else "ring"
    if strategy == "2d" and len(axes) < 2:
        raise ValueError("strategy '2d' needs a mesh with >= 2 axes "
                         f"(got axes {axes}); use 'allgather' or 'ring'")
    wfun = resolve_weight(weight if weight is not None
                          else (ties if ties is not None else DEFAULT_TIES))
    from repro_torch.kernels.ops import IMPLS, default_impl

    dev = _device_of(device)
    impl = impl or default_impl(dev)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")

    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    n0, d = X.shape
    k = min(int(k), max(n0 - 1, 0))
    if k <= 0:
        return (_knn.empty_graph(n0, dev),
                torch.zeros((n0, 1), dtype=torch.float32, device=dev))

    shape = tuple(mesh.mesh.shape)
    p = math.prod(shape)
    pr = math.prod(shape[:-1]) if len(shape) >= 2 else 1
    pc = shape[-1]
    if block == "auto" or tile == "auto":
        rb, rt = _tuner.resolve_blocks(n0, "pald_topk", impl=impl, d=d, k=k,
                                       p=p, device=dev)
        block = rb if block == "auto" else block
        tile = rt if tile == "auto" else tile
    chunk, _, m = resolve_shard_shapes(n0, p=p, chunk=int(block))
    # every group the bodies use exists before any rank can fail (created
    # in the same order on every rank)
    for a in dict.fromkeys((axes, axes[:-1] or axes, (axes[-1],))):
        _group(mesh, a)

    _agreed(mesh, dev, lambda: fault_point(
        "distributed_knn.dispatch", strategy=strategy, p=p, k=k,
        metric=metric))

    def run_sharded():
        Xp = torch.zeros((m, d), dtype=torch.float32, device=dev)
        Xp[:n0] = X
        common = dict(k=k, metric=metric, n=n0, wfun=wfun, impl=impl)
        if strategy == "allgather":
            def body(x):
                return _knn_allgather_body(x, mesh=mesh, axis=axes, **common)
        elif strategy == "ring":
            def body(x):
                return _knn_ring_body(x, mesh=mesh, axis=axes, p=p, **common)
        else:
            def body(x):
                return _knn_2d_body(x, mesh=mesh, row_axes=axes[:-1],
                                    col_axis=axes[-1], pr=pr, pc=pc,
                                    **common)
        _agreed(mesh, dev, lambda: fault_point(
            "distributed_knn.body", strategy=strategy, p=p, mesh=shape))
        spec = P(axes, None)
        dv, di, vals = shard_map_compat(
            body, mesh=mesh, in_specs=spec, out_specs=(spec, spec, spec))(Xp)
        return dv[:n0], di[:n0], vals[:n0]

    if on_error == "fallback":
        try:
            dv, di, vals = _agreed(mesh, dev, run_sharded)
        except Exception as exc:  # noqa: BLE001 - the guard's whole job
            from repro_torch.kernels import ops as _ops

            warn_once(("distributed-knn", strategy, shape),
                      f"sharded knn pipeline (strategy={strategy!r}, mesh="
                      f"{shape}) failed ({type(exc).__name__}: {exc}); "
                      "degraded to the single-device fused path with "
                      "identical semantics")
            return _ops.select_cohere(
                X, k=k, metric=metric, block=chunk,
                tile=int(tile) if strategy == "allgather" else "auto",
                impl=impl, ties=wfun, normalize=normalize)
    elif on_error == "raise":
        dv, di, vals = _agreed(mesh, dev, run_sharded)
    else:
        raise ValueError(f"unknown on_error {on_error!r} (expected 'raise' "
                         "or 'fallback')")
    if normalize:
        vals = vals / max(n0 - 1, 1)
    return _knn.NeighborGraph(di, dv), vals
