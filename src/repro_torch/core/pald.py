"""Public PaLD API of the PyTorch/CUDA port: thin facades over the
execution-plan engine (counterpart of ``repro.core.pald``).

    from repro_torch.core import pald
    C = pald.cohesion(D, method="kernel")     # CUDA kernels (dense grid)
    C = pald.cohesion(D, schedule="tri")      # CUDA kernels, upper block
    #                                           pairs (pins method="kernel")
    C = pald.cohesion(D, method="triplet")    # block-symmetric plain torch
    C = pald.cohesion(D, method="pairwise")   # blocked plain torch (Fig. 5)
    C = pald.cohesion(D, method="dense")      # un-blocked plain torch
    C = pald.cohesion(Db, method="kernel")    # batched: (B, n, n) -> (B, n, n)
    C = pald.cohesion(Db, batch=8)            # ... in chunks of 8 items
    C = pald.cohesion(D, on_error="fallback") # degrade instead of raising
    C = pald.cohesion(D, method="kernel", device="cpu")  # plain torch on CPU
    C = pald.from_features(X)                 # fused CUDA kernels, D never
    #                                           whole (one panel of rows)
    C = pald.from_features(X, k=32)           # sparse k-NN: streaming top-k
    #                                           and k-NN cohesion kernels
    C = pald.cohesion(D, method="knn", k=32)  # k-NN on a distance matrix

    p = pald.plan(D, method="kernel")         # resolve once ...
    C = p.execute(D)                          # ... run (and re-run)
    p.explain()                               # what resolved

Every knob is resolved once by ``pald.plan`` (``core/engine.py``);
``cohesion`` is ``plan(...).execute(D)`` and ``from_features`` is
``plan(X, kind="features", ...).execute(X)``.  ``device`` defaults to "cuda":
the input (numpy array or tensor) moves there, and without a GPU the
default raises.  The CPU runs only when the caller passes ``device="cpu"``.

Inputs of any size are padded internally to a block multiple with +inf
distances; padded points land outside every local focus and contribute
nothing.  Every entry point casts its input to float32 once at the executor
boundary and returns float32 on the plan's device.
"""
from __future__ import annotations

from typing import Literal

import torch

from .engine import PaldPlan, pad_distance_matrix  # noqa: F401
from .engine import plan as _engine_plan
from .weights import (  # noqa: F401
    DEFAULT_TIES,
    TIE_MODES,
    WeightFunctional,
    register_weight,
    registered_weights,
    validate_ties,
)

Method = Literal["auto", "dense", "pairwise", "triplet", "kernel"]
Ties = Literal["drop", "split", "ignore"]

__all__ = ["cohesion", "from_features", "plan", "local_depths", "pad_distance_matrix",
           "PaldPlan", "WeightFunctional", "register_weight",
           "registered_weights"]


def plan(x=None, **kwargs) -> PaldPlan:
    """Resolve a PaLD execution plan exactly once.

    Args:
        x: optional (n, n) / (B, n, n) distance matrix the plan is keyed
            on; omit it and pass ``n=`` for shape-only planning.
        **kwargs: every knob of ``cohesion`` plus ``n``; full semantics in
            ``repro_torch.core.engine.plan``.

    Returns:
        A frozen ``PaldPlan``: ``execute(x)`` runs it, ``explain()`` reports
        every resolved knob.
    """
    return _engine_plan(x, **kwargs)


def cohesion(
    D,
    *,
    method: str = "auto",
    block: int | str | None = None,
    block_z: int | str | None = None,
    schedule: str = "dense",
    normalize: bool = True,
    z_chunk: int | None = None,
    impl: str | None = None,
    ties: str | None = None,
    weight: str | WeightFunctional | None = None,
    batch: int | None = None,
    check: bool = False,
    k: int | None = None,
    on_error: str = "raise",
    device="cuda",
) -> torch.Tensor:
    """Compute the PaLD cohesion matrix C from a distance matrix D.

    Args:
        D: (n, n) distance matrix with an exactly-zero diagonal, or a
            batched (B, n, n) stack; numpy array or tensor, any float dtype.
        method: "kernel" (the CUDA kernel pipeline), "pairwise" (blocked
            Fig. 5), "triplet" (block-symmetric: the upper block pairs,
            both roles per pair, plain torch), "dense" (un-blocked), or
            "knn" (the sparse k-NN restriction: a stable sort of D's rows,
            then the k-NN cohesion kernel; needs ``k``).  "auto" with
            ``k`` is "knn", with ``schedule="tri"`` "kernel"; otherwise
            the method the tuning cache measured fastest on this device at
            the nearest n (``python -m repro_torch.tuning.hillclimb
            methods``), else the reference's heuristic: "dense" up to
            n = 256, "triplet" above (the tri kernels on the card).
        block: tile of the engine's +inf pad for the blocked paths
            (default 128), the k-NN plain version's rows per chunk;
            "auto" reads the tuning cache (``pald`` / ``pald_tri`` /
            ``pald_knn:k<k>`` passes, keyed by the device's name).
            ``method="dense"`` has no tile.
        block_z: z chunk of the kernel pipeline's plain version ("auto":
            the cache, or no z tile on "pairwise" / "triplet").
        schedule: "dense", or "tri" (kernel method only): both passes on
            the upper-triangular block pairs, through the tri CUDA
            kernels (``ops.pald_tri``); D must be symmetric.
        normalize: apply the 1/(n-1) factor (Eq. 3.3); on by default.
        z_chunk: third-point streaming chunk (dense method only).
        impl: "cuda" (hand-written kernels) or "torch" (plain versions);
            kernel method only; default: the device's.
        ties: 'drop' (default), 'split' or 'ignore' — what an exact
            distance tie means; sugar for ``weight=``.
        weight: a registered weight-functional name or a
            ``WeightFunctional`` (``core/weights.py``).  The CUDA kernels
            run the built-in families; a user-registered functional runs on
            the plain paths only.
        batch: for a batched D, the most items held and run together (one
            launch per pass for a chunk on the kernel method); None: the
            whole batch in one chunk.  Peak memory grows with the chunk;
            any chunk size gives bitwise the same C.
        check: add deep input validation (finite, symmetric, nonnegative).
        k: neighborhood size of ``method="knn"`` (pins it), clamped to
            n-1; at k >= n-1 the result is ``method="dense"``'s, bitwise.
        on_error: "raise" (default: the first failure propagates) or
            "fallback": an out-of-memory batched call retries with
            ``batch`` halved, and on the CPU any other failure walks the
            cell's degradation chain (plain torch, the blocked methods,
            the reference oracle; ``core/resilience.py``); each
            degradation is in ``plan.explain()["degradations"]``.  On the
            card only the halving rescues: the chain's rungs would leave
            the kernels, so the call ends in ``FallbackExhausted``.
        device: "cuda" (default) or "cpu".

    Returns:
        C as float32 on ``device``, shaped like D.
    """
    p = _engine_plan(
        D, kind="distance", method=method, schedule=schedule, block=block,
        block_z=block_z, z_chunk=z_chunk, normalize=normalize, impl=impl,
        ties=ties, weight=weight, batch=batch, check=check, k=k,
        on_error=on_error, device=device,
    )
    return p.execute(D)


def from_features(
    X,
    *,
    metric: str = "euclidean",
    method: str = "auto",
    batch: int | None = None,
    block: int | str = "auto",
    block_z: int | str | None = None,
    schedule: str = "dense",
    normalize: bool = True,
    impl: str | None = None,
    ties: str | None = None,
    weight: str | WeightFunctional | None = None,
    check: bool = False,
    k: int | None = None,
    on_error: str = "raise",
    select: str | None = None,
    select_block: int | str | None = None,
    select_tile: int | str | None = None,
    mesh=None,
    strategy: str | None = None,
    device="cuda",
) -> torch.Tensor:
    """PaLD cohesion straight from feature vectors.

    Args:
        X: (n, d) feature matrix or a batched (B, n, d) stack; numpy array
            or tensor, any float dtype (cast to float32 once).
        metric: one of ``features.METRICS`` (sqeuclidean, euclidean,
            cosine, manhattan).
        method: "fused" (the "auto" default) computes the distances on
            the card from the feature rows, one panel of rows at a time,
            so the (n, n) distance matrix is never whole past n = 4096;
            "dense" / "pairwise" / "triplet" /
            "kernel" materialize D once (``features.cdist_reference``) and
            run the distance method of that name; "knn" (pinned by ``k``)
            selects each point's k nearest neighbors straight from the
            features (the streaming top-k kernel) and runs the k-NN
            cohesion kernel (``ops.select_cohere``).
        batch: for a batched X, the most items held and run together;
            None: the whole batch in one chunk.  Peak memory grows with the
            chunk; any chunk size gives bitwise the same C.
        block: the plain versions' row block and the materializing
            paths' tile; "auto" (the default, as in the reference) reads
            the tuning cache (the ``pald_fused:d<d>`` pass, the knn pass
            by k, the ``pald`` / ``pald_tri`` passes when D is
            materialized), else 128.  The CUDA kernels' tiles are fixed
            at 64 x 64: on the card ``block`` acts through the engine's
            +inf pad of a materialized D.
        block_z: the plain versions' reduced-axis chunk (default: with
            ``block``, else 512).
        schedule: "dense", or "tri": pins ``method="kernel"`` and runs the
            tri kernel pipeline on the materialized D.
        normalize: apply the 1/(n-1) factor; on by default.
        impl: "cuda" (the hand-written kernels) or "torch" (the plain
            versions); fused and kernel methods only; default: the
            device's.
        ties: 'drop' (default), 'split' or 'ignore'; sugar for
            ``weight=``.  Quantized or duplicated rows give exact ties.
        weight: a registered weight-functional name or a
            ``WeightFunctional``; the CUDA kernels run the built-in
            families.
        check: reject non-finite features.
        k: neighborhood size of ``method="knn"`` (pins it), clamped to
            n-1; at k >= n-1 the result is the dense method's on
            ``cdist_reference(X)``.
        select: the k-NN selection's impl ("cuda" or "torch"; None
            follows ``impl``), or "chunked": the guard's terminal rung,
            row slabs of distances and a stable sort each.
        select_block: the selection plain version's rows per slab
            ("auto"/None: the ``pald_topk:k<k>:d<d>`` cache pass, cold
            1024).
        select_tile: the plain selection's tile-min prefilter width (>= n
            sorts whole rows; bitwise the same graph either way;
            "auto"/None: the same cache pass, cold n).
        mesh: a ``torch.distributed`` ``DeviceMesh``
            (``launch.mesh.make_test_mesh``) to shard the fused
            select->cohere k-NN pipeline across (``method="knn"`` only):
            every rank of its world calls with the same X, rows of X are
            sharded over all mesh dimensions, feature blocks move by
            ``strategy``, and the result stays bitwise the single-device
            one (``core/distributed_knn.py``).
        strategy: mesh comm pattern: 'allgather', 'ring', or '2d'
            ('auto'/None picks '2d' on a mesh of >= 2 dimensions, 'ring'
            otherwise); requires ``mesh=``.
        on_error: "raise" (default) or "fallback" (see ``cohesion``; the
            k-NN cells end on ``select="chunked"``).
        device: "cuda" (default; raises without a GPU) or "cpu" (the
            plain versions).

    Returns:
        C as float32 on ``device``: (n, n), or (B, n, n) for batched X.
    """
    p = _engine_plan(
        X, kind="features", metric=metric, method=method, schedule=schedule,
        block=block, block_z=block_z, normalize=normalize, impl=impl,
        ties=ties, weight=weight, batch=batch, check=check, k=k,
        on_error=on_error, select=select, select_block=select_block,
        select_tile=select_tile, mesh=mesh, strategy=strategy, device=device,
    )
    return p.execute(X)


def local_depths(C: torch.Tensor) -> torch.Tensor:
    """Local depths from a cohesion matrix: (..., n) row sums of C.  With
    ``normalize=True`` upstream, ``sum(l) == n/2``."""
    return torch.sum(C, dim=-1)
