"""Execution-plan engine: resolve once, run anywhere (counterpart of
``repro.core.engine``).

``plan(x, ...) -> PaldPlan``
    Performs every resolution exactly once (device, impl, tiles, weight
    functional, knob validation, input shape checks) and returns a frozen,
    reusable plan.

``PaldPlan.execute(x)``
    The single dispatch path: moves ``x`` to the plan's device, checks it,
    looks the resolved ``(kind, method, schedule)`` up in the EXECUTOR
    REGISTRY and runs it.  Batched ``(B, n, n)`` distances or ``(B, n, d)``
    features run in chunks of up to ``batch`` items (``run_batched``).
    With ``on_error="fallback"`` a failure walks the cell's degradation
    chain (``core/resilience.py``).

``register_executor(kind, method, schedule)``
    How ``core/pairwise``, ``core/triplet`` and ``kernels/ops`` contribute
    their callables.

``PaldPlan.explain()``
    The resolved knobs as a plain dict (``weight_kernel``: the functor the
    CUDA kernels run, a user functional's compiled key and whether its
    libraries were built or reused).

Two kinds of input: ``"distance"`` (an (n, n) matrix, ``pald.cohesion``)
and ``"features"`` ((n, d) vectors, ``pald.from_features``).  On a
distance matrix ``method="auto"`` resolves as the reference does:
``z_chunk=`` pins ``"dense"``, ``impl=`` or an explicit ``block_z`` pins
``"kernel"``, and otherwise the tuning cache's measured crossover for the
plan's device (``tuning/autotune.method_for_ex``, keyed by the CUDA
device's name or "cpu"; ``method_source`` "cache:<key>" /
"nearest:<key>"), else ``"dense"`` for n <= 256 and ``"triplet"`` above
(``"heuristic"``).  ``block`` / ``block_z`` / ``select_block`` /
``select_tile`` set to ``"auto"`` resolve from the same cache
(``block_source`` / ``select_source``), as in the reference.  On features
``method="auto"`` resolves to ``"fused"`` (distances computed by the
kernels one panel of rows at a time, D never whole); ``"dense"`` / ``"pairwise"`` / ``"kernel"``
materialize D once with ``features.cdist_reference`` and run the distance
executor of the same name (``"triplet"`` too, and ``"kernel"`` on either
schedule).  ``schedule="tri"`` pins ``method="kernel"``, the only method
with that schedule.  ``k=`` pins ``method="knn"`` on either kind: the
sparse k-NN restriction, selection then (n, k+1) values, scattered to the
dense C (``kernels/ops.py``).

Device rule: ``device`` defaults to ``"cuda"``; the CPU is used only when
the caller passes ``device="cpu"``.  Without a GPU the default raises; it
never carries on on the CPU.

``mesh=`` / ``strategy=`` shard the fused select->cohere k-NN pipeline
over a ``DeviceMesh`` (``core/distributed_knn.py``), as in the reference:
only ``kind="features"`` with ``method="knn"`` takes a mesh.
``plan_local`` is the plan of the rectangular shard bodies of
``core/distributed.py`` (``PaldPlan.focus_general`` / ``cohesion_general``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.tuning import autotune as _tuner

from . import resilience as _res
from .weights import (DEFAULT_TIES, WeightFunctional, registered_weights,
                      resolve_weight, validate_ties)

__all__ = [
    "PaldPlan",
    "plan",
    "plan_local",
    "register_executor",
    "get_executor",
    "available_executors",
    "pad_distance_matrix",
    "run_batched",
    "run_chunk",
    "per_item",
    "chunk_or_items",
    "whole_chunk",
    "resolve_device",
]

DISTANCE_METHODS = ("dense", "pairwise", "triplet", "kernel", "knn")
FEATURE_METHODS = ("fused",) + DISTANCE_METHODS
# the methods whose features cell materializes D and runs the distance cell
_MATERIALIZING = ("dense", "pairwise", "triplet", "kernel")
SCHEDULES = ("dense", "tri")

# methods whose executors take an impl= knob; the plain blocked paths have
# exactly one implementation, so an explicit impl request there is an error
_IMPL_METHODS = ("kernel", "fused", "knn")

def resolve_device(device) -> torch.device:
    """The plan's device.  A CUDA device without a GPU raises: the port
    never carries on on the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA GPU is available; pass "
            "device='cpu' to run the plain torch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' "
                         "or 'cpu')")
    return dev


def pad_distance_matrix(
    D: torch.Tensor, block: int, *, dtype=torch.float32
) -> tuple[torch.Tensor, int]:
    """Pad D (or each item of a (b, n, n) chunk) to a multiple of
    ``block`` with +inf off-diagonal, 0 diagonal.

    Padded points are infinitely far from everything: they never enter a
    real pair's local focus (inf < d is false) and contribute to padded
    rows of C only.  The input is cast to ``dtype`` (float32) *here*, the
    pipeline's one explicit downcast point.
    """
    D = D.to(dtype)
    n = D.shape[-1]
    m = -(-n // block) * block
    if m == n:
        return D, n
    P = torch.full(D.shape[:-2] + (m, m), float("inf"), dtype=D.dtype,
                   device=D.device)
    P[..., :n, :n] = D
    P.diagonal(dim1=-2, dim2=-1).fill_(0.0)
    return P, n


# ---------------------------------------------------------------------------
# executor registry
# ---------------------------------------------------------------------------
_EXECUTORS: dict[tuple[str, str, str], Callable] = {}


def register_executor(kind: str, method: str, schedule: str = "dense", *,
                      chunks: bool = False):
    """Decorator: contribute the executor for one (kind, method, schedule)
    cell.  The callable receives ``(x, plan)`` with ``x`` one UNBATCHED
    item on the plan's device and owns the per-item pipeline: cast, pad,
    compute, slice, normalize.  ``chunks=True``: it also takes a (b, ...)
    chunk of items and runs it as one (the kernel cells: one launch per
    pass for the whole chunk), bitwise its items run one at a time."""

    def deco(fn):
        fn.chunks = chunks
        _EXECUTORS[(kind, method, schedule)] = fn
        return fn

    return deco


def _load_contributors() -> None:
    """Import the modules that register the default executors (deferred so
    importing the engine stays cheap and cycle-free)."""
    from repro_torch.core import pairwise, triplet  # noqa: F401
    from repro_torch.kernels import ops  # noqa: F401


def get_executor(kind: str, method: str, schedule: str) -> Callable:
    key = (kind, method, schedule)
    if key not in _EXECUTORS:
        _load_contributors()
    if key not in _EXECUTORS:
        raise KeyError(f"no executor registered for {key}; known cells: "
                       f"{sorted(_EXECUTORS)}")
    return _EXECUTORS[key]


def available_executors() -> list[tuple[str, str, str]]:
    """All registered (kind, method, schedule) cells (contributors loaded)."""
    _load_contributors()
    return sorted(_EXECUTORS)


def per_item(fn, *operands):
    """``fn`` over the leading item axis of (b, ...) operands (a None
    operand passes through), each item's result written into one (b, ...)
    output allocated at the first item: a chunk through code that takes
    one item (an executor, a plain version, a kernel entry without an
    item axis)."""
    out = None
    b = operands[0].shape[0]
    for i in range(b):
        r = fn(*(None if t is None else t[i] for t in operands))
        if out is None:
            out = r.new_empty((b,) + tuple(r.shape))
        out[i] = r
        del r
    return out


def whole_chunk(x: torch.Tensor, impl: str | None) -> bool:
    """Whether a (b, ...) chunk goes whole to the CUDA kernels (one launch
    a kernel): on a CUDA tensor unless ``impl="torch"``.  The plain
    versions take one item."""
    return x.device.type == "cuda" and impl != "torch"


def chunk_or_items(fn, x: torch.Tensor, impl: str | None) -> torch.Tensor:
    """``fn`` over one item ((n, n) or (n, d)) or a (b, ...) chunk: a chunk
    goes whole to the CUDA kernels (:func:`whole_chunk`), item by item to
    the plain versions, which take one item (``impl="torch"``, or a CPU
    tensor)."""
    if x.ndim == 2 or whole_chunk(x, impl):
        return fn(x)
    return per_item(fn, x)


def run_chunk(fn, xc, plan: "PaldPlan") -> torch.Tensor:
    """Executor ``fn`` over a (b, ...) chunk: in one call when it takes
    chunks, else item by item into the chunk's (b, n, n) output."""
    if getattr(fn, "chunks", False):
        return fn(xc, plan)
    return per_item(lambda xi: fn(xi, plan), xc)


def run_batched(fn, x, plan: "PaldPlan", batch: int | None = None):
    """The engine's batch layer: run executor ``fn`` over ``x``.

    2-D input goes straight through; a (B, ...) stack runs in chunks of
    ``min(batch, B)`` items (all B when ``batch`` is None), as the
    reference vmaps them.  A chunk is held and run together
    (:func:`run_chunk`), so its working buffers, and peak memory, grow
    with it, and the OOM retry of ``core/resilience`` has a bound to
    halve.  Chunking is a pure re-partition: any chunk size gives bitwise
    the same result.  Shared by ``PaldPlan.execute`` and the degradation
    chain's steps.
    """
    if x.ndim == 2:
        return fn(x, plan)
    B = x.shape[0]
    eff = max(1, B if batch is None else min(batch, B))
    _res.fault_point("engine.batch", batch=eff, n=plan.n, kind=plan.kind,
                     method=plan.method, impl=plan.impl)
    if eff >= B:
        if B == 0:
            return torch.empty((0, plan.n, plan.n), dtype=torch.float32,
                               device=x.device)
        return run_chunk(fn, x, plan)
    out = None
    for s in range(0, B, eff):
        part = run_chunk(fn, x[s:s + eff], plan)
        if out is None:
            out = part.new_empty((B,) + tuple(part.shape[1:]))
        out[s:s + part.shape[0]] = part
        del part
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PaldPlan:
    """Frozen result of one resolution pass: everything an executor needs.
    Build with ``plan(...)``; a plan is reusable for any input matching its
    item shape."""

    kind: str                     # "distance" | "features"
    method: str                   # "dense" | "pairwise" | "triplet" |
    #                               "kernel" | "knn" | "fused" (features)
    schedule: str                 # "dense" | "tri" (kernel only)
    impl: str | None              # kernel / fused impl ("cuda" | "torch");
    #                               None for the one-impl paths
    block: int | None             # None for the un-blocked dense method
    #                               and the fused kernels' fixed tiles
    block_z: int | None           # z tile; None = executor default
    z_chunk: int | None           # dense-method z streaming chunk
    ties: str                     # the weight functional's name
    normalize: bool
    batch: int | None             # chunk bound for batched input (None:
    #                               the whole batch in one chunk)
    check: bool                   # deep input validation on execute
    n: int                        # per-item point count
    device: torch.device
    weight: WeightFunctional | None = None
    method_source: str = "explicit"
    block_source: str = "explicit"
    metric: str | None = None     # features kind only
    d: int | None = None          # feature dimension (features kind)
    k: int | None = None          # neighborhood size (knn only)
    select: str | None = None     # knn selection impl ("cuda" |
    #                               "torch" | "chunked"); None follows impl
    select_block: int | None = None  # selection rows per slab (features
    #                                  knn; the plain version's)
    select_tile: int | None = None   # the plain selection's tile-min
    #                                  prefilter width (>= n: direct)
    select_source: str = "n/a"       # selection tiles' provenance
    on_error: str = "raise"       # "raise" | "fallback" (degradation chain)
    # mesh-sharded k-NN (features kind, core/distributed_knn.py): the
    # DeviceMesh the fused select->cohere pipeline shards over and the
    # resolved strategy ('allgather' / 'ring' / '2d'); None: one device
    mesh: Any = None
    strategy: str | None = None
    # degradation events appended by core/resilience under
    # on_error="fallback", surfaced by explain(); init=False keeps the
    # frozen plan replace()-safe: derived plans start with a fresh log
    # while the guard records on the plan the caller holds
    _events: list = dataclasses.field(
        default_factory=list, init=False, compare=False, repr=False)

    def execute(self, x) -> torch.Tensor:
        """Run the planned pipeline on ``x`` (numpy array or tensor), one
        item ((n, n) distances or (n, d) features) or a batch of them, on
        the plan's device.  A batch runs in chunks of up to ``batch``
        items, each held and run together.

        With ``on_error="fallback"`` a failing execution degrades instead
        of raising: an OOM of a batched call retries with ``batch`` halved
        (bitwise the same values), any other failure walks the cell's
        degradation chain (``core/resilience``) with the same ties and
        normalize; each degradation is recorded in
        ``explain()["degradations"]``.  A plan on the card keeps its
        kernels: there the chain's rungs are unavailable, and a failure
        the halving does not rescue ends in ``FallbackExhausted``.
        """
        x = torch.as_tensor(x, device=self.device)
        _check_input(x, self)
        if self.on_error == "fallback":
            return _res.execute_plan(self, x)
        _res.fault_point("engine.execute", kind=self.kind, method=self.method,
                         schedule=self.schedule, impl=self.impl)
        fn = get_executor(self.kind, self.method, self.schedule)
        return run_batched(fn, x, self, self.batch)

    # -- distributed shard-body primitives ---------------------------------
    # The shard bodies of core/distributed.py call the rectangular kernel
    # forms per step through the plan, so the resolution stays in one place
    def focus_general(self, DXZ, DYZ, DXY) -> torch.Tensor:
        """``ops.focus_general`` with the plan's tiles, impl and weight
        functional; under ``on_error="fallback"`` through
        ``resilience.guarded_general``."""
        from repro_torch.kernels import ops as _kops

        def call(impl):
            return _kops.focus_general(DXZ, DYZ, DXY, block=self.block,
                                       block_z=self.block_z, impl=impl,
                                       ties=self.weight)

        if self.on_error == "fallback":
            return _res.guarded_general(self, "focus_general", call)
        return call(self.impl)

    def cohesion_general(self, DXZ, DYZ, DXY, W, *, xwins=None,
                         xw_offsets=None) -> torch.Tensor:
        """``ops.cohesion_general`` as :meth:`focus_general` calls
        ``ops.focus_general``; ``xw_offsets`` = (the global row of DXZ's
        first row, the global index of DXY's first column) for the index
        tiebreak, or an explicit (mx, my) ``xwins``."""
        from repro_torch.kernels import ops as _kops

        def call(impl):
            return _kops.cohesion_general(DXZ, DYZ, DXY, W, block=self.block,
                                          block_z=self.block_z, impl=impl,
                                          ties=self.weight, xwins=xwins,
                                          xw_offsets=xw_offsets)

        if self.on_error == "fallback":
            return _res.guarded_general(self, "cohesion_general", call)
        return call(self.impl)

    @property
    def padded_n(self) -> int:
        """Per-item extent after the engine-level pad to a block multiple
        (the fused pipeline pads nothing)."""
        if self.block is None or self.method in ("fused", "knn"):
            return self.n
        return -(-self.n // self.block) * self.block

    def _shard_rows(self) -> int | None:
        """Per-shard padded row count of a mesh plan (None off the mesh)."""
        if self.mesh is None:
            return None
        from . import distributed_knn as _dknn

        p = int(np.prod(self.mesh.mesh.shape))
        _, _, m = _dknn.resolve_shard_shapes(self.n, p=p,
                                             chunk=self.select_block or 1)
        return m // p

    def _comm_estimate(self) -> dict | None:
        """Per-rank communication model of a mesh plan (None off the
        mesh)."""
        if self.mesh is None:
            return None
        from . import distributed_knn as _dknn

        shape = tuple(self.mesh.mesh.shape)
        p = int(np.prod(shape))
        pr = int(np.prod(shape[:-1])) if len(shape) >= 2 else 1
        return _dknn.comm_estimate(
            self.strategy or "auto", n=self.n, d=self.d or 1, k=self.k or 1,
            p=p, pr=pr, pc=shape[-1])

    def explain(self) -> dict[str, Any]:
        """The resolved plan as a plain dict (the debuggability surface);
        the mesh report ``mesh`` (shape) / ``mesh_axes`` / ``strategy`` /
        ``shard_rows`` / ``comm_estimate`` is None off the mesh."""
        fn = get_executor(self.kind, self.method, self.schedule)
        return {
            "kind": self.kind,
            "method": self.method,
            "schedule": self.schedule,
            "impl": self.impl,
            "device": str(self.device),
            "block": self.block,
            "block_z": self.block_z,
            "z_chunk": self.z_chunk,
            "ties": self.ties,
            "weight": self.weight.name if self.weight else self.ties,
            "weight_properties": (self.weight.properties()
                                  if self.weight else None),
            # the functor the CUDA kernels run: a built-in's id, or a user
            # functional's compiled key and its libraries built / reused
            "weight_kernel": (_build.kernel_info(self.weight)
                              if self.weight else None),
            "metric": self.metric,
            "normalize": self.normalize,
            "batch": self.batch,
            "n": self.n,
            "d": self.d,
            "padded_n": self.padded_n,
            "padded_shape": ((self.padded_n, self.padded_n)
                             if self.kind == "distance"
                             else (self.padded_n, self.d)),
            "k": self.k,
            "on_error": self.on_error,
            "select": self.select,
            "select_block": self.select_block,
            "select_tile": self.select_tile,
            "select_source": self.select_source,
            "mesh": (tuple(self.mesh.mesh.shape)
                     if self.mesh is not None else None),
            "mesh_axes": (tuple(self.mesh.mesh_dim_names)
                          if self.mesh is not None else None),
            "strategy": self.strategy,
            "shard_rows": self._shard_rows(),
            "comm_estimate": self._comm_estimate(),
            "method_source": self.method_source,
            "block_source": self.block_source,
            "executor": f"{fn.__module__}.{fn.__qualname__}",
            "est_smem_bytes_per_cta": _est_smem_per_cta(self),
            # the guard's events (cell / cause / error / fallback /
            # retries), in order; a copy, empty on a plan never degraded
            "degradations": list(self._events),
        }


def _est_smem_per_cta(p: PaldPlan) -> int | None:
    """Shared memory of one thread block of the method's CUDA kernels (the
    largest of them), the counterpart of the reference's VMEM-per-step
    estimate.  The kernel method reports the kernels of its schedule; the
    tri kernels' does not grow with n (the TPU's tri kernel holds an
    (n, block_z) slab).  The fused kernels stream the feature axis in
    chunks, so theirs does not grow with d; the k-NN kernels' grows with k
    (per-row best-lists of k entries, and each row's dn, W and idx).  None
    for the methods without kernels."""
    if p.method == "kernel":
        if p.schedule == "tri":
            from repro_torch.kernels import pald_cohesion_tri as coh
            from repro_torch.kernels import pald_focus_tri as foc
        else:
            from repro_torch.kernels import pald_cohesion as coh
            from repro_torch.kernels import pald_focus as foc
        return max(foc.SMEM_PER_CTA, coh.SMEM_PER_CTA)
    if p.method == "fused":
        from repro_torch.kernels.pald_fused import SMEM_PER_CTA

        return max(SMEM_PER_CTA.values())
    if p.method == "knn":
        from repro_torch.kernels import pald_knn, pald_topk

        est = pald_knn.smem_per_cta(p.k)
        if p.kind == "features":  # the streaming selection kernel too
            est = max(est, pald_topk.smem_per_cta(p.k))
        return est
    return None


# ---------------------------------------------------------------------------
# input validation
# ---------------------------------------------------------------------------
def _item_shape_checks(x, p: PaldPlan) -> None:
    if x.ndim not in (2, 3):
        what = ("D must be (n, n) or (B, n, n)" if p.kind == "distance"
                else "X must be (n, d) or (B, n, d)")
        raise ValueError(f"{what}, got shape {tuple(x.shape)}")
    if p.kind == "distance" and x.shape[-1] != x.shape[-2]:
        raise ValueError(
            f"distance matrix must be square, got shape {tuple(x.shape)}")
    expect = (p.n, p.n) if p.kind == "distance" else (p.n, p.d)
    if tuple(x.shape[-2:]) != expect:
        raise ValueError(
            f"input item shape {tuple(x.shape[-2:])} does not match the "
            f"plan's {expect}; build a new plan for a new problem size")


def _check_input(x, p: PaldPlan) -> None:
    """Cheap always-on checks plus the opt-in deep ones (``check=True``),
    all computed on the plan's device."""
    _item_shape_checks(x, p)
    if p.kind == "features":
        if p.check and not bool(torch.isfinite(x).all()):
            raise ValueError("features contain non-finite entries "
                             "(nan/inf); PaLD needs finite coordinates")
        return
    # always-on O(n) check: a nonzero (or nan) diagonal means the input is
    # not a self-distance matrix; every padding and focus invariant assumes
    # d(x, x) == 0
    diag = torch.diagonal(x, dim1=-2, dim2=-1)
    if not bool((diag == 0).all()):
        raise ValueError(
            "distance matrix diagonal must be exactly 0 "
            f"(got max |diag| = {float(diag.abs().nan_to_num(0.0).max())!r}; "
            "nan counts as nonzero); pass distances with d(x, x) = 0")
    if not p.check:
        return
    if not bool(torch.isfinite(x).all()):
        raise ValueError("distance matrix contains non-finite entries "
                         "(nan/inf)")
    if bool((x < 0).any()):
        raise ValueError("distance matrix contains negative entries; "
                         "PaLD consumes the order of nonnegative distances")
    if not torch.equal(x, x.transpose(-1, -2)):
        raise ValueError("distance matrix is not symmetric (exact equality "
                         "is required: PaLD compares d_xz against d_zx's "
                         "role symmetrically)")


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------
def _shape_of(x, n, d, kind):
    """The per-item (n, d) of the problem (d None for distances)."""
    if x is not None:
        shape = tuple(np.shape(x))
        if len(shape) not in (2, 3):
            what = ("D must be (n, n) or (B, n, n)" if kind == "distance"
                    else "X must be (n, d) or (B, n, d)")
            raise ValueError(f"{what}, got shape {shape}")
        if kind == "distance":
            if shape[-2] != shape[-1]:
                raise ValueError(
                    f"distance matrix must be square, got shape {shape}")
            return shape[-1], None
        return shape[-2], shape[-1]
    if n is None:
        raise ValueError("plan() needs either an input array or n=")
    if kind == "features" and d is None:
        raise ValueError("plan(kind='features') needs d= when no array "
                         "is given")
    return int(n), None if kind == "distance" else int(d)


def _resolve_weight_knob(ties, weight) -> WeightFunctional:
    """Resolve the ``ties=``/``weight=`` knob pair to ONE functional; both
    given and naming different functionals is a contradiction."""
    if weight is None:
        if ties is None:
            return resolve_weight(DEFAULT_TIES)
        validate_ties(ties)
        return resolve_weight(ties)
    w = resolve_weight(weight)
    if ties is not None:
        validate_ties(ties)
        tie_name = getattr(ties, "name", ties)
        if tie_name != w.name:
            raise ValueError(
                f"contradictory ties={tie_name!r} and weight={w.name!r}; "
                "ties= is sugar for the built-in modes — drop it, or pass "
                f"the matching one (registered weight functionals: "
                f"{registered_weights()})")
    return w


def plan(
    x=None,
    *,
    kind: str = "distance",
    n: int | None = None,
    d: int | None = None,
    method: str = "auto",
    schedule: str = "dense",
    block: int | str | None = None,
    block_z: int | str | None = None,
    z_chunk: int | None = None,
    metric: str | None = None,
    normalize: bool = True,
    impl: str | None = None,
    ties: str | None = None,
    weight=None,
    batch: int | None = None,
    check: bool = False,
    k: int | None = None,
    on_error: str = "raise",
    select: str | None = None,
    select_block: int | str | None = None,
    select_tile: int | str | None = None,
    mesh=None,
    strategy: str | None = None,
    device="cuda",
) -> PaldPlan:
    """Resolve every knob exactly once and return a frozen ``PaldPlan``.

    ``x`` (or ``n=``) fixes the per-item problem size.  The knobs mean what
    they mean in ``repro.core.engine.plan``; ``device`` ("cuda" by default,
    or "cpu") is where the plan runs, and ``impl`` ("cuda" or "torch", the
    kernel method only) defaults to the device's: the CUDA kernels on a
    GPU, the plain torch versions on the CPU.  ``impl="torch"`` on a GPU
    runs the plain versions there; ``impl="cuda"`` on the CPU goes through
    the kernel wrappers, which take the plain versions for CPU tensors.
    ``batch`` bounds the items of a batched input run together.
    ``on_error``: "raise" (default) propagates the first executor
    failure; "fallback" halves ``batch`` on OOM and, on the CPU, walks
    the cell's degradation chain (``core/resilience``), and records each
    degradation in ``explain()["degradations"]``.  ``select="chunked"`` (k-NN) is the
    chain's terminal selection rung, row-chunked stable sorts; on a
    distance matrix it is the only ``select`` value.  ``mesh=`` (a
    ``DeviceMesh``) / ``strategy=`` shard the features k-NN cell over the
    mesh's ranks (``core/distributed_knn.py``; 'allgather', 'ring' or
    '2d', 'auto'/None picking '2d' on a mesh of >= 2 dimensions, else
    'ring'); the result is bitwise the single-device one, and ``explain()``
    reports the mesh shape, per-shard rows and a per-rank comm estimate.

    Raises:
        RuntimeError: ``device="cuda"`` without a GPU.
        ValueError: contradictory or unknown knobs (a mesh off the
            features k-NN cell among them).
    """
    dev = resolve_device(device)
    weight = _resolve_weight_knob(ties, weight)
    ties = weight.name
    if kind not in ("distance", "features"):
        raise ValueError(f"unknown kind {kind!r} "
                         "(expected 'distance' or 'features')")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if on_error not in _res.ON_ERROR_MODES:
        raise ValueError(f"unknown on_error {on_error!r} (expected one of "
                         f"{_res.ON_ERROR_MODES}): 'raise' propagates the "
                         "first executor failure, 'fallback' walks the "
                         "degradation chain")
    # the tuning cache's backend: a record of another card (or of the CPU)
    # never steers this plan
    backend = _tuner.backend_of(dev)
    if kind == "distance" and d is not None:
        raise ValueError("d= only applies to kind='features'")
    n, d = _shape_of(x, n, d, kind)
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if kind == "features":
        from .features import METRICS

        metric = metric or "euclidean"
        if metric not in METRICS:
            raise ValueError(
                f"unknown metric {metric!r} (expected one of {METRICS})")
        allowed = FEATURE_METHODS
    else:
        if metric is not None:
            raise ValueError("metric= only applies to kind='features' "
                             "(a distance matrix already fixed it)")
        allowed = DISTANCE_METHODS

    # -- method ------------------------------------------------------------
    method_source = "explicit"
    if method == "auto":
        if schedule == "tri":
            # an explicit tri request pins the kernel pipeline (the only
            # method with a tri schedule)
            method, method_source = "kernel", "schedule=tri"
        elif k is not None:
            # a neighborhood size is a knn request on either kind: the
            # sparse approximation is opted into, never auto-selected
            if z_chunk is not None:
                raise ValueError(
                    "k= pins method='knn' but z_chunk= pins method='dense'; "
                    "pass an explicit method")
            method, method_source = "knn", "k"
        elif kind == "features":
            method, method_source = "fused", "default"
        elif z_chunk is not None:
            if impl is not None or block_z not in (None, "auto"):
                raise ValueError(
                    "z_chunk= pins method='dense' but impl=/block_z= pin "
                    "the kernel pipeline; pass an explicit method")
            method, method_source = "dense", "z_chunk"
        elif impl is not None or block_z not in (None, "auto"):
            # an explicit z tile (or impl) is a kernel-pipeline request;
            # block_z="auto" is not
            method, method_source = "kernel", "impl/block_z"
        else:
            # the measured crossover of this device, else the heuristic
            method, method_source = _tuner.method_for_ex(n, backend=backend)
    if method not in allowed:
        raise ValueError(f"unknown method {method!r} for kind={kind!r} "
                         f"(expected one of {('auto',) + allowed})")
    if schedule == "tri" and method != "kernel":
        raise ValueError(
            f"schedule='tri' is only available for method='kernel', got "
            f"method={method!r}; pass method='kernel' or drop schedule=")

    # -- neighborhood size and selection stage (knn only) -----------------
    if method == "knn":
        if k is None:
            raise ValueError(
                "method='knn' needs k= (neighborhood size, 1 <= k <= n-1); "
                "at k = n-1 the result equals the dense methods exactly")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        k = min(int(k), max(n - 1, 0))
    elif k is not None:
        raise ValueError(
            f"k= is only valid with method='knn' (got method={method!r}); "
            "the other methods rank every point against every other; drop "
            "k=, or pass method='knn'")
    if method != "knn" and (select is not None or select_block is not None
                            or select_tile is not None):
        raise ValueError(
            "select=/select_block=/select_tile= configure the knn neighbor "
            f"selection stage (got method={method!r}); drop them, or pass "
            "method='knn'")
    if select is not None:
        from repro_torch.kernels.ops import SELECTS

        if select not in SELECTS:
            raise ValueError(f"unknown select {select!r} (expected one of "
                             f"{SELECTS})")
    if kind == "distance" and (select not in (None, "chunked")
                               or select_block is not None
                               or select_tile is not None):
        raise ValueError(
            "select=/select_block=/select_tile= configure the streaming "
            "selection from "
            "features (kind='features'); a distance matrix is selected from "
            "by a stable sort of its rows, and only the row-chunked rung "
            "select='chunked' applies to it")

    # -- mesh sharding (features knn only) ----------------------------------
    if strategy is not None and mesh is None:
        raise ValueError(
            f"strategy={strategy!r} configures the mesh-sharded knn "
            "pipeline; pass mesh= (a torch.distributed DeviceMesh) "
            "alongside it")
    if mesh is not None:
        from . import distributed_knn as _dknn

        if kind != "features" or method != "knn":
            raise ValueError(
                "mesh= shards the fused select->cohere knn pipeline and "
                f"needs kind='features' with method='knn' (got kind={kind!r}"
                f", method={method!r}); drop mesh=, or pass k= to request "
                "the knn method on feature input")
        if batch is not None:
            raise ValueError(
                "mesh= plans run one item at a time (the device mesh is the "
                "parallel axis); drop batch=")
        if strategy is not None and strategy not in _dknn.STRATEGIES:
            raise ValueError(
                f"unknown strategy {strategy!r} (expected one of "
                f"{_dknn.STRATEGIES})")
        axes = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if not axes:
            raise ValueError("mesh= takes a DeviceMesh with named "
                             f"dimensions, got {type(mesh).__name__}")
        if strategy in (None, "auto"):
            strategy = "2d" if len(axes) >= 2 else "ring"
        if strategy == "2d" and len(axes) < 2:
            raise ValueError(
                "strategy='2d' needs a mesh with >= 2 axes (row x column "
                f"split), got axes={axes}; use 'ring' or 'allgather'")

    # -- impl --------------------------------------------------------------
    if method in _IMPL_METHODS:
        from repro_torch.kernels.ops import IMPLS, default_impl

        impl = impl or default_impl(dev)
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r} (expected one of "
                             f"{IMPLS})")
    elif impl is not None:
        raise ValueError(
            f"impl={impl!r} is only configurable for the kernel and fused "
            f"pipelines; method={method!r} has exactly one implementation")

    # -- per-method knob surface -------------------------------------------
    if z_chunk is not None and method != "dense":
        raise ValueError(
            f"z_chunk= only applies to method='dense', got method="
            f"{method!r}; drop z_chunk= or pass method='dense'")
    common = dict(kind=kind, method=method, schedule=schedule, impl=impl,
                  ties=ties, weight=weight, normalize=normalize, batch=batch,
                  check=check, n=n, device=dev, metric=metric, d=d,
                  method_source=method_source, on_error=on_error)
    if method == "dense":
        if block_z not in (None, "auto"):
            raise ValueError("block_z= does not apply to method='dense' "
                             "(it has no z tile; use z_chunk=)")
        return PaldPlan(block=None, block_z=None, z_chunk=z_chunk,
                        block_source="n/a", **common)
    if method in ("pairwise", "triplet"):
        if block_z not in (None, "auto"):
            raise ValueError(
                f"block_z= does not apply to method={method!r} (the "
                "blocked plain paths stream the full z axis per block pair)")
        # "auto" resolves to "no z tile" here: a resolution, not a dropped
        # knob (explain() shows block_z=None with no z provenance)
        block_z = None
    if method == "knn":
        if block_z not in (None, "auto"):
            raise ValueError(
                "block_z= does not apply to method='knn' (the third axis "
                "is the k neighbors themselves); block= sets the plain "
                "version's rows per chunk")
        block_z = None

    # -- tiles (the reference's resolution; the cache's impl is the one
    # that will run, the device's default on the methods without impl=)
    from repro_torch.kernels.ops import default_impl

    cache_impl = impl or default_impl(dev)
    block_source = "explicit"
    if block is None:
        block = "auto" if method in ("fused", "knn") else 128
        block_source = "default"
    if method == "knn":
        if block == "auto":
            block, _, block_source = _tuner.resolve_blocks_ex(
                n, "pald_knn", ties=weight, k=k, impl=impl, backend=backend)
        block = max(min(int(block), max(n, 1)), 1)
        sel_source = "n/a"
        sb = st = None
        if kind == "features":
            # the selection's tiles resolve here, once, so explain()
            # reports the slab and tile the executor runs
            sb = "auto" if select_block is None else select_block
            st = "auto" if select_tile is None else select_tile
            sel_source = "explicit"
            if sb == "auto" or st == "auto":
                rb, rt, sel_source = _tuner.resolve_blocks_ex(
                    n, "pald_topk", d=d, k=k, impl=(select or impl),
                    backend=backend,
                    p=(int(np.prod(mesh.mesh.shape)) if mesh is not None
                       else None))
                sb = rb if sb == "auto" else sb
                st = rt if st == "auto" else st
            sb = max(min(int(sb), max(n, 1)), 1)
            st = max(min(int(st), max(n, 1)), 1)
        return PaldPlan(block=block, block_z=None, z_chunk=None,
                        block_source=block_source, k=k, select=select,
                        select_block=sb, select_tile=st,
                        select_source=sel_source, mesh=mesh,
                        strategy=strategy if mesh is not None else None,
                        **common)
    if method == "fused":
        # one authority for the fused tiles, shared with ops.pald_fused;
        # the kernels' tiles are fixed, these set the plain versions'
        was_auto = block == "auto"
        block, block_z, src = _tuner.resolve_fused_tiles(
            n, d, block, block_z, impl=impl, backend=backend, ties=weight)
        if src is not None:
            # provenance tracks the block tile; an explicit block with an
            # auto block_z does not claim the cache chose the caller's tile
            block_source = src if was_auto else f"{block_source}; z:{src}"
    elif block == "auto" or block_z == "auto":
        pass_ = "pald_tri" if schedule == "tri" else "pald"
        rb, rbz, src = _tuner.resolve_blocks_ex(
            n, pass_, ties=weight, impl=cache_impl, backend=backend)
        block_source = src if block == "auto" else f"{block_source}; z:{src}"
        block = rb if block == "auto" else block
        if method == "kernel" and block_z in (None, "auto"):
            block_z = rbz
    return PaldPlan(block=int(block),
                    block_z=None if block_z is None else int(block_z),
                    z_chunk=None, block_source=block_source, **common)


def plan_local(
    n: int,
    *,
    impl: str | None = None,
    ties: str | None = None,
    weight=None,
    block: int | str = "auto",
    block_z: int | str = "auto",
    on_error: str = "raise",
    device="cuda",
) -> PaldPlan:
    """Plan for the rectangular per-rank bodies of ``core/distributed``.

    ``n`` is the per-rank row extent the tiles are keyed on (the
    ``cohesion`` pass of the tuning cache).  The shard bodies consume the
    plan through ``plan.focus_general`` / ``plan.cohesion_general``;
    ``impl=None`` takes the device's kernels (the CUDA kernels on the card,
    the plain versions on the CPU).
    """
    from repro_torch.kernels.ops import IMPLS, default_impl

    dev = resolve_device(device)
    weight = _resolve_weight_knob(ties, weight)
    if on_error not in _res.ON_ERROR_MODES:
        raise ValueError(f"unknown on_error {on_error!r} (expected one of "
                         f"{_res.ON_ERROR_MODES})")
    impl = impl or default_impl(dev)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    n = max(int(n), 1)
    block_source = "explicit"
    if block == "auto" or block_z == "auto":
        rb, rbz, block_source = _tuner.resolve_blocks_ex(
            n, "cohesion", impl=impl, backend=_tuner.backend_of(dev))
        block = rb if block == "auto" else block
        block_z = rbz if block_z == "auto" else block_z
    return PaldPlan(
        kind="distance", method="kernel", schedule="dense", impl=impl,
        block=int(block), block_z=int(block_z), z_chunk=None,
        ties=weight.name, weight=weight, normalize=False, batch=None,
        check=False, n=n, device=dev, on_error=on_error,
        method_source="shard-body", block_source=block_source)


# ---------------------------------------------------------------------------
# built-in executors: the features -> materialized-D compositions.  The
# fused path and the distance paths are contributed by their home modules;
# these cells are pure composition, so they live with the registry.
# ---------------------------------------------------------------------------
def _materialize_then(X, p: PaldPlan):
    """D from the features (each item of a chunk into one (b, n, n) D),
    then the distance executor of the same method."""
    from .features import cdist_reference

    fn = get_executor("distance", p.method, p.schedule)
    if X.ndim == 2:
        return fn(cdist_reference(X, metric=p.metric), p)
    D = torch.empty((X.shape[0], p.n, p.n), dtype=torch.float32,
                    device=X.device)
    for i, xi in enumerate(X):
        D[i] = cdist_reference(xi, metric=p.metric)
    return run_chunk(fn, D, p)


for _m in _MATERIALIZING:
    register_executor("features", _m, "dense", chunks=True)(_materialize_then)
register_executor("features", "kernel", "tri", chunks=True)(_materialize_then)
del _m
