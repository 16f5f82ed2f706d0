"""Guarded execution: degradation chains, OOM-aware retries, fault points
(counterpart of ``repro.core.resilience``).

Three public surfaces:

``on_error="raise" | "fallback"`` (a ``pald.plan`` knob)
    ``"raise"`` (the default) keeps the plain behavior: the first executor
    failure propagates unchanged.  ``"fallback"`` walks the DEGRADATION
    CHAIN of the plan's ``(kind, method, schedule)`` cell, re-executing
    with the same ``ties`` / ``normalize`` at every step: the other impls
    first (the CUDA kernels, then the plain torch versions), then the
    blocked methods on their plain torch versions, then the entry-wise
    numpy reference oracle.  The k-NN cells walk the impls and end on the
    ``select:chunked`` rung (row-chunked stable-sort selection feeding the
    plain values), never on a dense method: no other path shares their
    sparse semantics.

    A plan on the card keeps its kernels: a CUDA tensor never quietly runs
    a plain version or moves to the host.  There every rung that would
    (``impl:torch``, the ``method:`` rungs, ``select:chunked``,
    ``reference``) raises ``FallbackUnavailable``, so the walk ends in
    ``FallbackExhausted`` naming each of them; only the OOM halving of
    ``batch`` below rescues on the card.  A CPU plan walks the full chain.

OOM-aware batching
    In fallback mode an out-of-memory failure of a batched call
    (``torch.cuda.OutOfMemoryError``, ``MemoryError`` or a message that
    says so) is retried with ``batch`` halved, down to 1, before the chain
    is touched: re-chunking is a pure re-partition, so the values are
    bitwise the same.  Only the failure's message is kept: its traceback
    holds the failed chunk's tensors, and the retry must not run beside
    them.

Degradation events
    Every retry and every rung taken appends an event dict (cell, cause,
    error, fallback, retries) to the plan, surfaced by
    ``plan.explain()["degradations"]``, and warns a
    ``DegradationWarning`` once per cause.

A sticky CUDA error (an illegal address, a launch failure, a device-side
assert) leaves the process's CUDA context unusable: no rung on the card
can run after it, so the walk stops there and raises ``FallbackExhausted``
chained from it.  What the guard rescues on the card: a
``torch.cuda.OutOfMemoryError`` of a batched call, by halving ``batch``
(the kernels run on).  Every other failure there (a kernel library that
fails to build or load, a wrapper's ``ValueError`` or
``NotImplementedError``, an OOM at ``batch=1``) ends in
``FallbackExhausted`` chained from it.

A mesh-sharded k-NN plan (``mesh=``) walks ``mesh:single-device`` first:
the single-device fused select->cohere pipeline on the rank's own device,
bitwise the sharded answer by construction (the kernels run; it is kept on
the card too).  ``guarded_general`` guards the rectangular kernel calls of
the distributed shard bodies (``PaldPlan.focus_general`` /
``cohesion_general``) the same way, over the impls only.

The FAULT POINTS at the bottom are named call sites threaded through the
engine, the kernel entry points and the feature front-end; each is a
no-op until ``repro_torch.testing.faults`` arms a ``FaultRule``.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import traceback
import warnings
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "ON_ERROR_MODES",
    "DegradationWarning",
    "FallbackExhausted",
    "FallbackUnavailable",
    "FaultRule",
    "Step",
    "arm",
    "disarm",
    "fault_point",
    "is_oom",
    "is_sticky",
    "simulated_oom",
    "chain_for",
    "register_chain",
    "execute_plan",
    "guarded_general",
    "warn_once",
    "reset_warnings",
]

ON_ERROR_MODES = ("raise", "fallback")

# impl preference order of the walk; the plan's own (failed) impl is
# skipped, and "cuda" on a CPU plan
IMPL_ORDER = ("cuda", "torch")
# the largest n the numpy reference rung takes: its oracle is a Python loop
# over pairs (8 s at n = 256 on one CPU core, growing as n^3), which past
# this would hold the call for minutes to hours instead of failing
REFERENCE_MAX_N = 512


class DegradationWarning(UserWarning):
    """A guarded execution degraded (a rung taken, or batch halved)."""


class FallbackExhausted(RuntimeError):
    """Every step of a degradation chain failed (``on_error="fallback"``
    only); chained from the original executor failure."""


class FallbackUnavailable(RuntimeError):
    """A chain step cannot run in this context; counted as a failed step,
    and the walk continues."""


# ---------------------------------------------------------------------------
# failure classes
# ---------------------------------------------------------------------------
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory",
                "OutOfMemory")
_OOM_TYPES = (MemoryError, torch.cuda.OutOfMemoryError)


def is_oom(exc: BaseException) -> bool:
    """Is this a memory-exhaustion failure?  ``torch.cuda.OutOfMemoryError``
    ("CUDA out of memory. Tried to allocate ..."), ``MemoryError``, or a
    message with one of the reference's markers (``simulated_oom``)."""
    if isinstance(exc, _OOM_TYPES):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(marker in text for marker in _OOM_MARKERS)


# the CUDA runtime's sticky errors, by message and by code (a kernel
# wrapper's "CUDA error <code>"): illegal address 700, assert 710, hardware
# stack 714, illegal instruction 715, misaligned address 716, invalid
# address space 717, invalid pc 718, launch failure 719
_STICKY_MARKERS = ("illegal memory access", "unspecified launch failure",
                   "illegal instruction", "misaligned address",
                   "device-side assert", "invalid program counter",
                   "hardware stack error", "invalid address space")
_STICKY_CODES = {700, 710, 714, 715, 716, 717, 718, 719}


def is_sticky(exc: BaseException) -> bool:
    """Is this a sticky CUDA error, after which no work on the card can
    run in this process?"""
    text = str(exc)
    if any(marker in text for marker in _STICKY_MARKERS):
        return True
    return any(int(c) in _STICKY_CODES
               for c in re.findall(r"CUDA error (\d+)", text))


def simulated_oom(detail: str = "simulated") -> RuntimeError:
    """An exception that ``is_oom`` recognizes, for fault injection."""
    return RuntimeError(f"RESOURCE_EXHAUSTED: out of memory ({detail})")


def _describe(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"


# ---------------------------------------------------------------------------
# once-per-cause warnings
# ---------------------------------------------------------------------------
_WARNED: set = set()
_WARN_LOCK = threading.Lock()


def warn_once(key, message: str) -> None:
    """``warnings.warn(DegradationWarning)`` at most once per ``key``: a
    degraded serving path re-executes the same rung per request, and the
    log should name the failure class once."""
    with _WARN_LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    warnings.warn(message, DegradationWarning, stacklevel=3)


def reset_warnings() -> None:
    """Forget which causes already warned (test isolation)."""
    with _WARN_LOCK:
        _WARNED.clear()


def _event(*, cell, cause: str, error: str | None, fallback: str | None,
           retries: int, **extra) -> dict:
    evt = {"cell": tuple(cell), "cause": cause, "error": error,
           "fallback": fallback, "retries": retries}
    evt.update(extra)
    return evt


# ---------------------------------------------------------------------------
# degradation chains
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Step:
    """One rung of a degradation chain.  ``run(x, plan, batch)`` re-executes
    the plan's computation with the same ties / normalize; ``batch`` is
    the (possibly already halved) chunk bound."""

    label: str
    run: Callable[[Any, Any, Any], Any]


_CHAINS: dict[tuple, list] = {}  # (kind, method, schedule) -> [Step, ...]


def register_chain(kind: str, method: str, schedule: str,
                   steps: list) -> None:
    """Override the degradation chain of one (kind, method, schedule)
    cell; the default chains cover every built-in cell."""
    _CHAINS[(kind, method, schedule)] = list(steps)


def _dispatch_derived(derived_plan, x, batch):
    """Run a derived plan through the engine's batch layer."""
    from repro_torch.core import engine as _engine

    fn = _engine.get_executor(derived_plan.kind, derived_plan.method,
                              derived_plan.schedule)
    return _engine.run_batched(fn, x, derived_plan, batch)


def _impl_step(impl: str) -> Step:
    def run(x, plan, batch):
        fault_point("resilience.step", step=f"impl:{impl}", kind=plan.kind,
                    method=plan.method, schedule=plan.schedule, impl=impl)
        return _dispatch_derived(
            dataclasses.replace(plan, impl=impl, mesh=None, strategy=None),
            x, batch)

    return Step(f"impl:{impl}", run)


def _method_step(method: str) -> Step:
    """A blocked method; it runs on a CPU plan only (on the card the
    triplet executor would take the tri kernels again), so on its plain
    torch versions."""
    def run(x, plan, batch):
        fault_point("resilience.step", step=f"method:{method}",
                    kind=plan.kind, method=method, schedule="dense",
                    impl=None)
        block = plan.block if isinstance(plan.block, int) else 128
        derived = dataclasses.replace(
            plan, method=method, schedule="dense", impl=None,
            block=None if method == "dense" else block,
            block_z=None, z_chunk=None)
        return _dispatch_derived(derived, x, batch)

    return Step(f"method:{method}", run)


def _select_step() -> Step:
    """Terminal rung of the k-NN cells: the row-chunked selection
    (``ops.topk_select(impl="chunked")``, each slab's distances, a stable
    sort, synced before the next slab) feeding the plain values."""
    def run(x, plan, batch):
        fault_point("resilience.step", step="select:chunked", kind=plan.kind,
                    method=plan.method, schedule=plan.schedule, impl="torch")
        derived = dataclasses.replace(plan, impl="torch", select="chunked",
                                      mesh=None, strategy=None)
        return _dispatch_derived(derived, x, batch)

    return Step("select:chunked", run)


def _mesh_off_step() -> Step:
    """First rung of a mesh-sharded k-NN plan: the single-device fused
    select->cohere pipeline, same impl and tiles, on the rank's device.
    The sharded bodies are bitwise the single-device kernels by
    construction, so dropping the mesh costs locality and time, never
    values."""
    def run(x, plan, batch):
        fault_point("resilience.step", step="mesh:single-device",
                    kind=plan.kind, method=plan.method,
                    schedule=plan.schedule, impl=plan.impl)
        derived = dataclasses.replace(plan, mesh=None, strategy=None)
        return _dispatch_derived(derived, x, batch)

    return Step("mesh:single-device", run)


def _reference_step() -> Step:
    def run(x, plan, batch):
        fault_point("resilience.step", step="reference", kind=plan.kind,
                    method=plan.method, schedule=plan.schedule, impl=None)
        if plan.n > REFERENCE_MAX_N:
            raise FallbackUnavailable(
                f"the numpy reference oracle is an O(n^3) Python loop; "
                f"n={plan.n} is past its REFERENCE_MAX_N={REFERENCE_MAX_N}")
        from repro_torch.core import reference as _reference
        from repro_torch.core.weights import TIE_MODES

        # the numpy oracle speaks the built-in tie modes; any other
        # functional ends on the un-blocked torch oracle (kernels/ref.py)
        # with the SAME functional: a rescue never changes the algebra
        builtin = plan.ties in TIE_MODES

        def one(xi):
            if plan.kind == "features":
                from repro_torch.core.features import cdist_reference

                Di = cdist_reference(xi, metric=plan.metric)
            else:
                Di = xi.to(torch.float32)
            if builtin:
                C = _reference.pald_pairwise_reference(
                    Di.cpu().numpy(), ties=plan.ties,
                    normalize=plan.normalize)
                return torch.as_tensor(np.asarray(C, np.float32),
                                       device=xi.device)
            from repro_torch.kernels import ref as _ref

            U = _ref.focus_ref(Di, ties=plan.weight)
            C = _ref.cohesion_ref(Di, _ref.weights_ref(U), ties=plan.weight)
            if plan.normalize:
                C = C / max(Di.shape[0] - 1, 1)
            return C

        return one(x) if x.ndim == 2 else torch.stack([one(xi) for xi in x])

    return Step("reference", run)


def _kept_off_card(label: str) -> Step:
    """A rung past the kernels on a plan whose device is the card:
    unavailable, since it would run plain torch on the card or copy the
    input to the host."""
    def run(x, plan, batch):
        raise FallbackUnavailable(
            f"{label} would leave the CUDA kernels; a plan on the card keeps "
            "them (only the OOM halving of batch rescues there)")

    return Step(label, run)


def _default_chain(plan) -> list:
    """cuda -> torch -> the blocked methods on plain torch -> reference.

    The plan's own (failed) impl is skipped, as is ``cuda`` on a CPU plan.
    The k-NN cells walk the impls and end on ``select:chunked``, never on
    a dense method: no other path shares their sparse O(n k^2) semantics,
    and answering with the exact dense result would change the cost by
    orders of magnitude, and below k = n-1 the values.  On a card plan
    every rung but ``impl:cuda`` is unavailable (:func:`_kept_off_card`).
    """
    steps = _full_chain(plan)
    if plan.device.type != "cuda":
        return steps
    return [s if s.label in _ON_CARD else _kept_off_card(s.label)
            for s in steps]


# the rungs that keep the kernels on the card
_ON_CARD = ("impl:cuda", "mesh:single-device")


def _full_chain(plan) -> list:
    steps: list[Step] = []
    if getattr(plan, "mesh", None) is not None:
        # a failed mesh cell rescues onto one device first: same impl,
        # same tiles, the same answer, no collectives in the way
        steps.append(_mesh_off_step())
    if plan.method in ("kernel", "fused", "knn"):
        for impl in IMPL_ORDER:
            if impl == plan.impl:
                continue
            if impl == "cuda" and plan.device.type != "cuda":
                continue
            steps.append(_impl_step(impl))
        if plan.method == "kernel":
            steps.append(_method_step("triplet"))
            steps.append(_method_step("dense"))
        elif plan.method == "fused":
            steps.append(_method_step("dense"))
        elif not (plan.impl == "torch" and plan.select == "chunked"):
            steps.append(_select_step())
    elif plan.method in ("pairwise", "triplet"):
        steps.append(_method_step("dense"))
    if plan.method != "knn":
        steps.append(_reference_step())
    return steps


def chain_for(plan) -> list:
    """The degradation chain of a plan's cell: a registered override if
    one exists, else the default built from the cell's method."""
    key = (plan.kind, plan.method, plan.schedule)
    if key in _CHAINS:
        return list(_CHAINS[key])
    return _default_chain(plan)


# ---------------------------------------------------------------------------
# guarded execution (the on_error="fallback" path of PaldPlan.execute)
# ---------------------------------------------------------------------------
def _forget_frames(exc: BaseException) -> None:
    """Drop the locals of the finished frames on ``exc``'s traceback (and
    its context's): a failed chunk's tensors are freed while the error,
    its message and line numbers, are kept."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__


def _run_with_oom_retries(run, x, plan, batch, cell):
    """Call ``run(x, batch)``, halving ``batch`` on OOM down to 1.

    Returns (result, batch), so the walk keeps the halved bound.  A
    failure that is not an OOM, an OOM at the floor and an OOM on
    unbatched input propagate.  The retry runs outside the ``except``
    block, with the failed attempt's frames cleared (only the message
    survives it) and, on the card, its cached blocks handed back, so the
    retry starts from unsplit memory.
    """
    while True:
        failure = None
        try:
            return run(x, batch), batch
        except Exception as exc:  # noqa: BLE001 - the guard's whole job
            if not is_oom(exc) or x.ndim != 3:
                raise
            _forget_frames(exc)
            failure = exc
        if x.device.type == "cuda":
            torch.cuda.empty_cache()
        current = batch if batch is not None else int(x.shape[0])
        if current <= 1:
            plan._events.append(_event(
                cell=cell, cause="oom-floor", error=_describe(failure),
                fallback=None, retries=0, batch=1))
            warn_once(("oom-floor", cell),
                      f"PaLD {cell}: still out of memory at the batch "
                      "retry floor (batch=1); walking the degradation chain")
            raise failure
        message = _describe(failure)
        del failure
        batch = max(current // 2, 1)
        plan._events.append(_event(cell=cell, cause="oom", error=message,
                                   fallback=None, retries=1, batch=batch))
        warn_once(("oom", cell),
                  f"PaLD {cell}: out of memory on the batched call; "
                  f"retrying with batch={batch}")


def _exhausted(cell, original, attempts, note=""):
    tried = ", ".join(f"{label}: {type(e).__name__}" for label, e in attempts)
    return FallbackExhausted(
        f"every fallback failed for cell {cell}: primary raised "
        f"{_describe(original)}; degradation chain attempted [{tried}]"
        f"{note}")


_STICKY_NOTE = ("; stopped at a sticky CUDA error: the process's CUDA "
                "context is unusable, so no rung on the card can run")


def execute_plan(plan, x):
    """The fallback-mode execution behind ``PaldPlan.execute``.

    The primary attempt first (with OOM-aware batch halving), then the
    degradation chain, each step under the same OOM guard.  The first
    step that succeeds records a degradation event and returns; a sticky
    CUDA error or exhaustion raises ``FallbackExhausted`` chained from the
    original failure.
    """
    from repro_torch.core import engine as _engine

    cell = (plan.kind, plan.method, plan.schedule)
    batch = plan.batch

    def primary(xi, b):
        fault_point("engine.execute", kind=plan.kind, method=plan.method,
                    schedule=plan.schedule, impl=plan.impl)
        fn = _engine.get_executor(*cell)
        return _engine.run_batched(fn, xi, plan, b)

    try:
        result, _ = _run_with_oom_retries(primary, x, plan, batch, cell)
        return result
    except Exception as exc:  # noqa: BLE001 - the guard's whole job
        _forget_frames(exc)
        original = exc

    attempts: list[tuple[str, BaseException]] = [
        (f"primary({plan.impl or plan.method})", original)]
    if is_sticky(original):
        raise _exhausted(cell, original, attempts,
                         _STICKY_NOTE) from original
    for step in chain_for(plan):
        try:
            result, batch = _run_with_oom_retries(
                lambda xi, b, s=step: s.run(xi, plan, b), x, plan, batch,
                cell)
        except Exception as step_exc:  # noqa: BLE001
            _forget_frames(step_exc)
            attempts.append((step.label, step_exc))
            if is_sticky(step_exc):
                raise _exhausted(cell, original, attempts,
                                 _STICKY_NOTE) from original
            continue
        extra = {}
        if getattr(plan, "mesh", None) is not None:
            # which mesh cell failed: explain()["degradations"] pins the
            # rescue to a (mesh shape, strategy) pair
            extra["mesh"] = tuple(plan.mesh.mesh.shape)
            extra["strategy"] = plan.strategy
        plan._events.append(_event(
            cell=cell, cause="executor-failure", error=_describe(original),
            fallback=step.label, retries=len(attempts), **extra))
        warn_once(("fallback", cell, step.label),
                  f"PaLD {cell}: primary executor failed "
                  f"({_describe(original)}); degraded to {step.label}: "
                  "results keep identical ties/normalize semantics")
        return result
    raise _exhausted(cell, original, attempts) from original


# ---------------------------------------------------------------------------
# guarded rectangular primitives (the distributed shard-body consumer)
# ---------------------------------------------------------------------------
def guarded_general(plan, what: str, call: Callable[[str], Any]):
    """Impl-degradation guard of ``plan.focus_general`` /
    ``cohesion_general`` (``what``): ``call(impl)`` with the plan's impl,
    then with each other impl of ``IMPL_ORDER`` (``cuda`` only on a card
    plan).  On the card the ``impl:torch`` rung is unavailable (it would
    run plain torch there), so a failure of the kernels ends in
    ``FallbackExhausted``, as the single-device chains do; a sticky CUDA
    error stops the walk.  The reference oracle is not in this chain: a
    shard body's rectangular call has no square D to hand it.  Each rescue
    appends an event (cause ``<what>-failure``) to the plan.

    A rank's failure is its own: the distributed entry points that need
    their ranks to agree (``core/distributed_knn.py``) check for a failure
    on any rank after the body, so no rank waits in a collective for a
    peer that gave up.
    """
    cell = (plan.kind, plan.method, plan.schedule)
    try:
        return call(plan.impl)
    except Exception as exc:  # noqa: BLE001 - the guard's whole job
        _forget_frames(exc)
        original = exc
    attempts: list[tuple[str, BaseException]] = [(f"impl:{plan.impl}",
                                                  original)]
    if is_sticky(original):
        raise _exhausted(cell, original, attempts, _STICKY_NOTE) from original
    for impl in IMPL_ORDER:
        if impl == plan.impl:
            continue
        if impl == "cuda" and plan.device.type != "cuda":
            continue
        try:
            if plan.device.type == "cuda" and impl != "cuda":
                raise FallbackUnavailable(
                    f"impl:{impl} would leave the CUDA kernels; a plan on "
                    "the card keeps them")
            result = call(impl)
        except Exception as step_exc:  # noqa: BLE001
            _forget_frames(step_exc)
            attempts.append((f"impl:{impl}", step_exc))
            if is_sticky(step_exc):
                raise _exhausted(cell, original, attempts,
                                 _STICKY_NOTE) from original
            continue
        plan._events.append(_event(
            cell=cell, cause=f"{what}-failure", error=_describe(original),
            fallback=f"impl:{impl}", retries=len(attempts)))
        warn_once((what, cell, impl),
                  f"PaLD shard body {what}: impl {plan.impl!r} failed "
                  f"({_describe(original)}); degraded to impl={impl!r}")
        return result
    raise _exhausted(cell, original, attempts) from original


# ---------------------------------------------------------------------------
# fault points (the injection substrate; armed by repro_torch.testing.faults)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FaultRule:
    """One armed fault.  Matching is AND over the given criteria:

    ``site``   substring of the fault-point name ("" matches all);
    ``match``  exact equality on context kwargs (e.g. impl="cuda");
    ``pred``   a predicate over (site=..., **ctx);
    ``nth``    1-based matching-call index at which tripping starts;
    ``times``  most trips (None = every matching call).

    ``exc`` is a zero-arg factory, so each trip raises a fresh exception.
    """

    exc: Callable[[], BaseException]
    site: str = ""
    match: dict | None = None
    pred: Callable[..., bool] | None = None
    nth: int = 1
    times: int | None = None
    calls: int = 0
    trips: int = 0


_RULES: list[FaultRule] = []
_RULES_LOCK = threading.Lock()


def arm(rule: FaultRule) -> FaultRule:
    with _RULES_LOCK:
        _RULES.append(rule)
    return rule


def disarm(rule: FaultRule) -> None:
    with _RULES_LOCK:
        if rule in _RULES:
            _RULES.remove(rule)


def fault_point(site: str, **ctx) -> None:
    """A named injection site, inert until a ``FaultRule`` is armed (one
    empty-list check); a matching rule raises its exception here, as a
    real failure at the site would."""
    if not _RULES:
        return
    with _RULES_LOCK:
        rules = list(_RULES)
    for rule in rules:
        if rule.site and rule.site not in site:
            continue
        if rule.match and any(ctx.get(k) != v for k, v in rule.match.items()):
            continue
        if rule.pred is not None and not rule.pred(site=site, **ctx):
            continue
        rule.calls += 1
        if rule.calls < rule.nth:
            continue
        if rule.times is not None and rule.trips >= rule.times:
            continue
        rule.trips += 1
        raise rule.exc()
