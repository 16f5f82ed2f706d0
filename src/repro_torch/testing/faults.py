"""Fault-injection harness for the guarded-execution layer (counterpart of
``repro.testing.faults``).

Context managers that arm the named fault points threaded through the
engine dispatch, the kernel entry points and the feature front-end
(``repro_torch.core.resilience.fault_point``), plus the tuning cache's
corruption and locking helpers.  Each fault manager yields the armed
``FaultRule``, so a test can read ``rule.trips`` afterwards; disarming is
exception-safe.

    from repro_torch.testing import faults

    with faults.failing("engine.execute"):
        pald.cohesion(D, on_error="fallback")       # the chain rescues it

    with faults.fail_kernel(impl="cuda"):
        ...                                          # every CUDA call dies

    with faults.simulate_oom(max_batch=2):
        plan.execute(Db)                             # halves batch to 2

    with faults.corrupt_tuning_cache(path):
        pald.plan(n=256, device="cpu")               # quarantine, not crash

Injection sites (substring-matched): ``engine.execute`` (the primary
dispatch, both modes), ``engine.batch`` (the batch layer, with the chunk
size as ``batch=``), ``ops.focus_general`` / ``ops.cohesion_general`` /
``ops.pald_tri`` / ``ops.pald_fused`` / ``ops.knn_values`` /
``ops.topk_select`` / ``ops.select_cohere`` (the kernel entry points, with
the *resolved* ``impl=``, "cuda" or "torch"), ``features.cdist`` (the
materialize-D front-end), ``resilience.step`` (each rung), and the sharded
k-NN pipeline's ``distributed_knn.dispatch`` (before any collective, with
``strategy=``, ``p=``, ``k=``, ``metric=``) and ``distributed_knn.body``
(the shard bodies, with ``strategy=``, ``p=`` and the mesh shape as
``mesh=``).  The cache helpers act on the port's tuning cache
(``repro_torch.tuning.autotune``, ``$REPRO_TORCH_TUNE_CACHE``).

A rule armed here lives in this process only.  The ranks of a
distributed run are processes of their own: a rule reaches them as the
keyword dictionary of :func:`failing` (``site``, ``match``, ``nth``,
``times``, and an exception class as ``exc``), handed to
``testing.world.World.run(..., faults=[...])``, which arms it inside every
rank for the call.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Iterator

from repro_torch.core import resilience as _res
from repro_torch.core.resilience import FaultRule, simulated_oom

__all__ = ["failing", "fail_kernel", "simulate_oom", "reset",
           "corrupt_tuning_cache", "locked_tuning_cache", "write_cache"]


def reset() -> None:
    """Fresh harness state: disarm every rule, forget warn-once keys."""
    with _res._RULES_LOCK:
        _res._RULES.clear()
    _res.reset_warnings()


@contextlib.contextmanager
def failing(
    site: str = "",
    *,
    exc: Callable[[], BaseException] | None = None,
    match: dict | None = None,
    pred: Callable[..., bool] | None = None,
    nth: int = 1,
    times: int | None = None,
) -> Iterator[FaultRule]:
    """Arm one fault rule for the ``with`` body.

    ``site`` substring-matches the fault-point name ("" = every site);
    ``match`` requires exact equality on context kwargs (e.g.
    ``impl="cuda"``); ``pred`` is a predicate over ``(site=..., **ctx)``;
    ``nth`` is the 1-based matching call at which tripping starts;
    ``times`` caps the trips (None = every matching call).  ``exc`` is a
    zero-arg exception factory (default: a RuntimeError naming the site).
    """
    if exc is None:
        def exc(s=site):  # noqa: E731 - default factory names the site
            return RuntimeError(f"injected fault at {s or '<any site>'}")
    rule = _res.arm(FaultRule(exc=exc, site=site, match=match, pred=pred,
                              nth=nth, times=times))
    try:
        yield rule
    finally:
        _res.disarm(rule)


@contextlib.contextmanager
def fail_kernel(
    impl: str | None = None,
    *,
    nth: int = 1,
    times: int | None = None,
    exc: Callable[[], BaseException] | None = None,
) -> Iterator[FaultRule]:
    """Make the Nth kernel entry-point call raise.

    Matches every ``ops.*`` fault point; ``impl=`` narrows it to one
    backend: the sites report the *resolved* impl, so ``impl="cuda"``
    faults exactly the calls a dead kernel library would kill while the
    plain torch rungs run clean.
    """
    match = None if impl is None else {"impl": impl}
    with failing("ops.", exc=exc, match=match, nth=nth, times=times) as rule:
        yield rule


@contextlib.contextmanager
def simulate_oom(
    site: str = "engine.batch",
    *,
    max_batch: int | None = None,
    nth: int = 1,
    times: int | None = None,
) -> Iterator[FaultRule]:
    """Raise an out-of-memory error (``simulated_oom``) at ``site``.

    With ``max_batch=``, only batched calls whose chunk exceeds it trip:
    a device that fits ``max_batch`` items, so the guard's halving
    converges on a chunk it accepts.
    """
    pred = None
    if max_batch is not None:
        def pred(site, batch=None, **ctx):  # noqa: A002 - fault-point ctx
            return batch is not None and batch > max_batch
    with failing(site, exc=simulated_oom, pred=pred, nth=nth,
                 times=times) as rule:
        yield rule


@contextlib.contextmanager
def corrupt_tuning_cache(
    path: str | None = None,
    garbage: str = '{"cpu|cuda|1024|pald": {"block": 256, "bl',
) -> Iterator[str]:
    """Replace the tuning cache file with garbled bytes for the body.

    The default garbage is a truncated JSON object, the kill-the-writer
    corruption.  On exit the original file (if any) is restored, the
    quarantine files the body left are removed, and the in-memory memo is
    dropped both ways so the corruption is actually read.  Yields the
    cache path."""
    from repro_torch.tuning import autotune as _tuner

    p = os.path.abspath(_tuner.cache_path(path))
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    original = None
    if os.path.exists(p):
        with open(p) as f:
            original = f.read()
    with open(p, "w") as f:
        f.write(garbage)
    _tuner._MEM.pop(p, None)
    try:
        yield p
    finally:
        _tuner._MEM.pop(p, None)
        _tuner._QUARANTINE_WARNED.discard(p)
        for name in os.listdir(os.path.dirname(p)):
            full = os.path.join(os.path.dirname(p), name)
            if full.startswith(p + ".corrupt-"):
                os.remove(full)
        if original is None:
            if os.path.exists(p):
                os.remove(p)
        else:
            with open(p, "w") as f:
                f.write(original)


@contextlib.contextmanager
def locked_tuning_cache(path: str | None = None) -> Iterator[str]:
    """Hold the exclusive ``save_entry`` lock for the body: a concurrent
    ``save_entry`` on the same cache waits, or past its ``lock_timeout``
    warns and writes unlocked.  A plain yield without fcntl."""
    from repro_torch.tuning import autotune as _tuner

    p = os.path.abspath(_tuner.cache_path(path))
    if _tuner.fcntl is None:  # pragma: no cover - non-POSIX platform
        yield p
        return
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p + ".lock", "w") as lf:
        _tuner.fcntl.flock(lf, _tuner.fcntl.LOCK_EX)
        try:
            yield p
        finally:
            _tuner.fcntl.flock(lf, _tuner.fcntl.LOCK_UN)


def write_cache(path: str, records: dict) -> str:
    """Write a well-formed cache file of ``records`` (a test fixture)."""
    p = os.path.abspath(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "w") as f:
        json.dump(records, f, indent=1, sort_keys=True)
    return p
