"""Local ``torch.distributed`` worlds on one machine: p ranks, each a spawned
process with the same device (the tests, the self-test, the tuner's mesh
cell and the smoke run the distributed modules through it).

    from repro_torch.testing.world import MeshSpec, World

    with World(4, device="cpu") as w:                 # gloo, 4 ranks
        C = w.run("repro_torch.core.distributed:pald_distributed", D,
                  MeshSpec((2, 2), ("data", "model")), strategy="2d",
                  device="cpu")[0]                    # rank 0's result

``World.run(target, *args, **kwargs)`` calls ``target`` (a function, or
"module:name") in every rank with the same arguments, SPMD, and returns
the ranks' results in rank order, tensors as numpy arrays.  A
:class:`MeshSpec` argument becomes the rank's ``DeviceMesh``
(``launch.mesh.make_test_mesh``, made once per shape in every rank);
``faults=`` arms fault rules (``testing.faults.failing`` keyword
dictionaries) inside every rank for the call, since a rule armed in the
calling process does not reach the ranks.  A call waits at most its
``deadline`` seconds; a rank that raised fails the call with
:class:`WorldError` (every rank's error in ``.errors``), a rank that died
or a call past its deadline stops the world and raises.

Each world has its own ``file://`` store in a temporary directory, so
concurrent worlds never contend for a port.  Ranks start with the
``spawn`` method (a process that has loaded JAX must not fork) and run
``torch.set_num_threads(threads)``.  ``World(1, spawn=False)`` is a world
of the calling process alone (no child; a call raises its own error), for
plans and single-rank meshes; it tears its process group down on close.
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any

from repro_torch.launch.mesh import MeshSpec

__all__ = ["MeshSpec", "World", "WorldError", "run_world", "execute_plan",
           "explain_plan", "on_rank"]


class WorldError(RuntimeError):
    """A call failed in one or more ranks; ``errors`` maps each failing
    rank to its error (type, message and traceback), ``results`` holds the
    others' results."""

    def __init__(self, errors: dict, results: dict):
        self.errors, self.results = errors, results
        first = min(errors)
        super().__init__(
            f"{len(errors)} of {len(errors) + len(results)} ranks failed; "
            f"rank {first}: {errors[first]}")


def _resolve(target):
    if callable(target):
        return target
    module, _, name = target.partition(":")
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _to_host(obj):
    """Tensors as numpy arrays (on the host), through tuples, lists and
    dicts (named tuples keep their type)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _materialize(obj, meshes: dict):
    if isinstance(obj, MeshSpec):
        key = (tuple(obj.shape), tuple(obj.axes))
        if key not in meshes:
            from repro_torch.launch.mesh import make_test_mesh

            meshes[key] = make_test_mesh(*key)
        return meshes[key]
    return obj


@contextlib.contextmanager
def _armed(rules):
    from repro_torch.testing import faults

    with contextlib.ExitStack() as stack:
        for rule in rules or ():
            stack.enter_context(faults.failing(**rule))
        yield


def _describe(exc: BaseException) -> str:
    return "".join(traceback.format_exception(exc)).strip()


def _call(job, meshes):
    target, args, kwargs, rules = job
    fn = _resolve(target)
    args = tuple(_materialize(a, meshes) for a in args)
    kwargs = {k: _materialize(v, meshes) for k, v in kwargs.items()}
    with _armed(rules):
        return fn(*args, **kwargs)


def _init(rank, p, init, backend, device, timeout, threads):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=p,
                            timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank, p, init, backend, device, timeout, threads, jobs,
               results):
    """A rank: join the world, then run each job in turn until None."""
    try:
        _init(rank, p, init, backend, device, timeout, threads)
    except BaseException as exc:  # noqa: BLE001 - reported to the caller
        results.put((-1, rank, False, _describe(exc)))
        return
    results.put((-1, rank, True, None))
    meshes: dict = {}
    while True:
        item = jobs.get()
        if item is None:
            break
        jid, job = item
        try:
            results.put((jid, rank, True, _to_host(_call(job, meshes))))
        except BaseException as exc:  # noqa: BLE001 - reported
            results.put((jid, rank, False, _describe(exc)))
    import torch.distributed as dist

    meshes.clear()
    dist.destroy_process_group()


class World:
    """p ranks of one ``torch.distributed`` world (module docstring).

    ``device``: "cpu" or "cuda" (every rank on the card ``rank %
    device_count``: one card is shared); ``backend``: "gloo" (default) or
    "nccl" (one rank a card); ``timeout``: seconds a collective waits,
    and a call's default deadline.
    """

    def __init__(self, p: int, *, device: str = "cpu",
                 backend: str = "gloo", timeout: float = 120.0,
                 threads: int = 1, spawn: bool = True):
        if p < 1:
            raise ValueError(f"a world needs p >= 1 ranks, got {p}")
        if not spawn and p != 1:
            raise ValueError("a world without spawned ranks has one rank")
        self.p, self.device, self.backend = p, device, backend
        self.timeout, self.threads, self.spawn = timeout, threads, spawn
        self._procs, self._jobs, self._results = [], [], None
        self._dir, self._next, self._meshes = None, 0, {}
        self.exitcodes: list = []  # each rank process's, after close()

    # -- lifetime ------------------------------------------------------------
    def start(self) -> "World":
        self._dir = tempfile.mkdtemp(prefix="repro_torch_world_")
        init = "file://" + os.path.join(self._dir, "store")
        if not self.spawn:
            _init(0, 1, init, self.backend, self.device, self.timeout,
                  self.threads)
            return self
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        for rank in range(self.p):
            jobs = ctx.Queue()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, self.p, init, self.backend, self.device,
                      self.timeout, self.threads, jobs, self._results))
            proc.start()
            self._jobs.append(jobs)
            self._procs.append(proc)
        try:
            self._collect(-1, self.timeout)
        except BaseException:
            self.close()
            raise
        return self

    def close(self) -> None:
        """Stop every rank (a clean exit, else terminated after a few
        seconds; :attr:`exitcodes` then holds each rank's exit code, 0 for
        a clean one) and remove the store."""
        if not self.spawn and self._dir is not None:
            import torch.distributed as dist

            self._meshes.clear()
            if dist.is_initialized():
                dist.destroy_process_group()
        for jobs, proc in zip(self._jobs, self._procs):
            if proc.is_alive():
                with contextlib.suppress(Exception):
                    jobs.put(None)
        end = time.monotonic() + 10.0
        for proc in self._procs:
            proc.join(max(end - time.monotonic(), 0.1))
            if proc.is_alive():
                proc.terminate()
                proc.join(5.0)
        if self._procs:
            self.exitcodes = [proc.exitcode for proc in self._procs]
        self._procs, self._jobs = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "World":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- calls ---------------------------------------------------------------
    def run(self, target, *args, faults=None, deadline: float | None = None,
            **kwargs) -> list:
        """``target(*args, **kwargs)`` in every rank; the results in rank
        order.  Raises :class:`WorldError` if any rank raised, and
        ``TimeoutError`` (the world stopped) past ``deadline`` seconds
        (default: the world's timeout)."""
        job = (target, args, kwargs, list(faults or ()))
        if not self.spawn:  # the caller's own process: its own error
            return [_to_host(_call(job, self._meshes))]
        jid, self._next = self._next, self._next + 1
        for jobs in self._jobs:
            jobs.put((jid, job))
        return self._collect(jid, self.timeout if deadline is None
                             else deadline)

    def _collect(self, jid: int, deadline: float) -> list:
        end = time.monotonic() + deadline
        got, errors = {}, {}
        while len(got) + len(errors) < self.p:
            try:
                rjid, rank, ok, value = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, proc in enumerate(self._procs)
                        if not proc.is_alive()]
                if dead:
                    self.close()
                    raise WorldError({r: "rank process died" for r in dead},
                                     got)
                if time.monotonic() > end:
                    self.close()
                    raise TimeoutError(
                        f"world of {self.p} ranks: call {jid} outlived its "
                        f"deadline of {deadline:.0f} s; the world was "
                        "stopped")
                continue
            if rjid != jid:
                continue
            (got if ok else errors)[rank] = value
        if errors:
            raise WorldError(errors, got)
        return [got[r] for r in range(self.p)]


def run_world(p: int, target, args=(), kwargs=None, *, device: str = "cpu",
              backend: str = "gloo", timeout: float = 600.0) -> list:
    """Start a world of p ranks on ``device``, run ``target(*args,
    **kwargs)`` in it (:meth:`World.run`), stop it."""
    with World(p, device=device, backend=backend, timeout=timeout) as w:
        return w.run(target, *args, **(kwargs or {}))


def on_rank(rank: int, rules, target, *args, **kwargs) -> str:
    """A job: ``target(*args, **kwargs)`` with the fault ``rules`` armed
    on ``rank`` alone; every rank returns "ok" or its error as "Type:
    message" (how a failure of one rank reaches the others)."""
    import torch.distributed as dist

    try:
        with _armed(rules if dist.get_rank() == rank else ()):
            _resolve(target)(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - the job reports it
        return f"{type(exc).__name__}: {exc}"
    return "ok"


def explain_plan(x, **plan_kwargs) -> dict:
    """A job: ``pald.plan(x, **plan_kwargs).explain()`` (a plan on a mesh
    does not leave its rank)."""
    from repro_torch.core import pald

    info = pald.plan(x, **plan_kwargs).explain()
    info.pop("weight_properties", None)
    return info


def execute_plan(x, *, returns: str = "C", **plan_kwargs) -> Any:
    """A job: ``pald.plan(x, **plan_kwargs).execute(x)``; ``returns``
    "C", or "C+explain" for (C, the plan's ``explain()`` after the call:
    its degradation events)."""
    from repro_torch.core import pald

    p = pald.plan(x, **plan_kwargs)
    C = p.execute(x)
    if returns == "C+explain":
        info = p.explain()
        info.pop("weight_properties", None)
        return C, info
    return C
