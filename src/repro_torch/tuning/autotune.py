"""Candidate-grid block-size autotuner with a persistent JSON cache
(counterpart of ``repro.tuning.autotune``).

* a JSON on-disk cache keyed ``backend|impl|n|pass`` holding the
  measured-best ``(block, block_z)`` plus the full timing grid, in the
  reference's schema;
* ``resolve_blocks_ex`` / ``resolve_blocks``: the cheap consumer behind
  ``block="auto"`` in ``core.engine`` and ``kernels.ops``: exact cache hit,
  else nearest-n hit (log-space) for the same key prefix, else a size-aware
  default.  Never measures.
* ``tune``: the producer, times a candidate grid for one ``(n, pass,
  impl)`` cell and records the winner (``python -m
  repro_torch.tuning.hillclimb blocks``).
* ``tune_methods`` / ``method_for_ex``: the measured method crossover
  (dense / pairwise / triplet) that ``method="auto"`` reads before the
  ``n <= 256`` heuristic.

What differs from the reference:

* ``backend`` is the CUDA device's name (``torch.cuda.get_device_name``,
  e.g. ``NVIDIA H100 80GB HBM3``) or ``"cpu"``, so a record measured on
  one card never steers another.  The functions take a ``device`` (default
  "cuda", which needs a GPU) where the reference reads JAX's backend.
* ``impl`` is the port's: ``"cuda"`` (the hand-written kernels) or
  ``"torch"`` (the plain versions); the method record uses ``"-"``.
* The file is the port's own: ``$REPRO_TORCH_TUNE_CACHE``, else
  ``~/.cache/repro_pald_torch/blocktune.json``.  The reference's
  ``cpu|-|n|method`` records (its jnp timings) never steer the port.
* The CUDA kernels' tiles are fixed (64 x 64), so on ``impl="cuda"``
  ``block`` acts only through the engine's +inf pad of D to a multiple of
  ``block`` (``pald`` / ``pald_tri``), and every other pass's grid
  collapses to one candidate, the size-aware default.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
import warnings
from typing import Iterable, Sequence

import numpy as np
import torch

try:  # POSIX only; the save lock degrades to plain atomic writes without it
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platform
    fcntl = None

_CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
_MEM: dict[str, tuple[float, dict]] = {}  # abspath -> (mtime, data)
_QUARANTINE_WARNED: set[str] = set()  # abspaths that already warned

# passes understood by `tune`; each maps to one kernel-pipeline entry point
PASSES = ("focus", "cohesion", "focus_tri", "cohesion_tri", "pald",
          "pald_tri", "pald_fused", "pald_knn", "pald_topk")
# the passes whose tiles the CUDA kernels ignore (fixed tiles, P from the
# panel budget, rows a block from k): one candidate on impl="cuda"
_FIXED_ON_CUDA = ("focus", "cohesion", "focus_tri", "cohesion_tri",
                  "pald_fused", "pald_knn", "pald_topk")

# the three built-in tie modes (core/weights.TIE_MODES; copied so this
# module imports nothing of the package at import time)
_TIE_MODES = ("drop", "split", "ignore")


def _pass_key(pass_: str, d: int | None, ties=None,
              k: int | None = None, p: int | None = None) -> str:
    """The pass part of a key, as the reference builds it: ``:d<d>`` for
    the fused pass, ``:k<k>`` for the sparse knn pass, ``:t-<mode>`` /
    ``:w-<name>`` for a functional other than ``drop``; the selection pass
    is ``pald_topk:k<k>:d<d>`` with no ties part and ``:p<p>`` for a
    mesh of p > 1 devices."""
    if pass_ == "pald_topk":
        if k is not None:
            pass_ = f"{pass_}:k{int(k)}"
        if d is not None:
            pass_ = f"{pass_}:d{int(d)}"
        if p is not None and int(p) > 1:
            pass_ = f"{pass_}:p{int(p)}"
        return pass_
    if d is not None:
        pass_ = f"{pass_}:d{int(d)}"
    if k is not None:
        pass_ = f"{pass_}:k{int(k)}"
    name = getattr(ties, "name", ties)
    if name and name != "drop":
        tag = "t-" if name in _TIE_MODES else "w-"
        pass_ = f"{pass_}:{tag}{name}"
    return pass_


def cache_path(path: str | None = None) -> str:
    if path:
        return path
    env = os.environ.get(_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro_pald_torch", "blocktune.json")


def _key(backend: str, impl: str, n: int, pass_: str) -> str:
    return f"{backend}|{impl}|{int(n)}|{pass_}"


def _split_key(key: str) -> tuple[str, str, int, str]:
    backend, impl, n, pass_ = key.split("|")
    return backend, impl, int(n), pass_


def _quarantine(p: str, exc: Exception) -> str | None:
    """Move a corrupt cache aside to ``<path>.corrupt-<ts>`` and warn once
    per path; the path starts fresh."""
    dest = f"{p}.corrupt-{time.strftime('%Y%m%dT%H%M%S')}"
    try:
        os.replace(p, dest)
    except OSError:  # a racing writer already replaced it; nothing to move
        dest = None
    if p not in _QUARANTINE_WARNED:
        _QUARANTINE_WARNED.add(p)
        where = f"; corrupt file preserved at {dest}" if dest else ""
        warnings.warn(
            f"tuning cache {p} is corrupt ({type(exc).__name__}: {exc}); "
            f"starting a fresh cache{where}", stacklevel=3)
    return dest


def _read_cache_file(p: str) -> dict:
    """One fresh read of the cache file (no mtime memo): {} when missing,
    quarantine + {} when corrupt."""
    try:
        with open(p) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(
                f"expected a JSON object of records, got "
                f"{type(data).__name__}")
    except OSError:
        return {}
    except ValueError as exc:
        _quarantine(p, exc)
        return {}
    return data


def load_cache(path: str | None = None) -> dict:
    """The cache's records, re-read only when the file's mtime moved (one
    ``stat`` a call otherwise)."""
    p = os.path.abspath(cache_path(path))
    try:
        mtime = os.path.getmtime(p)
    except OSError:
        return {}
    hit = _MEM.get(p)
    if hit and hit[0] == mtime:
        return hit[1]
    data = _read_cache_file(p)
    try:  # the quarantine may have moved the file away
        _MEM[p] = (os.path.getmtime(p), data)
    except OSError:
        _MEM.pop(p, None)
    return data


@contextlib.contextmanager
def _save_lock(p: str, timeout: float):
    """Exclusive advisory lock on ``<path>.lock`` for the save cycle.

    Yields True when the lock is held.  Without fcntl, or once ``timeout``
    expires, the save proceeds unlocked with a warning: losing a peer's
    concurrent entry beats deadlocking the tuner.  The sidecar is locked,
    never the data file, so the atomic ``os.replace`` of the data never
    invalidates anyone's lock."""
    if fcntl is None:
        yield False
        return
    with open(p + ".lock", "w") as lf:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(lf, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    warnings.warn(
                        f"could not lock tuning cache {p} within {timeout}s; "
                        "saving without the lock (a concurrent writer's "
                        "entry may be lost)", stacklevel=4)
                    yield False
                    return
                time.sleep(0.02)
        try:
            yield True
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def save_entry(backend: str, impl: str, n: int, pass_: str, record: dict,
               path: str | None = None, *, lock_timeout: float = 10.0) -> str:
    """Merge one record into the cache (atomic write); returns the key.
    The read-modify-write runs under the lock and re-reads the file inside
    it, so concurrent tuners merge instead of losing each other's rows."""
    p = os.path.abspath(cache_path(path))
    key = _key(backend, impl, n, pass_)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with _save_lock(p, lock_timeout):
        data = _read_cache_file(p)  # fresh under the lock: merge, not clobber
        data[key] = record
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
    _MEM[p] = (os.path.getmtime(p), data)
    return key


def lookup(backend: str, impl: str, n: int, pass_: str,
           path: str | None = None) -> dict | None:
    return load_cache(path).get(_key(backend, impl, n, pass_))


def lookup_nearest(backend: str, impl: str, n: int, pass_: str,
                   path: str | None = None) -> tuple[int, dict] | None:
    """Nearest-n cache entry (log-space, unbounded) for the same
    (backend, impl, pass)."""
    best = None
    for key, rec in load_cache(path).items():
        try:
            b, i, kn, kp = _split_key(key)
        except ValueError:
            continue
        if (b, i, kp) != (backend, impl, pass_) or kn <= 0:
            continue
        dist = abs(np.log(kn) - np.log(max(n, 1)))
        if best is None or dist < best[0]:
            best = (dist, kn, rec)
    if best is None:
        return None
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend_of(device=None) -> str:
    """The cache's backend for a device: the CUDA device's name, or
    ``"cpu"``.  ``device`` defaults to "cuda", which needs a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' "
                         "or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA GPU is available; pass "
            "device='cpu' to tune or look up the CPU's records")
    return _device_name(torch.cuda.current_device() if dev.index is None
                        else dev.index)


def _default_impl(backend: str) -> str:
    return "torch" if backend == "cpu" else "cuda"


def _valid_tile(v) -> bool:
    """A usable cached tile: an integral number > 0 (bool excluded).  A
    hand-edited or bit-flipped cache degrades to defaults at lookup, never
    raises mid-``plan()``."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return False
    return float(v) == int(v) and int(v) > 0


def _default_blocks(n: int, pass_: str) -> tuple[int, int]:
    """The size-aware defaults of a cold cache, the reference's: (128,
    512) clamped to n; cohesion_tri's z tile shrinks with n (the TPU
    kernel's 6 MiB slab budget, kept for the same keys); the selection
    pass takes 1024-row slabs and tile = n, the direct strategy."""
    if pass_ == "pald_topk":
        return max(min(1024, n), 1), max(n, 1)
    block = min(128, n)
    block_z = min(512, n)
    if pass_ == "cohesion_tri" and n > 0:
        block_z = min(block_z, max((6 << 20) // (4 * n), 8))
    return max(block, 1), max(block_z, 1)


def resolve_blocks_ex(
    n: int,
    pass_: str,
    *,
    impl: str | None = None,
    backend: str | None = None,
    device=None,
    path: str | None = None,
    d: int | None = None,
    ties=None,
    k: int | None = None,
    p: int | None = None,
) -> tuple[int, int, str]:
    """(block, block_z, source) for one pass at size n.

    ``source``: ``"cache:<key>"`` exact hit, ``"nearest:<key>"`` nearest-n
    hit, ``"quarantined:<key>"`` a record with unusable tiles (the defaults
    are returned), ``"default"`` cold cache.  The mesh cell (``p``) misses
    to the functional's cell, which misses to the strict single-device
    cell, before the defaults.  ``backend`` defaults to ``device``'s."""
    backend = backend or backend_of(device)
    impl = impl or _default_impl(backend)
    base = _pass_key(pass_, d, k=k)
    keyed = _pass_key(pass_, d, ties, k=k)
    meshed = _pass_key(pass_, d, ties, k=k, p=p)
    quarantined = None
    for pk in dict.fromkeys((meshed, keyed, base)):
        rec = lookup(backend, impl, n, pk, path)
        key = _key(backend, impl, n, pk)
        source = f"cache:{key}"
        if rec is None:
            near = lookup_nearest(backend, impl, n, pk, path)
            if near:
                rec = near[1]
                key = _key(backend, impl, near[0], pk)
                source = f"nearest:{key}"
        if isinstance(rec, dict) and "block" in rec:
            bz_rec = rec.get("block_z", rec["block"])
            if _valid_tile(rec["block"]) and _valid_tile(bz_rec):
                return (max(min(int(rec["block"]), n), 1),
                        max(min(int(bz_rec), n), 1),
                        source)
            quarantined = quarantined or f"quarantined:{key}"
        elif rec is not None:
            quarantined = quarantined or f"quarantined:{key}"
    b, bz = _default_blocks(n, pass_)
    return b, bz, quarantined or "default"


def resolve_blocks(n: int, pass_: str, **kwargs) -> tuple[int, int]:
    """(block, block_z) of :func:`resolve_blocks_ex`, without the source."""
    b, bz, _ = resolve_blocks_ex(n, pass_, **kwargs)
    return b, bz


def resolve_fused_tiles(
    n: int,
    d: int,
    block,
    block_z,
    *,
    impl: str | None = None,
    backend: str | None = None,
    device=None,
    ties=None,
    path: str | None = None,
) -> tuple[int, int, str | None]:
    """The fused pipeline's tiles, in one place for ``engine.plan`` and
    ``kernels.ops.pald_fused``: ``block_z=None`` rides along with
    ``block`` ("auto" together, else 512); "auto" resolves under the
    ``pald_fused:d<d>`` pass; both clamp to n.  Returns (block, block_z,
    source), source None when both tiles were explicit.  On the CUDA
    kernels the tiles are fixed; these set the plain versions' chunks."""
    if block_z is None:
        block_z = "auto" if block == "auto" else 512
    source = None
    if block == "auto" or block_z == "auto":
        rb, rbz, source = resolve_blocks_ex(
            n, "pald_fused", impl=impl, backend=backend, device=device, d=d,
            ties=ties, path=path)
        block = rb if block == "auto" else block
        block_z = rbz if block_z == "auto" else block_z
    return min(int(block), n), min(int(block_z), n), source


# ---------------------------------------------------------------------------
# measurement (producer side)
# ---------------------------------------------------------------------------
def _sync(out) -> None:
    """Wait for the card's work behind ``out`` (a tensor or a tuple of
    them); CPU results are ready when returned."""
    ts = out if isinstance(out, (tuple, list)) else (out,)
    for t in ts:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, each ended by ``torch.cuda.synchronize`` when its output is
    on the card."""
    for _ in range(warmup):
        _sync(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def random_distance_matrix(n: int, seed: int = 0, dim: int = 8) -> np.ndarray:
    """Euclidean distances of gaussian points (tie-free w.h.p.), the
    reference's numpy construction ((n, n, dim) on the host: small n)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)).astype(np.float32)
    np.fill_diagonal(D, 0.0)
    return D


def random_features(n: int, d: int = 8, seed: int = 0) -> np.ndarray:
    """Gaussian feature matrix (the fused and selection passes' input)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _synthetic_inputs(n: int, seed: int = 0, with_weights: bool = False,
                      d: int = 8, with_distances: bool = True,
                      device="cuda", impl: str | None = None):
    """(D, W, X) measurement inputs on ``device``: X from
    :func:`random_features`, D its euclidean distances computed there
    (``features.cdist_reference``; no host array of n^2 entries), W = 1/U
    only for the passes that read it."""
    from repro_torch.core.features import cdist_reference

    X = torch.from_numpy(random_features(n, d, seed)).to(device)
    if not with_distances:
        return None, None, X
    D = cdist_reference(X, metric="euclidean")
    W = None
    if with_weights:
        from repro_torch.kernels import ops, ref
        W = ref.weights_ref(ops.focus(D, impl=impl))
    return D, W, X


def _runner(pass_: str, D, W, X, block: int, block_z: int, impl: str,
            ties="drop", k: int | None = None, mesh=None):
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    if mesh is not None:
        # the mesh cell: the sharded select->cohere itself on a p-rank row
        # shard, block and tile meaning what pald_knn_sharded reads them as
        from repro_torch.core import distributed_knn as dknn

        return dknn.pald_knn_sharded(X, mesh, k=k or 16, block=block,
                                     tile=block_z, impl=impl,
                                     device=X.device)[1]
    if pass_ in ("pald", "pald_tri"):
        # what a plan runs: the engine's +inf pad to a multiple of block,
        # then the pipeline (kernels/ops.py::_kernel_exec); on the CUDA
        # kernels the pad is all that block changes
        Dp, n0 = engine.pad_distance_matrix(D, block)
        nv = n0 if Dp.shape[-1] != n0 else None
        pipeline = ops.pald_tri if pass_ == "pald_tri" else ops.pald
        return pipeline(Dp, block=block, block_z=block_z, n_valid=nv,
                        impl=impl, ties=ties)
    if pass_ == "pald_knn":
        return ops.pald_knn(D, k=k or 16, block=block, impl=impl,
                            ties=ties)[1]
    if pass_ == "pald_topk":
        # block = rows per slab, block_z = the tile-min prefilter's width
        # (>= n: direct)
        return ops.topk_select(X, k or 16, impl=impl, block=block,
                               tile=block_z).distances
    if pass_ == "focus":
        return ops.focus_general(D, D, D, block=block, block_z=block_z,
                                 impl=impl, ties=ties)
    if pass_ == "focus_tri":
        return ops.focus(D, block=block, block_z=block_z, impl=impl,
                         schedule="tri", ties=ties)
    if pass_ == "cohesion":
        return ops.cohesion_from_weights(D, W, block=block, block_z=block_z,
                                         impl=impl, ties=ties)
    if pass_ == "cohesion_tri":
        return ops.cohesion_from_weights(D, W, block=block, block_z=block_z,
                                         impl=impl, schedule="tri", ties=ties)
    if pass_ == "pald_fused":
        return ops.pald_fused(X, block=block, block_z=block_z, impl=impl,
                              ties=ties)
    raise ValueError(f"unknown pass {pass_!r} (expected one of {PASSES})")


def _mesh_cell(p: int, pass_: str):
    """The (p,) ("data",) mesh of a p > 1 selection cell, over the current
    world (every rank calls ``tune``)."""
    import torch.distributed as dist

    if pass_ != "pald_topk":
        raise ValueError(
            f"p= (mesh device count) only keys the selection pass "
            f"(pald_topk), not {pass_!r}")
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != p:
        raise RuntimeError(
            f"tuning the p={p} mesh cell needs a torch.distributed world "
            f"of {p} ranks, every rank calling tune(); have {have} "
            f"(`python -m repro_torch.tuning.hillclimb topk --p {p}` starts "
            "a local one)")
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh((p,), ("data",))


def tune(
    n: int,
    pass_: str,
    *,
    impl: str | None = None,
    backend: str | None = None,
    device="cuda",
    blocks: Iterable[int] = (32, 64, 128, 256, 512),
    blocks_z: Iterable[int] = (128, 256, 512, 1024),
    path: str | None = None,
    save: bool = True,
    seed: int = 0,
    iters: int = 3,
    d: int | None = None,
    ties="drop",
    k: int | None = None,
    p: int | None = None,
    time_budget: float | None = None,
) -> dict:
    """Measure the candidate grid for one (n, pass, impl) cell on
    ``device`` and record the argmin; returns the record that was (or
    would be) cached.

    Keys and grids as the reference's: ``pald_fused`` keys on ``d``
    (default 8), ``pald_knn`` on ``k`` (default 16, no z axis),
    ``pald_topk`` on ``k`` and ``d`` with its own default grid (row slabs
    against the prefilter's tile, a tile >= n being direct); a non-default
    ``ties`` has its own cell.  With ``p`` > 1 the cell is the mesh cell
    (``pald_topk`` only; key ``pald_topk:k<k>:d<d>:p<p>``): every rank of a
    world of p ranks calls ``tune``, the candidates time the sharded
    select->cohere (``core/distributed_knn.py``) on a (p,) mesh, the
    ranks agree on the time budget, and rank 0 saves the record.  On
    ``impl="cuda"`` the kernels' tiles are
    fixed: ``pald`` / ``pald_tri`` sweep ``blocks`` (the engine's pad)
    with the default z tile, and every other pass times one candidate,
    the size-aware default (``"fixed_tiles": true`` in the record).  Rows
    of ``pald`` / ``pald_tri`` carry the ``padded_n`` they ran.

    Each candidate is guarded: a failing one records ``{"failed": True,
    "error": ...}`` and the grid goes on; past ``time_budget`` wall
    seconds (checked between candidates) the rest record ``{"skipped":
    "over-budget"}``.  RuntimeError if every candidate failed.

    Raises:
        ValueError: an unknown pass, or ``p`` > 1 off ``pald_topk``.
        RuntimeError: ``p`` > 1 outside a world of p ranks.
    """
    if pass_ not in PASSES:
        raise ValueError(f"unknown pass {pass_!r} (expected one of {PASSES})")
    from repro_torch.core.engine import resolve_device

    mesh = _mesh_cell(int(p), pass_) if p is not None and p > 1 else None
    dev = resolve_device(device)
    backend = backend or backend_of(dev)
    impl = impl or _default_impl(backend)
    if pass_ in ("pald_fused", "pald_topk") and d is None:
        d = 8
    if pass_ == "pald_knn":
        k = k or 16
        blocks_z = (0,)  # no z tile: don't re-time identical cells
    if pass_ == "pald_topk":
        k = k or 16
        blocks = tuple(blocks) if tuple(blocks) != (32, 64, 128, 256, 512) \
            else (256, 512, 1024, 2048)
        blocks_z = tuple(blocks_z) if tuple(blocks_z) != (128, 256, 512, 1024) \
            else (32, 64, 128, n)
    fixed = impl == "cuda" and pass_ in _FIXED_ON_CUDA
    if impl == "cuda":
        db, dbz = _default_blocks(n, pass_)
        blocks_z = (0,) if pass_ == "pald_knn" else (dbz,)
        if fixed:
            blocks = (db,)
    D, W, X = _synthetic_inputs(
        n, seed, with_weights=pass_ in ("cohesion", "cohesion_tri"),
        d=d if d is not None else 8,
        with_distances=pass_ not in ("pald_fused", "pald_topk"),
        device=dev, impl=impl)
    rows = []
    t0 = time.monotonic()
    over_budget = False
    for b in sorted({min(b, n) for b in blocks}):
        for bz in sorted({min(z, n) for z in blocks_z}):
            row = {"block": b, "block_z": bz}
            if pass_ in ("pald", "pald_tri"):
                row["padded_n"] = -(-n // b) * b
            if mesh is not None:  # every rank runs the same candidates
                from repro_torch.core.distributed import _any

                over_budget = _any(over_budget, mesh, dev)
            if over_budget:
                rows.append({**row, "skipped": "over-budget"})
                continue
            try:
                t = time_fn(
                    lambda: _runner(pass_, D, W, X, b, bz, impl, ties, k,
                                    mesh),
                    iters=iters)
            except Exception as exc:  # noqa: BLE001 - one bad candidate
                rows.append({**row, "failed": True,
                             "error": f"{type(exc).__name__}: {exc}"})
            else:
                rows.append({**row, "seconds": round(t, 6)})
            if time_budget is not None and time.monotonic() - t0 > time_budget:
                over_budget = True
    ok = [r for r in rows if "seconds" in r]
    if not ok:
        raise RuntimeError(
            f"every candidate failed for (n={n}, pass={pass_!r}, "
            f"impl={impl!r}); first error: "
            f"{next(r['error'] for r in rows if r.get('failed'))}")
    best = min(ok, key=lambda r: r["seconds"])
    record = {
        "block": best["block"],
        "block_z": best["block_z"],
        "seconds": best["seconds"],
        "grid": rows,
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    if fixed:
        record["fixed_tiles"] = True
    if mesh is not None:
        import torch.distributed as dist

        save = save and dist.get_rank() == 0  # one writer for the world
    if save:
        save_entry(backend, impl, n,
                   _pass_key(pass_,
                             d if pass_ in ("pald_fused", "pald_topk")
                             else None,
                             None if pass_ == "pald_topk" else ties,
                             k=k if pass_ in ("pald_knn", "pald_topk")
                             else None,
                             p=p if mesh is not None else None),
                   record, path)
    return record


# ---------------------------------------------------------------------------
# method crossovers (dense / pairwise / triplet / kernel)
# ---------------------------------------------------------------------------
_METHOD_IMPL = "-"  # methods span impls; keyed under a fixed placeholder
_AUTO_METHODS = ("dense", "pairwise", "triplet", "kernel")


def tune_methods(
    ns: Sequence[int] = (64, 128, 256, 512, 1024),
    methods: Sequence[str] = ("dense", "pairwise", "triplet"),
    *,
    backend: str | None = None,
    device="cuda",
    path: str | None = None,
    save: bool = True,
    iters: int = 3,
    time_budget: float | None = None,
) -> list[dict]:
    """Time ``pald.cohesion(D, method=m)`` on ``device`` for each method
    and n, and record the per-n winner under ``<backend>|-|n|method``, the
    record ``method="auto"`` reads.  A failing method is recorded under
    ``"failed"`` and the others still compete; RuntimeError if every
    method fails at some n.  Once ``time_budget`` wall seconds are spent
    (checked after each size) the remaining sizes are neither timed nor
    saved; their rows read ``{"n": n, "skipped": "over-budget"}``."""
    from repro_torch.core import pald
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    backend = backend or backend_of(dev)
    out = []
    t0 = time.monotonic()
    over_budget = False
    for n in ns:
        if over_budget:
            out.append({"n": n, "skipped": "over-budget"})
            continue
        D, _, _ = _synthetic_inputs(n, device=dev)
        timings, failed = {}, {}
        for m in methods:
            try:
                timings[m] = round(time_fn(
                    lambda: pald.cohesion(D, method=m, device=dev),
                    iters=iters), 6)
            except Exception as exc:  # noqa: BLE001 - one bad method
                failed[m] = f"{type(exc).__name__}: {exc}"
        if not timings:
            raise RuntimeError(f"every method failed at n={n}: {failed}")
        best = min(timings, key=timings.get)
        record = {"method": best, "timings": timings,
                  "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
        if failed:
            record["failed"] = failed
        if save:
            save_entry(backend, _METHOD_IMPL, n, "method", record, path)
        out.append({"n": n, **record})
        if time_budget is not None and time.monotonic() - t0 > time_budget:
            over_budget = True
    return out


def method_for_ex(n: int, *, backend: str | None = None, device=None,
                  path: str | None = None) -> tuple[str, str]:
    """(method, source) at size n: the measured crossover (``cache:<key>``
    or ``nearest:<key>``, nearest in log-space with no bound), else the
    reference's heuristic ("dense" up to n = 256, else "triplet";
    ``heuristic``).  A record naming no auto-selectable method gives the
    heuristic with ``quarantined:<key>``."""
    backend = backend or backend_of(device)
    rec = lookup(backend, _METHOD_IMPL, n, "method", path)
    key = _key(backend, _METHOD_IMPL, n, "method")
    source = f"cache:{key}"
    if rec is None:
        near = lookup_nearest(backend, _METHOD_IMPL, n, "method", path)
        if near:
            rec = near[1]
            key = _key(backend, _METHOD_IMPL, near[0], "method")
            source = f"nearest:{key}"
    fallback = "dense" if n <= 256 else "triplet"
    if rec is None:
        return fallback, "heuristic"
    m = rec.get("method") if isinstance(rec, dict) else None
    if m in _AUTO_METHODS:
        return str(m), source
    return fallback, f"quarantined:{key}"


def method_for(n: int, *, backend: str | None = None, device=None,
               path: str | None = None) -> str:
    """The method of :func:`method_for_ex`, without the source."""
    return method_for_ex(n, backend=backend, device=device, path=path)[0]
