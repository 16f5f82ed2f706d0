"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface.  All sources are
compiled together, one ``nvcc`` process each, the first time any kernel is
needed in a process.  The libraries go to ``build/kernels/<hash>/`` at the
root of the checkout (git-ignored), keyed by a hash of every source and the
flags, so an edited source rebuilds and an unchanged one is reused.

A user-registered weight functional (``core.weights.kernel_spec``) runs in
libraries of its own: ``kernels/_functor.py`` emits its C++ functor, and
each source that takes a weight (:data:`WEIGHT_SOURCES`) is compiled with
``-include`` of that header and ``-DPALD_USER_WEIGHT=<struct>``, which
instantiates the kernels for that functor alone
(``csrc/pald_weights.cuh``: ``dispatch_weight``'s ``kUser``).  They go to
``build/kernels/<hash>/w_<key>/``, ``key`` the functor's hash, and are
built lazily: only the source whose entry is called (:func:`build_user`
builds several at once).  An unchanged functional's libraries are reused
across processes; :func:`user_status` says which were built and which
reused, and :func:`kernel_info` what a functional runs on the card.  A
failed build raises with nvcc's log.

No ``--use_fast_math``: it would change division and flush denormals, and
the kernels are held to the plain torch versions.  ``-Xptxas -v``: each
library's build log (``lib<name>.log`` beside it, :func:`ptxas_report`)
keeps every kernel's registers, spills and shared memory.  Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises when
that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load", "check", "entry", "ptxas_report", "build_user",
           "user_status", "kernel_info", "user_dir", "CSRC", "BUILD_ROOT",
           "WEIGHT_SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pald_focus", "pald_cohesion", "pald_fused", "pald_fused_chunk",
           "pald_topk", "pald_topk_chunk", "pald_knn", "pald_knn_large",
           "pald_knn_wide", "pald_knn_piece", "pald_cohesion_tri")
# the sources whose entries take a weight functional: a user functional's
# libraries are these, built with its functor
WEIGHT_SOURCES = ("pald_focus", "pald_cohesion", "pald_fused",
                  "pald_fused_chunk", "pald_knn", "pald_knn_large",
                  "pald_knn_wide", "pald_knn_piece", "pald_cohesion_tri")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# each C entry point: its source and its argument types (pointers and the
# stream as c_void_p)
SIGNATURES = {
    "pald_focus_f32": ("pald_focus",
                       (_P, _P, _P, _P, _I64, _I64, _I64, _P, _I32, _F32,
                        _F32, _P)),
    "pald_focus_square_f32": ("pald_focus",
                              (_P, _P, _I64, _I64, _P, _I32, _F32, _F32,
                               _P)),
    "pald_cohesion_f32": ("pald_cohesion",
                          (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                           _I64, _I64, _I32, _F32, _F32, _I32, _P)),
    "pald_focus_fused_f32": ("pald_fused",
                             (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                              _I32, _F32, _F32, _P)),
    "pald_cohesion_fused_f32": ("pald_fused",
                                (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                 _I32, _I32, _F32, _F32, _I32, _P)),
    "pald_focus_fused_chunk_f32": ("pald_fused_chunk",
                                   (_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                    _I64, _I32, _I32, _F32, _F32, _P)),
    "pald_cohesion_fused_chunk_f32": ("pald_fused_chunk",
                                      (_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                       _I64, _I64, _I32, _I32, _F32, _F32,
                                       _I32, _P)),
    "pald_dist_fused_f32": ("pald_fused",
                            (_P, _P, _P, _I64, _I64, _I64, _I32, _P)),
    "pald_topk_f32": ("pald_topk",
                      (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P)),
    "pald_topk_chunk_f32": ("pald_topk_chunk",
                            (_P, _P, _P, _P, _I64, _I64, _I32, _I64, _I32,
                             _I32, _P)),
    "pald_topk_block_f32": ("pald_topk",
                            (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                             _I64, _I32, _I32, _I32, _P)),
    "pald_knn_values_f32": ("pald_knn",
                            (_P, _P, _P, _P, _I64, _I32, _P, _I32, _F32,
                             _F32, _P)),
    "pald_knn_values_features_f32": ("pald_knn",
                                     (_P, _P, _I64, _P, _P, _I64, _I32, _I32,
                                      _I64, _I32, _I64, _I64, _P, _I32, _F32,
                                      _F32, _P)),
    "pald_knn_values_features_large_f32": ("pald_knn_large",
                                           (_P, _P, _I64, _P, _P, _I64, _I32,
                                            _I32, _I64, _I32, _I64, _I64, _P,
                                            _I32, _F32, _F32, _P)),
    "pald_knn_values_features_wide_f32": ("pald_knn_wide",
                                          (_P, _P, _I64, _P, _P, _I64, _I32,
                                           _I32, _I64, _I32, _I64, _I64, _P,
                                           _I32, _F32, _F32, _P)),
    "pald_knn_values_features_piece_f32": ("pald_knn_piece",
                                           (_P, _P, _I64, _P, _P, _I64, _I32,
                                            _I32, _I64, _I32, _I64, _I64, _P,
                                            _I32, _F32, _F32, _P)),
    "pald_knn_values_distances_f32": ("pald_knn",
                                      (_P, _P, _I64, _P, _P, _I64, _I32,
                                       _I64, _I64, _P, _I32, _F32, _F32,
                                       _P)),
    "pald_topk_smem_bytes": ("pald_topk", (_I32, _I64)),
    "pald_knn_smem_bytes": ("pald_knn", (_I32, _I64)),
    "pald_cohesion_tri_f32": ("pald_cohesion_tri",
                              (_P, _P, _P, _I64, _I64, _I32, _F32, _F32,
                               _I32, _P)),
}

_lock = threading.Lock()
_loaded: dict = {}
_user_loaded: dict = {}   # (functor key, symbol) -> entry point
_user_status: dict = {}   # functor key -> {source: "built" | "reused"}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(jobs) -> None:
    """Run nvcc for each (library, source, extra flags), all at once.  Each
    writes to a private name first (a concurrent process sees either no
    library or a complete one) and keeps its log beside the library
    (``lib<name>.log``); raises with the failed ones' logs."""
    nvcc = _nvcc()
    procs = []
    for lib, name, extra in jobs:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [nvcc, *FLAGS, *extra, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            errors.append(f"{lib}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _build_all(out: Path) -> None:
    """Compile every source that has no library yet, all nvcc at once."""
    out.mkdir(parents=True, exist_ok=True)
    _compile([(out / f"lib{name}.so", name, ()) for name in SOURCES
              if not (out / f"lib{name}.so").exists()])


def user_dir(key: str) -> Path:
    """Where the libraries of the functor ``key`` live."""
    return BUILD_ROOT / _digest() / f"w_{key}"


def build_user(*functors, sources=WEIGHT_SOURCES) -> list:
    """Compile ``sources`` for each compiled functor
    (``_functor.CompiledFunctor``) that has no library of them yet, all
    nvcc at once; returns the (key, source) pairs built.  Holds no lock
    while nvcc runs."""
    jobs, built = [], []
    for f in functors:
        out = user_dir(f.key)
        out.mkdir(parents=True, exist_ok=True)
        hdr = out / "user_weight.cuh"
        if not hdr.exists():  # its content is fixed by the key
            fd, tmp = tempfile.mkstemp(suffix=".cuh", dir=out)
            with os.fdopen(fd, "w") as fh:
                fh.write(f.header())
            os.replace(tmp, hdr)
        status = _user_status.setdefault(f.key, {})
        for name in sources:
            if name not in WEIGHT_SOURCES:
                raise ValueError(f"{name} takes no weight functional")
            lib = out / f"lib{name}.so"
            if lib.exists():
                status.setdefault(name, "reused")
                continue
            jobs.append((lib, name, ("-I", str(CSRC), "-include", str(hdr),
                                     f"-DPALD_USER_WEIGHT={f.struct}")))
            built.append((f.key, name))
    _compile(jobs)
    for key, name in built:
        _user_status[key][name] = "built"
    return built


def user_status(key: str) -> dict:
    """{source: "built" | "reused"} of the functor ``key``'s libraries
    that this process built or found built."""
    return dict(_user_status.get(key, {}))


def kernel_info(weight) -> dict:
    """What the CUDA kernels run for a functional (``plan.explain()``): a
    built-in's id; or a user functional's ``KERNEL_USER``, compiled key and
    whether this process built its libraries or found them built
    (``library``: "built", "reused" or "not built yet", ``sources`` each
    source's); or, for one that does not compile, why (``error``)."""
    from repro_torch.core import weights as _weights

    w = _weights.resolve_weight(weight)
    if w.kernel_id is not None:
        return {"functor": "builtin", "id": w.kernel_id}
    try:
        key = _weights.kernel_spec(w).key
    except NotImplementedError as e:
        return {"functor": None, "error": str(e)}
    status = user_status(key)
    library = ("built" if "built" in status.values()
               else "reused" if status else "not built yet")
    return {"functor": "compiled", "id": _weights.KERNEL_USER, "key": key,
            "library": library, "sources": status}


def load(symbol: str, functor=None):
    """The C entry point ``symbol``, building all sources on the first
    call of the process; with ``functor`` (a user functional's
    ``_functor.CompiledFunctor``), the entry of that functor's library,
    built at first use (only that source)."""
    if functor is not None:
        return _load_user(symbol, functor)
    with _lock:
        if not _loaded:
            out = BUILD_ROOT / _digest()
            _build_all(out)
            libs = {src: ctypes.CDLL(str(out / f"lib{src}.so"))
                    for src in SOURCES}
            for sym, (src, argtypes) in SIGNATURES.items():
                fn = getattr(libs[src], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _loaded[sym] = fn
        return _loaded[symbol]


def _load_user(symbol: str, functor):
    got = _user_loaded.get((functor.key, symbol))
    if got is not None:
        return got
    src, argtypes = SIGNATURES[symbol]
    build_user(functor, sources=(src,))
    with _lock:
        fn = getattr(ctypes.CDLL(str(user_dir(functor.key) / f"lib{src}.so")),
                     symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _user_loaded[(functor.key, symbol)] = fn
    return fn


def entry(stem: str, items: int) -> tuple[str, tuple]:
    """The C entry point of one item (``<stem>_f32``) or, past one item,
    of a chunk (``<stem>_chunk_f32``), and the chunk's extra argument, the
    item count.  A chunk entry lives in a library of its own
    (``csrc/<source>_chunk.cu``): its kernels' item offsets cost
    registers, so one item runs code without them, and nvcc builds both
    halves in parallel."""
    return ((f"{stem}_chunk_f32", (items,)) if items > 1
            else (f"{stem}_f32", ()))


def ptxas_report(source: str) -> list[tuple[str, str]]:
    """(function, resources) for each kernel of ``csrc/<source>.cu`` and
    each device function compiled out of line, from the build log of the
    loaded libraries: ptxas's registers, spill stores and loads, and shared
    memory of each."""
    log = (BUILD_ROOT / _digest() / f"lib{source}.log").read_text()
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and ("spill" in line or "Used" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
