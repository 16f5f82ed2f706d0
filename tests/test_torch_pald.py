"""The port's PaLD pipeline end to end (repro_torch.core.pald) against the
JAX reference (repro.core.pald), plus the port's package rules.

Every method the port carries (dense, pairwise, triplet, kernel) runs on
``device="cpu"`` and is held to the reference's same method, to the
committed goldens, and to the O(n^3) numpy oracle: C within rtol 1e-5,
atol 1e-6 (tests/test_conformance.py), since the two packages sum the same
terms in another order.  The port's numpy copies (``reference.py``,
``analysis.py``) must equal the reference's exactly.  The package imports
neither JAX nor ``repro``, runs on the CPU only when asked, and refuses
the knobs the reference refuses with the reference's errors.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import analysis as janalysis
from repro.core import pald as jpald
from repro.core import reference as jreference
from repro_torch.core import analysis, engine, pald, reference
from repro_torch.core.weights import soft_threshold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
RTOL, ATOL = 1e-5, 1e-6
METHODS = ["dense", "pairwise", "triplet", "kernel"]
GOLDEN = os.path.join(REPO, "tests", "golden", "pald_golden.npz")
GOLDEN_12PT = os.path.join(REPO, "tests", "golden", "weights_builtins_12pt.npz")


@pytest.fixture(autouse=True, scope="module")
def _private_tuning_caches(tmp_path_factory):
    """Plans read the tuning caches of both packages (``method="auto"``,
    the "auto" tiles): keep them away from any cache file of the
    machine."""
    d = tmp_path_factory.mktemp("tuning")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(d / "port.json"))
        mp.setenv("REPRO_TUNE_CACHE", str(d / "reference.json"))
        yield


def _points_D(n, seed=0, d=4):
    X = np.random.default_rng(100 + n + seed).normal(size=(n, d))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D


def _tie_matrix():
    """The 12-point integer tie matrix of tests/test_weights.py."""
    rng = np.random.default_rng(42)
    A = rng.integers(1, 6, size=(12, 12))
    D = np.triu(A, 1)
    return (D + D.T).astype(np.float64)


def _port(D, **kw):
    C = pald.cohesion(D, device="cpu", **kw)
    assert isinstance(C, torch.Tensor) and C.dtype == torch.float32
    assert C.device.type == "cpu"
    return C.numpy()


# ---------------------------------------------------------------------------
# against the reference, method by method
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 7, 33, 130])
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_reference(method, n):
    D = _points_D(n)
    C = _port(D, method=method, ties="ignore")
    Cj = np.asarray(jpald.cohesion(jnp.asarray(D), method=method,
                                   ties="ignore"))
    np.testing.assert_allclose(C, Cj, rtol=RTOL, atol=ATOL)
    Cref = reference.pald_pairwise_reference(D, ties="ignore", normalize=True)
    np.testing.assert_allclose(C, Cref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight", ["drop", "split", "ignore", "soft",
                                    "kernelized"])
@pytest.mark.parametrize("method", METHODS)
def test_functionals_on_ties_match_reference(method, weight):
    """The 12-point tie matrix, every built-in functional, small blocks."""
    D = _tie_matrix()
    kw = dict(method=method, weight=weight)
    if method != "dense":
        kw["block"] = 4
    C = _port(D, **kw)
    Cj = np.asarray(jpald.cohesion(jnp.asarray(D), **kw))
    np.testing.assert_allclose(C, Cj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ties", ["drop", "split", "ignore"])
@pytest.mark.parametrize("method", METHODS)
def test_weights_golden(method, ties):
    """tests/golden/weights_builtins_12pt.npz (read only)."""
    with np.load(GOLDEN_12PT) as z:
        want = z[f"{method}_{ties}"]
    kw = dict(method=method, ties=ties)
    if method != "dense":
        kw.update(block=4)
    if method == "kernel":
        kw.update(block_z=4)
    np.testing.assert_allclose(_port(_tie_matrix(), **kw), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("method", METHODS)
def test_pald_golden(method):
    """tests/golden/pald_golden.npz (read only), at the tolerance of
    tests/test_golden.py."""
    with np.load(GOLDEN) as z:
        D, want = z["D"], z["C"]
    np.testing.assert_allclose(_port(D, method=method, block=16), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_batched_matches_reference(method, normalize):
    Db = np.stack([_points_D(21, seed=s) for s in range(3)])
    C = _port(Db, method=method, normalize=normalize, ties="ignore", block=8)
    assert C.shape == (3, 21, 21)
    Cj = np.asarray(jpald.cohesion(jnp.asarray(Db), method=method,
                                   normalize=normalize, ties="ignore",
                                   block=8))
    np.testing.assert_allclose(C, Cj, rtol=RTOL, atol=ATOL)
    for b in range(3):
        np.testing.assert_array_equal(
            C[b], _port(Db[b], method=method, normalize=normalize,
                        ties="ignore", block=8))


def test_soft_mass_conserved():
    D = _points_D(40)
    C = _port(D, method="kernel", weight=soft_threshold(0.2),
              normalize=False)
    assert abs(C.sum() - 40 * 39 / 2) < 1e-3


def test_kernel_impls_agree_on_cpu():
    """impl='cuda' on the CPU goes through the kernel wrappers, which take
    the plain versions for CPU tensors: the same answer as impl='torch'."""
    D = _points_D(50)
    np.testing.assert_array_equal(
        _port(D, method="kernel", impl="cuda", ties="ignore"),
        _port(D, method="kernel", impl="torch", ties="ignore"))


def test_local_depths_match_reference():
    D = _points_D(30)
    C = pald.cohesion(D, method="kernel", device="cpu")
    ld = pald.local_depths(C).numpy()
    ldj = np.asarray(jpald.local_depths(jnp.asarray(C.numpy())))
    np.testing.assert_allclose(ld, ldj, rtol=1e-6)
    assert ld.sum() == pytest.approx(15.0, rel=1e-5)


def test_tensor_and_float64_inputs():
    D = _points_D(20)
    a = _port(D, method="kernel")
    b = _port(torch.from_numpy(D), method="kernel")
    c = _port(torch.from_numpy(D).float(), method="kernel")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# the port's numpy copies equal the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ties", ["drop", "split", "ignore"])
def test_reference_copy_equal(ties):
    D = _tie_matrix()
    for normalize in (False, True):
        np.testing.assert_array_equal(
            reference.pald_pairwise_reference(D, ties=ties,
                                              normalize=normalize),
            jreference.pald_pairwise_reference(D, ties=ties,
                                               normalize=normalize))
    np.testing.assert_array_equal(
        reference.local_focus_reference(D, ties=ties),
        jreference.local_focus_reference(D, ties=ties))


def test_triplet_reference_copy_equal():
    D = _points_D(15)
    np.testing.assert_array_equal(
        reference.pald_triplet_reference(D, normalize=True),
        jreference.pald_triplet_reference(D, normalize=True))


def test_analysis_copy_equal():
    a = np.random.default_rng(1).normal(size=(12, 3)) * 0.5
    b = np.random.default_rng(2).normal(size=(20, 3)) * 3.0 + 40.0
    X = np.vstack([a, b])
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    C = _port(D, method="kernel", ties="ignore")
    assert analysis.universal_threshold(C) == janalysis.universal_threshold(C)
    np.testing.assert_array_equal(analysis.strong_ties(C),
                                  janalysis.strong_ties(C))
    comms = analysis.communities(C)
    assert comms == janalysis.communities(C)
    assert all(set(c) <= set(range(12)) or set(c) <= set(range(12, 32))
               for c in comms)
    assert analysis.top_ties(C, 3, k=5) == janalysis.top_ties(C, 3, k=5)
    edges = [(0, 2), (2, 3), (5, 6)]
    assert (analysis.connected_components(8, edges)
            == janalysis.connected_components(8, edges))


# ---------------------------------------------------------------------------
# plan, device rule and input validation
# ---------------------------------------------------------------------------
def test_plan_explain_on_cpu():
    D = _points_D(33)
    p = pald.plan(D, method="kernel", device="cpu", ties="ignore")
    info = p.explain()
    assert info["impl"] == "torch" and info["device"] == "cpu"
    assert info["padded_n"] == 128 and info["block"] == 128
    assert info["executor"].endswith("ops._exec_kernel_dense")
    assert info["weight_properties"]["needs_index_tiebreak"]
    np.testing.assert_array_equal(p.execute(D).numpy(),
                                  _port(D, method="kernel", ties="ignore"))


def test_default_device_raises_without_gpu(monkeypatch):
    """No CPU fallback: the default device is the GPU, and without one the
    call raises instead of returning a CPU result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D = _points_D(8)
    for kw in ({}, {"method": "kernel"}, {"method": "dense"}):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pald.cohesion(D, **kw)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pald.plan(D, method="kernel")


def test_unknown_device_and_impl():
    D = _points_D(8)
    with pytest.raises(ValueError, match="unsupported device"):
        pald.cohesion(D, method="kernel", device="meta")
    with pytest.raises(ValueError, match="unknown impl"):
        pald.cohesion(D, method="kernel", impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="exactly one implementation"):
        pald.cohesion(D, method="dense", impl="torch", device="cpu")


def test_nonzero_diagonal_rejected():
    D = _points_D(8)
    D[3, 3] = 0.5
    with pytest.raises(ValueError, match="diagonal must be exactly 0"):
        pald.cohesion(D, method="kernel", device="cpu")


@pytest.mark.parametrize("bad", ["nonfinite", "negative", "asymmetric"])
def test_deep_check(bad):
    D = _points_D(8)
    if bad == "nonfinite":
        D[1, 2] = D[2, 1] = np.inf
    elif bad == "negative":
        D[1, 2] = D[2, 1] = -1.0
    else:
        D[1, 2] += 0.5
    pald.cohesion(D, method="kernel", device="cpu")  # off by default
    with pytest.raises(ValueError):
        pald.cohesion(D, method="kernel", device="cpu", check=True)


def test_shape_errors():
    with pytest.raises(ValueError, match="square"):
        pald.cohesion(np.zeros((3, 4)), method="dense", device="cpu")
    p = pald.plan(n=5, method="dense", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        p.execute(np.zeros((6, 6)))


@pytest.mark.parametrize("knobs,match", [
    ({"method": "kernel", "mesh": object()},
     r"mesh= shards the fused select->cohere knn pipeline and needs "
     r"kind='features' with method='knn' \(got kind='distance', "
     r"method='kernel'\)"),
    ({"method": "kernel", "strategy": "ring"},
     r"strategy='ring' configures the mesh-sharded knn pipeline; pass "
     r"mesh="),
])
def test_unported_knobs_raise(knobs, match):
    """The distributed knobs on a distance plan raise the reference's
    ``ValueError``, as its ``engine.plan`` does: a mesh shards only the
    features k-NN cell, and ``strategy=`` needs a mesh (their positive
    side: tests/test_torch_distributed_knn.py).  (The tuning cache's
    knobs resolve as the reference's:
    tests/test_torch_tuning.py::test_auto_knobs_resolve_as_the_reference.)"""
    from repro.core import engine as jengine

    D = _points_D(8)
    with pytest.raises(ValueError, match=match):
        jengine.plan(jnp.asarray(D), **knobs)
    with pytest.raises(ValueError, match=match):
        engine.plan(D, device="cpu", **knobs)


@pytest.mark.parametrize("n", [40, 256, 257])
def test_auto_method_resolves_as_reference(n, tmp_path, monkeypatch):
    """method="auto" on a distance matrix, no tuning cache: the reference's
    heuristic ("dense" up to n = 256, "triplet" above), the same
    method_source, and the reference's C."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    D = _points_D(n)
    info = pald.plan(D, device="cpu").explain()
    ref = jpald.plan(jnp.asarray(D)).explain()
    assert (info["method"], info["method_source"]) == (
        ref["method"], ref["method_source"])
    assert info["method"] == ("dense" if n <= 256 else "triplet")
    assert info["method_source"] == "heuristic"
    np.testing.assert_allclose(_port(D), np.asarray(jpald.cohesion(
        jnp.asarray(D))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("port_knobs,ref_knobs,method,source", [
    ({"z_chunk": 8}, {"z_chunk": 8}, "dense", "z_chunk"),
    ({"impl": "torch"}, {"impl": "jnp"}, "kernel", "impl/block_z"),
    ({"block_z": 16}, {"block_z": 16}, "kernel", "impl/block_z"),
])
def test_auto_method_pins_as_reference(port_knobs, ref_knobs, method, source,
                                       tmp_path, monkeypatch):
    """z_chunk= pins "dense", impl= or an explicit block_z pins "kernel",
    as in the reference; C is the reference's."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    D = _points_D(40)
    info = pald.plan(D, device="cpu", **port_knobs).explain()
    ref = jpald.plan(jnp.asarray(D), **ref_knobs).explain()
    assert (info["method"], info["method_source"]) == (method, source)
    assert (ref["method"], ref["method_source"]) == (method, source)
    np.testing.assert_allclose(
        _port(D, **port_knobs),
        np.asarray(jpald.cohesion(jnp.asarray(D), **ref_knobs)), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("port_knobs,ref_knobs", [
    ({"z_chunk": 8, "impl": "torch"}, {"z_chunk": 8, "impl": "jnp"}),
    ({"z_chunk": 8, "block_z": 16}, {"z_chunk": 8, "block_z": 16}),
])
def test_auto_method_conflicting_pins_raise(port_knobs, ref_knobs):
    D = _points_D(12)
    with pytest.raises(ValueError, match="pins method='dense'"):
        pald.plan(D, device="cpu", **port_knobs)
    with pytest.raises(ValueError, match="pins method='dense'"):
        jpald.plan(jnp.asarray(D), **ref_knobs)


def test_available_executors_match_reference():
    from repro.core import engine as jengine

    assert engine.available_executors() == jengine.available_executors()


def test_core_reexports_match_reference():
    """``repro_torch.core`` re-exports what ``repro.core`` does."""
    import repro.core as jcore
    import repro_torch.core as core

    names = [n for n in vars(jcore) if not n.startswith("_")]
    for name in ("analysis", "engine", "features", "knn", "pairwise", "pald",
                 "reference", "triplet", "cdist_reference", "cohesion",
                 "from_features", "local_depths", "plan"):
        assert name in names, name
        assert hasattr(core, name), name
    D = _points_D(10)
    np.testing.assert_allclose(
        core.cohesion(D, method="dense", device="cpu").numpy(),
        np.asarray(jcore.cohesion(jnp.asarray(D), method="dense")),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("knobs", [
    {"method": "triplet"},
    {"method": "kernel", "schedule": "tri"},
    {"schedule": "tri"},
])
def test_tri_and_triplet_knobs_run(knobs):
    """The block-symmetric method and the tri schedule plan and run on the
    CPU, against the reference's same call."""
    D = _points_D(20)
    C = _port(D, ties="ignore", block=8, **knobs)
    Cj = np.asarray(jpald.cohesion(jnp.asarray(D), ties="ignore", block=8,
                                   **knobs))
    np.testing.assert_allclose(C, Cj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("knobs", [
    {"method": "kernel", "k": 3},
    {"method": "kernel", "select": "chunked"},
])
def test_knn_knobs_off_knn_raise(knobs):
    """k= and select= configure the k-NN method only: elsewhere they are
    a contradiction (ValueError), as in the reference."""
    with pytest.raises(ValueError, match="knn"):
        engine.plan(_points_D(8), device="cpu", **knobs)


@pytest.mark.parametrize("knobs", [
    {"method": "knn", "k": 3},
    {"kind": "features", "method": "knn", "k": 3},
])
def test_knn_knobs_run(knobs):
    """The k-NN slice's knobs plan and run on the CPU."""
    D = _points_D(8)
    x = D[:, :4] if knobs.get("kind") == "features" else D
    C = engine.plan(x, device="cpu", **knobs).execute(x)
    assert C.shape == (8, 8) and bool(torch.isfinite(C).all())


# ---------------------------------------------------------------------------
# package rules: no JAX, nothing of repro
# ---------------------------------------------------------------------------
def _python_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_module_imports_jax_or_repro():
    """AST scan of every module of repro_torch (and chip_smoke.py)."""
    offenders = []
    for path in _python_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path}: {name}")
    assert not offenders, offenders


def test_imports_without_jax():
    """In a fresh interpreter where ``import jax`` and ``import repro``
    fail, the whole package imports and runs a small cohesion on CPU."""
    code = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.core import pald
import numpy as np
D = np.array([[0., 1., 2.], [1., 0., 1.5], [2., 1.5, 0.]])
C = pald.cohesion(D, method="kernel", device="cpu")
assert abs(float(C.sum()) - 1.5) < 1e-6, C
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(REPO, "src")})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py fails, and prints no result, without a GPU, and in a
    directory that holds nothing else of the repo."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path,
                       env={**env, "PYTHONPATH": ""})
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _public_names(path) -> set:
    """The names a module defines at its top level (functions, classes,
    assignments; imports excluded) that do not start with "_", plus its
    ``__all__``."""
    tree = ast.parse(open(path).read())
    names, exported = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        exported = set(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")} | exported


_CORE = sorted(p.stem for p in
               (Path(jpald.__file__).parent).glob("*.py")
               if p.stem != "__init__")


@pytest.mark.parametrize("module", _CORE)
def test_core_public_names_match_the_reference(module):
    """Every public name of each ``repro/core`` module (what it defines,
    and its ``__all__``) exists in the port's module of the same name."""
    import importlib

    ref = Path(jpald.__file__).parent / f"{module}.py"
    port = importlib.import_module(f"repro_torch.core.{module}")
    missing = sorted(n for n in _public_names(ref) if not hasattr(port, n))
    assert not missing, f"repro_torch.core.{module} lacks {missing}"
