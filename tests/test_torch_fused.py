"""The port's fused features pipeline (repro_torch.kernels.pald_fused,
``ops.pald_fused``, ``pald.from_features``) against the JAX reference.

On this CPU the port runs each fused kernel's plain torch version (the
wrapper takes it for CPU tensors).  Held to:

- the reference's ``focus_fused_pallas`` / ``cohesion_fused_pallas`` in
  interpret mode (bit-faithful to the TPU kernel body; slow, so n <= 64)
  and its jnp fallbacks ``_focus_fused_jnp`` / ``_cohesion_fused_jnp`` up
  to n = 130, for the four metrics, the five built-in families, the index
  tiebreak of ``ignore`` on and off the diagonal blocks, and ragged n with
  zero-padded rows.  The two packages compute the distances in another
  order (the port by fixed-order loops, the reference by matrix products),
  which moves them by ulps: on these tie-free inputs U is still bitwise for
  the exact-count families; C, and the smooth ``soft`` U, to rtol 1e-5,
  atol 1e-6 (tests/test_conformance.py).
- the PaLD part exactly: the reference's dense kernel pipeline (interpret)
  on the port's own ``cdist_reference(X)``, on tie-heavy quantized features
  with duplicated rows: U bitwise for the exact-count families, C to rtol
  1e-5, atol 1e-6.
- the whole slice: the reference's ``pald.from_features`` for every method
  the features kind resolves (fused, dense, pairwise, kernel), batched
  input and ``explain()``, at rtol 1e-5, atol 1e-6.

The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pald as jpald
from repro.core.features import pad_features as jpad_features
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pald_fused import cohesion_fused_pallas, focus_fused_pallas
from repro_torch.core import pald
from repro_torch.core.features import METRICS, cdist_reference, pad_features
from repro_torch.kernels import ops, pald_cohesion, pald_focus, pald_fused
from repro_torch.kernels.ref import weights_ref

RTOL, ATOL = 1e-5, 1e-6
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized"]


@pytest.fixture(autouse=True)
def _isolated_tuning_cache(tmp_path, monkeypatch):
    """Both packages resolve method / block 'auto' through their tuning
    caches; keep them away from any cache file of the machine."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "port_tune.json"))


def _X(n, d=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _tie_X(n, d=3, seed=0):
    """Features on a coarse grid (many exact distance ties) with every
    fifth row a duplicate of an earlier one."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-2, 3, size=(n, d)) * 0.5
    X[5::5] = X[rng.integers(0, 5, size=X[5::5].shape[0])]
    return X.astype(np.float32)


def _assert_u(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if name.startswith("soft"):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# each fused module against the reference's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_focus_fused_matches_interpret(name, metric):
    """Ragged n = 37 zero-padded to 48 (11 padding rows past n_valid)."""
    Xp, n0 = jpad_features(jnp.asarray(_X(37, seed=1)), 16)
    Uj = focus_fused_pallas(Xp, metric=metric, n_valid=n0, block=16,
                            block_z=16, interpret=True, ties=name)
    Ut = pald_fused.focus_fused_torch(torch.tensor(np.asarray(Xp)),
                                      metric=metric, n_valid=n0, block=16,
                                      block_z=16, ties=name)
    _assert_u(name, Ut.numpy(), Uj)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cohesion_fused_matches_interpret(name, metric):
    """The same weights W into both; ``ignore`` breaks index ties on the
    diagonal blocks and off them (three row blocks)."""
    Xp, n0 = jpad_features(jnp.asarray(_X(37, seed=2)), 16)
    U = jref.focus_ref(jnp.asarray(cdist_reference(
        torch.tensor(np.asarray(Xp)), metric=metric).numpy()), ties=name)
    W = np.asarray(jref.weights_ref(U, n0))
    Cj = cohesion_fused_pallas(Xp, jnp.asarray(W), metric=metric, n_valid=n0,
                               block=16, block_z=16, interpret=True,
                               ties=name)
    Ct = pald_fused.cohesion_fused_torch(torch.tensor(np.asarray(Xp)),
                                         torch.tensor(W), metric=metric,
                                         n_valid=n0, block=16, block_z=16,
                                         ties=name)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# ... and against its jnp fallbacks, up to n = 130
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_fused_modules_match_jnp(name, metric):
    X = _X(130, d=6, seed=3)
    Xp, n0 = jpad_features(jnp.asarray(X), 32)   # 130 -> 160
    Uj = jops._focus_fused_jnp(Xp, metric=metric, block=32, block_z=64,
                               n_valid=n0, ties=name)
    Xt = torch.tensor(np.asarray(Xp))
    Ut = pald_fused.focus_fused_torch(Xt, metric=metric, n_valid=n0,
                                      block=48, block_z=40, ties=name)
    _assert_u(name, Ut.numpy(), Uj)
    W = np.asarray(jref.weights_ref(Uj, n0))
    Cj = jops._cohesion_fused_jnp(Xp, jnp.asarray(W), metric=metric,
                                  block=32, block_z=64, n_valid=n0,
                                  ties=name)
    Ct = pald_fused.cohesion_fused_torch(Xt, torch.tensor(W), metric=metric,
                                         n_valid=n0, block=48, block_z=40,
                                         ties=name)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["drop", "split", "ignore"])
def test_plain_versions_do_not_depend_on_blocks(name):
    """The plain versions' row block and chunk change only the order of
    exact sums: U bitwise, C to the conformance tolerance."""
    X = torch.tensor(_tie_X(70, seed=4))
    U1 = pald_fused.focus_fused_torch(X, block=128, block_z=512, ties=name)
    U2 = pald_fused.focus_fused_torch(X, block=16, block_z=7, ties=name)
    assert torch.equal(U1, U2)
    W = weights_ref(U1)
    C1 = pald_fused.cohesion_fused_torch(X, W, block=128, ties=name)
    C2 = pald_fused.cohesion_fused_torch(X, W, block=16, block_z=7,
                                         ties=name)
    np.testing.assert_allclose(C1.numpy(), C2.numpy(), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the PaLD part exactly: the reference's kernels on the port's distances
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_pald_part_exact_on_port_distances(name, metric):
    X = _tie_X(45, seed=5)
    D = cdist_reference(torch.tensor(X), metric=metric).numpy()
    Dj = jnp.asarray(D)
    Uj = jops.focus(Dj, block=16, block_z=16, impl="interpret", ties=name)
    Ut = pald_fused.focus_fused_torch(torch.tensor(X), metric=metric,
                                      block=16, ties=name)
    _assert_u(name, Ut.numpy(), Uj)
    Cj = jpald.cohesion(Dj, method="kernel", impl="interpret", block=16,
                        block_z=16, weight=name)
    Ct = pald.from_features(X, metric=metric, weight=name, device="cpu")
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the whole slice: pald.from_features against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("method", ["auto", "fused", "dense", "pairwise",
                                    "kernel"])
def test_from_features_matches_reference(method, metric):
    X = _X(57, d=5, seed=6)
    kw = dict(metric=metric, method=method, ties="ignore")
    if method != "auto":
        kw["block"] = 16
    Cj = np.asarray(jpald.from_features(jnp.asarray(X), **kw))
    Ct = pald.from_features(X, device="cpu", **kw)
    assert Ct.dtype == torch.float32 and Ct.shape == (57, 57)
    np.testing.assert_allclose(Ct.numpy(), Cj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(Ct.double().sum()), 57 / 2, rtol=1e-5)


@pytest.mark.parametrize("method", ["fused", "kernel"])
@pytest.mark.parametrize("normalize", [False, True])
def test_from_features_batched(method, normalize):
    Xb = np.stack([_X(21, d=3, seed=s) for s in range(3)])
    kw = dict(method=method, normalize=normalize, block=8, ties="split")
    Ct = pald.from_features(Xb, device="cpu", **kw)
    assert Ct.shape == (3, 21, 21)
    Cj = np.asarray(jpald.from_features(jnp.asarray(Xb), **kw))
    np.testing.assert_allclose(Ct.numpy(), Cj, rtol=RTOL, atol=ATOL)
    for b in range(3):
        one = pald.from_features(Xb[b], device="cpu", **kw)
        assert torch.equal(Ct[b], one)


def test_from_features_explain():
    X = _X(40, d=6, seed=7)
    p = pald.plan(X, kind="features", device="cpu")
    info = p.explain()
    ref = jpald.plan(jnp.asarray(X), kind="features").explain()
    for key in ("kind", "method", "schedule", "metric", "n", "d",
                "normalize", "ties", "weight", "method_source"):
        assert info[key] == ref[key], key
    assert info["method"] == "fused" and info["method_source"] == "default"
    assert info["metric"] == "euclidean" and info["d"] == 6
    # block defaults to "auto": the cold cache's 128, clamped to n, as in
    # the reference (the kernels' own tiles are fixed)
    assert info["impl"] == "torch" and info["block"] == ref["block"] == 40
    assert info["block_z"] == ref["block_z"] == 40
    assert info["block_source"] == ref["block_source"] == "default"
    assert info["padded_shape"] == (40, 6)
    assert info["executor"].endswith("ops._exec_fused")
    smem = info["est_smem_bytes_per_cta"]
    assert smem == max(pald_fused.SMEM_PER_CTA.values()) and smem <= 48 * 1024
    # the feature axis is streamed: the estimate does not grow with d
    wide = pald.plan(n=40, d=5000, kind="features", device="cpu").explain()
    assert wide["est_smem_bytes_per_cta"] == smem
    for m in ("dense", "pairwise", "kernel"):
        e = pald.plan(X, kind="features", method=m, device="cpu").explain()
        assert e["executor"].endswith("engine._materialize_then"), m
        assert e["metric"] == "euclidean"


def test_from_features_knob_errors():
    X = _X(10, d=2)
    with pytest.raises(ValueError, match="unknown metric"):
        pald.from_features(X, metric="chebyshev", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        pald.from_features(X, method="triangle", device="cpu")
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        pald.from_features(X[0], device="cpu")
    with pytest.raises(ValueError, match="needs d="):
        pald.plan(n=10, kind="features", device="cpu")
    with pytest.raises(ValueError, match="metric= only applies"):
        pald.plan(np.zeros((4, 4)), metric="cosine", device="cpu")
    p = pald.plan(X, kind="features", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        p.execute(_X(10, d=3))
    # the "auto" tiles resolve as the reference's
    # (tests/test_torch_tuning.py); the distributed knobs as the
    # reference's: strategy= needs a mesh, and a mesh the k-NN method
    # (tests/test_torch_distributed_knn.py holds the sharded results)
    for pkg, Xa in ((jpald, jnp.asarray(X)), (pald, X)):
        kw = {} if pkg is jpald else {"device": "cpu"}
        with pytest.raises(ValueError, match=r"strategy='ring' configures "
                                             r"the mesh-sharded knn"):
            pkg.from_features(Xa, strategy="ring", **kw)
    from repro.launch import mesh as jmeshlib
    from repro_torch.testing.world import MeshSpec, World

    jmesh = jmeshlib.make_test_mesh((1,), ("d",))
    fused_mesh = (r"needs kind='features' with method='knn' \(got "
                  r"kind='features', method='fused'\)")
    with pytest.raises(ValueError, match=fused_mesh):
        jpald.from_features(jnp.asarray(X), mesh=jmesh)
    with World(1, spawn=False) as w:
        with pytest.raises(ValueError, match=fused_mesh):
            w.run(pald.from_features, X, mesh=MeshSpec((1,), ("d",)),
                  device="cpu")
        C = w.run(pald.from_features, X, k=3, mesh=MeshSpec((1,), ("d",)),
                  device="cpu")[0]
    np.testing.assert_array_equal(
        C, pald.from_features(X, k=3, device="cpu").numpy())
    np.testing.assert_allclose(
        C, np.asarray(jpald.from_features(jnp.asarray(X), k=3, mesh=jmesh)),
        rtol=1e-5, atol=1e-6)
    # on_error="fallback" runs (tests/test_torch_faults.py holds the guard)
    assert torch.equal(pald.from_features(X, on_error="fallback",
                                          device="cpu"),
                       pald.from_features(X, device="cpu"))


def test_from_features_check_rejects_nonfinite():
    X = _X(12, d=3)
    X[4, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        pald.from_features(X, device="cpu", check=True)
    X[4, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        pald.from_features(X, device="cpu", check=True)


def test_from_features_default_device_needs_a_gpu(monkeypatch):
    """The default device is the card; without one the call raises and
    never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pald.from_features(_X(8))


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the CUDA wrappers run the plain versions and launch
    nothing; ops.pald_fused gives the same C through either impl."""
    X = torch.tensor(_tie_X(33, seed=8))
    counts = (pald_fused.focus_fused_cuda.launches,
              pald_fused.cohesion_fused_cuda.launches,
              pald_focus.focus_general_cuda.launches,
              pald_cohesion.cohesion_general_cuda.launches)
    U = pald_fused.focus_fused_cuda(X, metric="manhattan", ties="ignore")
    assert torch.equal(U, pald_fused.focus_fused_torch(
        X, metric="manhattan", ties="ignore"))
    C1 = ops.pald_fused(X, metric="manhattan", impl="cuda", ties="ignore",
                        normalize=True)
    C2 = ops.pald_fused(X, metric="manhattan", impl="torch", ties="ignore",
                        normalize=True)
    assert torch.equal(C1, C2)
    assert counts == (pald_fused.focus_fused_cuda.launches,
                      pald_fused.cohesion_fused_cuda.launches,
                      pald_focus.focus_general_cuda.launches,
                      pald_cohesion.cohesion_general_cuda.launches)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.pald_fused(X, impl="pallas")
    with pytest.raises(ValueError, match="unknown metric"):
        pald_fused.focus_fused_torch(X, metric="chebyshev")
    with pytest.raises(ValueError, match="n_valid"):
        pald_fused.focus_fused_torch(X, n_valid=34)


def test_fused_matches_materialized_on_padding():
    """Zero-padded rows past n_valid contribute nothing to the real block:
    the padded run's real block equals the unpadded run's C."""
    X = torch.tensor(_X(29, d=4, seed=9))
    Xp, n0 = pad_features(X, 16)
    U = pald_fused.focus_fused_torch(Xp, n_valid=n0, block=16, ties="ignore")
    W = weights_ref(U, n0)
    C = pald_fused.cohesion_fused_torch(Xp, W, n_valid=n0, block=16,
                                        ties="ignore")
    want = ops.pald_fused(X, ties="ignore")
    np.testing.assert_allclose(C[:n0, :n0].numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the kernels' distance panel (the rule lives in the wrapper module; the
# kernels run on the card: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 63, 64, 65, 257, 4096, 4097, 8192, 50_000,
                               10**6])
def test_panel_rows_rule(n):
    """P is a multiple of 64, at least 64, at most n rounded up to 64, and
    the (P, ldp) float32 panel stays within the budget whenever more than
    the 64-row minimum fits it."""
    P, ld = pald_fused.panel_rows(n), pald_fused.panel_stride(n)
    assert P % 64 == 0 and P >= 64
    assert ld % 64 == 0 and n <= ld < n + 64
    assert P <= max(ld, 64)
    assert P == 64 or 4 * P * ld <= pald_fused.PANEL_BUDGET
    # the largest such P: one more 64-row step would pass the budget or n
    assert P + 64 > ld or 4 * (P + 64) * ld > pald_fused.PANEL_BUDGET


def test_panel_rows_at_the_main_path():
    """At n = 8192 the panel holds 2048 rows, 64 MiB: D whole needs 4 of
    them.  D fits one panel up to n = 4096 and never past it."""
    assert pald_fused.panel_rows(8192) == 2048
    assert 4 * 2048 * pald_fused.panel_stride(8192) == 64 << 20
    assert pald_fused.panel_rows(4096) == 4096
    assert all(pald_fused.panel_rows(n) < n for n in (4097, 4160, 6000,
                                                      8192, 10**6))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,rows,want", [(8192, None, 4), (257, None, 1),
                                         (257, 64, 5), (257, 192, 2),
                                         (64, None, 1), (1, None, 1)])
def test_fused_grid_launches(metric, n, rows, want):
    """The grids a fused wrapper counts for one call: the row-norm
    pre-pass (all metrics but manhattan), then a panel writer and a pass
    per panel: 9 at the main path's n = 8192."""
    norms = 0 if metric == "manhattan" else 1
    assert pald_fused.fused_grids(n, metric, rows) == norms + 2 * want


@pytest.mark.parametrize("rows", [0, 32, 100, -64])
def test_panel_override_must_be_a_multiple_of_64(rows):
    with pytest.raises(ValueError, match="multiple of 64"):
        pald_fused._panel(257, rows)
