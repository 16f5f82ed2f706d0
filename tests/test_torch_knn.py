"""The port's sparse k-NN PaLD (``repro_torch.core.knn``,
``kernels/pald_knn.py``, ``ops.pald_knn`` / ``knn_values`` /
``select_cohere``, ``method="knn"``) against the JAX reference.

On this CPU the port runs the values kernel's plain version (the wrapper
takes it for CPU tensors).  Held to:

- the reference's ``pald_knn`` on the same D and the same graph, in
  interpret mode (bit-faithful to the TPU kernel body; n <= 64) and
  through its jnp fallback beyond, for the five built-in families and
  k in {1, 4, 11, n-1}, at rtol 1e-5, atol 1e-6 (tests/test_conformance.py);
- itself: the features kind bitwise the distance kind on
  ``cdist_reference(X)`` (the gathered tiles are bitwise the same), the
  plain versions of the kernel's features and D sources bitwise its cube
  source's,
  ``select_cohere`` bitwise selection then ``pald_knn``, and at k = n-1
  the scattered values within rtol 1e-5 of the dense C;
- the engine's k-NN knobs and cells, and the sparse analyses against the
  reference's functions on the same values.

The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import knn as jknn
from repro.core import pald as jpald
from repro.kernels import ops as jops
from repro_torch.core import engine, knn, pald
from repro_torch.core.features import METRICS, cdist_reference
from repro_torch.kernels import ops, pald_knn

RTOL, ATOL = 1e-5, 1e-6
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized"]


@pytest.fixture(autouse=True)
def _isolated_tuning_cache(tmp_path, monkeypatch):
    """Both packages resolve method / block 'auto' through their tuning
    caches; keep them away from any cache file of the machine."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "port_tune.json"))


def _X(n, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _dup_X(n, d=3, seed=0):
    """Features quantized to 0.5 (exact ties) with every fifth row a
    duplicate of an earlier one."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 2) / 2
    X[5::5] = X[rng.integers(0, 5, size=X[5::5].shape[0])]
    return X.astype(np.float32)


def _D(X, metric="euclidean"):
    return cdist_reference(torch.from_numpy(X), metric=metric)


def _quantized_D(n, seed=0):
    X = np.random.default_rng(seed).integers(0, 5, size=(n, 3))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return torch.from_numpy(D.astype(np.float32))


def _reference_values(D, graph, k, ties, impl, block):
    jg = jknn.NeighborGraph(jnp.asarray(graph.indices.numpy()),
                            jnp.asarray(graph.distances.numpy()))
    _, jv = jops.pald_knn(jnp.asarray(D.numpy()), k=k, impl=impl,
                          block=block, ties=ties, graph=jg)
    return np.asarray(jv)


# ---------------------------------------------------------------------------
# the values against the reference's kernel (interpret) and fallback (jnp)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 11, 47])
@pytest.mark.parametrize("kind", ["points", "quantized"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_pald_knn_matches_reference_kernel(name, kind, k):
    n = 48
    D = _D(_X(n, seed=k)) if kind == "points" else _quantized_D(n, seed=k)
    graph, vals = ops.pald_knn(D, k=k, ties=name)
    assert vals.shape == (n, k + 1) and vals.dtype == torch.float32
    want = _reference_values(D, graph, k, name, "interpret", 16)
    np.testing.assert_allclose(vals.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [4, 11, 129])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_pald_knn_matches_reference_fallback(name, k):
    n = 130
    D = _quantized_D(n, seed=5)
    graph, vals = ops.pald_knn(D, k=k, ties=name, block=32)
    want = _reference_values(D, graph, k, name, "jnp", 64)
    np.testing.assert_allclose(vals.numpy(), want, rtol=RTOL, atol=ATOL)


def test_graph_matches_reference_selection():
    D = _quantized_D(50, seed=2)
    graph, _ = ops.pald_knn(D, k=9)
    jg, _ = jops.pald_knn(jnp.asarray(D.numpy()), k=9, impl="jnp", block=16)
    np.testing.assert_array_equal(graph.indices.numpy(),
                                  np.asarray(jg.indices))
    np.testing.assert_array_equal(graph.distances.numpy(),
                                  np.asarray(jg.distances))


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_features_kind_equals_distance_kind(name, metric):
    X = _dup_X(45, d=4, seed=1)
    gf, vf = ops.pald_knn(torch.from_numpy(X), k=8, kind="features",
                          metric=metric, ties=name)
    gd, vd = ops.pald_knn(_D(X, metric), k=8, kind="distance", ties=name)
    assert torch.equal(gf.indices, gd.indices)
    assert torch.equal(gf.distances, gd.distances)
    assert torch.equal(vf, vd)


@pytest.mark.parametrize("k,diverging", [(3, [1]), (11, [0, 1])])
@pytest.mark.parametrize("name", ["drop", "ignore"])
def test_kinds_exclude_self_by_the_references_rules_at_inf(name, k, diverging):
    """Row 1 lies so far out that its row and column of D are +inf.  Each
    kind keeps its reference's rule for self (ROADMAP.md queue 3): the
    distance kind the reference's ``knn_from_distances`` (self at +inf,
    placed by its index among the +inf entries), the features kind the
    reference's streaming kernel (self after every real candidate).  They
    differ only on the rows whose selection reaches the +inf entries ahead
    of self, and agree bitwise on every other row."""
    X = _dup_X(12, d=2, seed=2)
    X[1] = 3e38
    D = _D(X, "manhattan")
    assert bool(torch.isinf(D[1, [0, 2]]).all())
    gf, vf = ops.pald_knn(torch.from_numpy(X), k=k, kind="features",
                          metric="manhattan", ties=name)
    gd, vd = ops.pald_knn(D, k=k, kind="distance", ties=name)
    jg = jknn.knn_from_distances(jnp.asarray(D.numpy()), k)
    np.testing.assert_array_equal(gd.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_array_equal(gd.distances.numpy(),
                                  np.asarray(jg.distances))
    Dn = D.numpy()
    for x in range(12):
        others = [y for y in range(12) if y != x]
        order = sorted(others, key=lambda y: (Dn[x, y], y))[:k]
        assert gf.indices[x].tolist() == order
    rows = torch.arange(12)[:, None]
    assert not bool((gf.indices == rows).any())
    assert torch.nonzero((gd.indices == rows).any(1)).flatten().tolist() \
        == diverging
    keep = [x for x in range(12) if x not in diverging]
    assert torch.equal(gf.indices[keep], gd.indices[keep])
    assert torch.equal(gf.distances[keep], gd.distances[keep])
    np.testing.assert_array_equal(vf[keep].numpy(), vd[keep].numpy())


@pytest.mark.parametrize("d", [1, 5, 8])
@pytest.mark.parametrize("metric", METRICS)
def test_gather_from_features_is_gathered_cdist(metric, d):
    X = torch.from_numpy(_dup_X(37, d=d, seed=d))
    graph = ops.topk_select(X, 10, metric=metric)
    D = cdist_reference(X, metric=metric)
    g = knn.gather_tile_from_features(X, graph.indices, metric)
    assert torch.equal(g, knn.gather_tile_from_distances(D, graph.indices))
    assert not bool(torch.diagonal(g, dim1=1, dim2=2).any())


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_select_cohere_is_selection_then_values(name):
    X = torch.from_numpy(_dup_X(60, d=3, seed=3))
    g, v = ops.select_cohere(X, k=12, ties=name, normalize=True, block=7,
                             cohere_block=9)
    g2 = knn.knn_from_features(X, 12)
    _, v2 = ops.pald_knn(X, k=12, kind="features", ties=name,
                         normalize=True, graph=g2)
    assert torch.equal(g.indices, g2.indices)
    assert torch.equal(g.distances, g2.distances)
    assert torch.equal(v, v2)


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_full_k_scatters_to_dense(name):
    n = 30
    D = _D(_X(n, seed=7))
    graph, vals = ops.pald_knn(D, k=n - 1, ties=name, normalize=True)
    C = knn.scatter_dense(graph, vals)
    Cd = pald.cohesion(D, method="dense", weight=name, device="cpu")
    np.testing.assert_allclose(C.numpy(), Cd.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [1, 7, 64])
def test_values_chunking_is_pure(block):
    D = _quantized_D(40, seed=8)
    g = knn.knn_from_distances(D, 6)
    tiles = knn.gather_tile_from_distances(D, g.indices)
    v = pald_knn.knn_values_torch(g.distances, tiles, g.indices,
                                  ties="ignore", block=block)
    ref = pald_knn.knn_values_torch(g.distances, tiles, g.indices,
                                    ties="ignore", block=40)
    assert torch.equal(v, ref)


def test_values_cuda_wrapper_takes_plain_version_on_cpu():
    D = _quantized_D(30, seed=9)
    g = knn.knn_from_distances(D, 5)
    tiles = knn.gather_tile_from_distances(D, g.indices)
    before = pald_knn.knn_values_cuda.launches
    v = pald_knn.knn_values_cuda(g.distances, tiles, g.indices, ties="split")
    assert pald_knn.knn_values_cuda.launches == before
    assert torch.equal(v, pald_knn.knn_values_torch(
        g.distances, tiles, g.indices, ties="split"))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_tile_sources_plain_versions_equal_the_cube(name, metric):
    """The plain versions of the values kernel's features and D sources
    (each row chunk's tiles gathered as it goes) bitwise the cube source's
    plain version on the whole gathered cube."""
    X = torch.from_numpy(_dup_X(70, d=4, seed=11))
    D = _D(X.numpy(), metric)
    g = knn.knn_from_distances(D, 9)
    cube = knn.gather_tile_from_features(X, g.indices, metric)
    want = pald_knn.knn_values_torch(g.distances, cube, g.indices, ties=name)
    vf = pald_knn.knn_values_from_features_torch(
        X, g.distances, g.indices, metric=metric, ties=name, block=16)
    vd = pald_knn.knn_values_from_distances_torch(
        D, g.distances, g.indices, ties=name, block=16)
    assert torch.equal(vf, want)
    assert torch.equal(vd, want)


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("kind", ["distance", "features"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_knn_values_plain_matches_reference(name, kind, impl):
    """``ops.knn_values(..., impl="torch")`` and the plain versions of the
    tile sources against the reference's ``knn_values`` on the same graph,
    in interpret mode (the TPU kernel's body) and jnp mode."""
    n, k = 40, 7
    X = _dup_X(n, d=3, seed=12)
    D = _D(X)
    g = knn.knn_from_distances(D, k)
    x = D if kind == "distance" else torch.from_numpy(X)
    v = ops.knn_values(x, g, kind=kind, impl="torch", ties=name)
    v_src = (pald_knn.knn_values_from_distances_torch(D, g.distances,
                                                      g.indices, ties=name)
             if kind == "distance" else
             pald_knn.knn_values_from_features_torch(
                 x, g.distances, g.indices, ties=name))
    assert torch.equal(v_src, v)
    jg = jknn.NeighborGraph(jnp.asarray(g.indices.numpy()),
                            jnp.asarray(g.distances.numpy()))
    jx = jnp.asarray(x.numpy())
    want = np.asarray(jops.knn_values(jx, jg, kind=kind, impl=impl,
                                      block=16, ties=name))
    np.testing.assert_allclose(v.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_select_cohere_plain_matches_reference(name):
    """``ops.select_cohere(..., impl="torch")`` against the reference's
    ``select_cohere`` (jnp) on tie-free points: the same graph, the
    values to rtol 1e-5 (the reference's distances differ by ulps)."""
    X = _X(45, d=4, seed=14)
    g, v = ops.select_cohere(torch.from_numpy(X), k=7, impl="torch",
                             ties=name, normalize=True)
    jg, jv = jops.select_cohere(jnp.asarray(X), k=7, impl="jnp", block=16,
                                ties=name, normalize=True)
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_allclose(g.distances.numpy(), np.asarray(jg.distances),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


def test_tile_source_wrappers_take_plain_versions_on_cpu():
    X = torch.from_numpy(_dup_X(30, d=3, seed=13))
    D = _D(X.numpy())
    g = knn.knn_from_distances(D, 5)
    before = (pald_knn.knn_values_from_features_cuda.launches,
              pald_knn.knn_values_from_distances_cuda.launches)
    vf = pald_knn.knn_values_from_features_cuda(X, g.distances, g.indices,
                                                ties="ignore")
    vd = pald_knn.knn_values_from_distances_cuda(D, g.distances, g.indices,
                                                 ties="ignore")
    assert (pald_knn.knn_values_from_features_cuda.launches,
            pald_knn.knn_values_from_distances_cuda.launches) == before
    assert torch.equal(vf, pald_knn.knn_values_from_features_torch(
        X, g.distances, g.indices, ties="ignore"))
    assert torch.equal(vd, vf)


@pytest.mark.parametrize("bad", [-1, 30, 1 << 20])
@pytest.mark.parametrize("kind", ["features", "distance"])
def test_tile_sources_reject_out_of_range_indices(kind, bad):
    """A caller-built graph with an index outside [0, n) raises through
    ``ops.knn_values`` and ``ops.pald_knn(graph=...)`` on either impl
    before any row is read: on the card the tile sources read X / D
    unchecked."""
    X = torch.from_numpy(_dup_X(30, d=3, seed=13))
    x = _D(X.numpy()) if kind == "distance" else X
    g = knn.knn_from_distances(_D(X.numpy()), 5)
    idx = g.indices.clone()
    idx[7, 2] = bad
    bad_graph = knn.NeighborGraph(idx, g.distances)
    for impl in ("cuda", "torch"):
        with pytest.raises(ValueError, match="outside the 30 rows"):
            ops.knn_values(x, bad_graph, kind=kind, impl=impl)
    with pytest.raises(ValueError, match="outside the 30 rows"):
        ops.pald_knn(x, k=5, kind=kind, graph=bad_graph)
    ops.knn_values(x, g, kind=kind)  # the graph as built passes


@pytest.mark.parametrize("k", [1, 32, 64, 65, 1024])
@pytest.mark.parametrize("d", [None, 1, 8, 300])
def test_values_smem_estimate_fits_the_card(k, d):
    """The values kernel's per-block shared memory (four rows, each
    source's layout) stays within the H100's 227 KB at every k it
    takes; the tile lives in shared memory up to k = 64."""
    assert 0 < pald_knn.smem_per_cta(k, d) <= 232448
    assert pald_knn.tile_layout(k, 8)[0] == (k <= 64)


def test_soft_reuses_focus_bitwise():
    """soft's support is share * focus on the same triples: the reuse is
    bitwise the support itself on finite distances."""
    from repro_torch.core.weights import (focus_weight, soft_threshold,
                                          support_weight)

    w = soft_threshold()
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.random(500).astype(np.float32))
               for _ in range(3))
    assert torch.equal(w.share(a, b) * focus_weight(a, b, c, w),
                       support_weight(a, b, c, w))


def test_empty_and_tiny_graphs():
    g, v = ops.pald_knn(torch.zeros((1, 1)), k=5)
    assert g.indices.shape == (1, 0) and v.tolist() == [[0.0]]
    g, v = ops.select_cohere(torch.zeros((1, 2)), k=3)
    assert g.k == 0 and v.shape == (1, 1)
    v = ops.knn_values(torch.zeros((3, 3)), knn.empty_graph(3))
    assert v.shape == (3, 1) and not bool(v.any())
    with pytest.raises(ValueError, match="unknown kind"):
        ops.pald_knn(torch.zeros((3, 3)), k=1, kind="graph")


# ---------------------------------------------------------------------------
# the engine: knobs, cells, batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["distance", "features"])
def test_k_pins_knn_and_clamps(kind):
    X = _X(20, seed=1)
    x = _D(X).numpy() if kind == "distance" else X
    p = pald.plan(x, kind=kind, k=50, device="cpu")
    e = p.explain()
    assert (e["method"], e["method_source"], e["k"]) == ("knn", "k", 19)
    assert e["executor"].endswith(f"_exec_knn_{kind}")
    assert e["est_smem_bytes_per_cta"] > 0 and e["padded_n"] == 20
    # the cold cache's 1024-row slab, clamped to n as the reference clamps
    # it; the distance kind has no selection slab
    assert e["select_block"] == (20 if kind == "features" else None)
    assert e["select_tile"] == (20 if kind == "features" else None)


@pytest.mark.parametrize("name", ["drop", "ignore", "soft"])
@pytest.mark.parametrize("kind", ["distance", "features"])
def test_k_at_least_n_minus_1_is_dense_bitwise(kind, name):
    X = _dup_X(24, seed=4)
    x = _D(X).numpy() if kind == "distance" else X
    run = pald.cohesion if kind == "distance" else pald.from_features
    Ck = run(x, method="knn", k=23, weight=name, device="cpu")
    Cc = run(x, k=200, weight=name, device="cpu")
    Cd = run(x, method="dense", weight=name, device="cpu")
    assert torch.equal(Ck, Cd) and torch.equal(Cc, Cd)


@pytest.mark.parametrize("k", [3, 9])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cohesion_knn_matches_reference(name, k):
    D = _D(_X(40, seed=k))
    C = pald.cohesion(D.numpy(), k=k, weight=name, device="cpu")
    Cj = jpald.cohesion(jnp.asarray(D.numpy()), method="knn", k=k,
                        weight=name, block=16, impl="jnp")
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)
    Cf = pald.from_features(_X(40, seed=k), k=k, weight=name, device="cpu",
                            select_block=16, block=8)
    np.testing.assert_allclose(Cf.numpy(), C.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["distance", "features"])
def test_knn_batched(kind):
    Xb = np.stack([_X(18, seed=s) for s in range(3)])
    xb = (np.stack([_D(x).numpy() for x in Xb]) if kind == "distance"
          else Xb)
    run = pald.cohesion if kind == "distance" else pald.from_features
    Cb = run(xb, k=5, ties="ignore", device="cpu")
    assert Cb.shape == (3, 18, 18)
    for i in range(3):
        assert torch.equal(Cb[i], run(xb[i], k=5, ties="ignore",
                                      device="cpu"))


@pytest.mark.parametrize("kind,knobs", [
    ("distance", {"method": "knn"}),
    ("distance", {"method": "knn", "k": 0}),
    ("distance", {"method": "knn", "k": 3, "block_z": 64}),
    ("distance", {"k": 3, "z_chunk": 4}),
    ("distance", {"method": "knn", "k": 3, "select": "cuda"}),
    ("distance", {"method": "knn", "k": 3, "select_block": 64}),
    ("features", {"select": "cuda"}),
    ("features", {"method": "dense", "select_block": 64}),
    ("features", {"k": 3, "select": "pallas"}),
])
def test_knn_knobs_raise_value_error(kind, knobs):
    X = _X(10, seed=2)
    x = _D(X).numpy() if kind == "distance" else X
    with pytest.raises(ValueError):
        engine.plan(x, kind=kind, device="cpu", **knobs)


@pytest.mark.parametrize("knob", ["mesh", "strategy"])
def test_knn_unported_knobs_name_their_slice(knob):
    """The distributed knobs of the k-NN features cell, held to the
    reference: a one-rank mesh plans the sharded cell with the reference's
    mesh report (tests/test_torch_distributed_knn.py holds wider meshes
    and the results); ``strategy=`` alone raises the reference's
    ``ValueError``."""
    from repro.core import engine as jengine
    from repro.launch import mesh as jmeshlib
    from repro_torch.testing.world import World

    X = _X(10)
    if knob == "strategy":
        match = r"strategy='ring' configures the mesh-sharded knn pipeline"
        with pytest.raises(ValueError, match=match):
            jengine.plan(jnp.asarray(X), kind="features", k=3,
                         strategy="ring")
        with pytest.raises(ValueError, match=match):
            engine.plan(X, kind="features", k=3, device="cpu",
                        strategy="ring")
        return
    want = jengine.plan(jnp.asarray(X), kind="features", k=3,
                        mesh=jmeshlib.make_test_mesh((1,), ("rows",)))
    with World(1, spawn=False):
        from repro_torch.launch.mesh import make_test_mesh

        got = engine.plan(X, kind="features", k=3, device="cpu",
                          mesh=make_test_mesh((1,), ("rows",))).explain()
    for key in ("mesh", "mesh_axes", "strategy", "shard_rows",
                "comm_estimate", "k", "method"):
        assert got[key] == want.explain()[key], key


def test_knn_registered_cells():
    assert (engine.get_executor("distance", "knn", "dense")
            is ops._exec_knn_distance)
    assert (engine.get_executor("features", "knn", "dense")
            is ops._exec_knn_features)


def test_knn_select_knob_runs_the_plain_selection():
    X = _dup_X(30, seed=5)
    Ca = pald.from_features(X, k=6, select="torch", device="cpu")
    Cb = pald.from_features(X, k=6, select="cuda", device="cpu")
    assert torch.equal(Ca, Cb)
    e = pald.plan(X, kind="features", k=6, select="torch",
                  device="cpu").explain()
    assert e["select"] == "torch" and e["impl"] == "torch"


# ---------------------------------------------------------------------------
# the sparse analyses against the reference's
# ---------------------------------------------------------------------------
def _graph_and_values(n=60, k=10, seed=11):
    D = _D(_X(n, seed=seed))
    return ops.pald_knn(D, k=k, normalize=True, ties="ignore")


def _jgraph(graph):
    return jknn.NeighborGraph(jnp.asarray(graph.indices.numpy()),
                              jnp.asarray(graph.distances.numpy()))


def test_scatter_dense_and_local_depths_match_reference():
    graph, vals = _graph_and_values()
    C = knn.scatter_dense(graph, vals)
    Cj = jknn.scatter_dense(_jgraph(graph), jnp.asarray(vals.numpy()))
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    # a float32 row sum, taken in another order by each package
    np.testing.assert_allclose(
        knn.local_depths(vals).numpy(),
        np.asarray(jknn.local_depths(jnp.asarray(vals.numpy()))),
        rtol=RTOL, atol=ATOL)
    assert int((C != 0).sum()) <= graph.n * (graph.k + 1)


def test_threshold_and_strong_ties_match_reference():
    graph, vals = _graph_and_values(seed=12)
    v = vals.numpy()
    assert knn.universal_threshold(vals) == jknn.universal_threshold(v)
    for got, want in zip(knn.strong_ties(graph, vals),
                         jknn.strong_ties(_jgraph(graph), v)):
        np.testing.assert_array_equal(got, want)
    assert knn.strong_ties(knn.empty_graph(4), np.zeros((4, 1)))[0].size == 0


def test_communities_match_reference_on_planted_clusters():
    """Planted communities of 12 (the example's mixture, scaled down) with
    k >= the community size: no strong component spans two of them, and
    the components are the reference's on the same values."""
    rng = np.random.default_rng(0)
    c, size, d = 8, 12, 4
    centers = rng.normal(size=(c, d)) * (6.0 * c ** (1.0 / d))
    X = np.concatenate([centers[i] + rng.normal(size=(size, d))
                        for i in range(c)]).astype(np.float32)
    labels = np.repeat(np.arange(c), size)
    graph, vals = ops.select_cohere(torch.from_numpy(X), k=size,
                                    normalize=True)
    comms = knn.communities(graph, vals)
    assert comms == jknn.communities(_jgraph(graph), vals.numpy())
    assert all(len(set(labels[cc].tolist())) == 1 for cc in comms)
    assert max(len(cc) for cc in comms) >= size // 2


@pytest.mark.parametrize("k", [1, 2, 3])
def test_communities_two_pairs_match_reference(k):
    """Two far-apart pairs: the reference's own docstring example."""
    D = [[0., 1., 9., 9.], [1., 0., 9., 9.], [9., 9., 0., 1.],
         [9., 9., 1., 0.]]
    g, vals = ops.pald_knn(torch.tensor(D), k=k, normalize=True)
    jg, jv = jops.pald_knn(jnp.asarray(D), k=k, normalize=True, impl="jnp",
                           block=4)
    assert knn.communities(g, vals) == jknn.communities(jg, np.asarray(jv))
