"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA GPU: it is marked ``cuda`` and skips without
one (this file imports neither JAX nor ``repro``, so it runs where only
PyTorch is installed):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

U is bitwise for every functional whose focus is an exact count (all but
``soft``); C, and the smooth ``soft`` U, to rtol 1e-5, atol 1e-6 (the
conformance tolerance): kernel and plain version sum in another order.
The fused features kernels are held to their plain versions the same way,
their distances bitwise to ``cdist_reference``, and their U and C bitwise
to the dense kernels' on those distances (the same loops on the same
numbers).  The k-NN selection kernel is held bitwise to its plain version
(indices and distances, and across two calls), the k-NN
values kernel's cube source to rtol 1e-5, its features and D sources
bitwise to the cube source.  Past k = 1024 the selection by threshold is
bitwise its plain version on tie-heavy rows (every metric, the block
entry merged, a sort past shared memory), and the values' register tiles
(every d: widths 8 to 64, then pieces) and the D source's sweep are
within rtol 1e-5 of their plain versions and bitwise the other layouts
for a functional whose focus is an exact count.  The tri
kernels are held to their plain versions the same way, their U bitwise to
the dense kernel's, and their C bitwise to itself across two calls and to
the dense kernel's C on a symmetric D and W.  A W with a non-finite entry
takes the cohesion kernels' multiply form and gives the plain versions'
nan and inf.
Training sharded over a mesh: a world of 2 gloo ranks on the card (mesh
(2,) over ``data``, fsdp) runs reduced gemma2-2b's sharded step from the
seeded weights: its loss within rtol 1e-6 and its gathered float32
gradients within 2^-8 of each leaf's largest of the single-device step in
2 microbatches on the card (each rank's rows are one microbatch's), its
weights after the step within 4 lr.
Guarded execution on the card (``on_error="fallback"``): a plan on the
card keeps its kernels, so a dead CUDA impl ends in ``FallbackExhausted``
on every kernel cell (each plain rung unavailable); a fault-free fallback
plan launches the kernels and records nothing, past k = 1024 too (the
k-NN kernels' large-k variants: the graph bitwise, the values within the
tolerance of the plain versions on a slab; the D source and a chunk
likewise).  A
(b, n, n) chunk runs the dense and tri kernels in one grid per pass,
bitwise its items one at a time, and a batched call's peak memory is its
chunk's; so do a (b, n, d) chunk through the fused kernels, the
selection and the k-NN values kernel's features and D sources (one launch
a chunk, past 65,535 items one grid per 65,535).
``chip_smoke.py`` repeats the comparisons at the main paths' full size.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import weights as tw
from repro_torch.kernels import (ops, pald_cohesion, pald_cohesion_tri,
                                 pald_focus, pald_focus_tri)

RTOL, ATOL = 1e-5, 1e-6
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized"]


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


def _operands(mx, my, mz, seed=0, inf_frac=0.03):
    """Asymmetric, tie-heavy DXZ, DYZ, DXY (multiples of 0.5, a few +inf),
    a positive W and a random explicit tiebreak, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def d(shape):
        a = rng.integers(0, 8, size=shape).astype(np.float32) * 0.5
        a[rng.random(shape) < inf_frac] = np.inf
        return a

    return (d((mx, mz)), d((my, mz)), d((mx, my)),
            rng.random((mx, my)).astype(np.float32),
            rng.random((mx, my)) < 0.5)


def _assert_u(name, got, want):
    if name.startswith("soft"):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _assert_bitwise(what, got, want):
    """torch.equal, naming on failure how many entries differ and the
    first few (index, got, want)."""
    if torch.equal(got, want):
        return
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = (got != want).nonzero()
    first = [(i, float(got[tuple(i)]), float(want[tuple(i)]))
             for i in bad[:8].tolist()]
    pytest.fail(f"{what}: {bad.shape[0]} of {got.numel()} entries differ; "
                f"first (index, got, want): {first}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: see README.md)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (63, 65, 31), (130, 70, 257)])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_kernels_vs_plain(cuda_device, name, shape):
    mx, my, mz = shape
    DXZ, DYZ, DXY, W, XW = [torch.as_tensor(a, device=cuda_device)
                            for a in _operands(mx, my, mz, seed=9)]
    f0 = pald_focus.focus_general_cuda.launches
    Uk = ops.focus_general(DXZ, DYZ, DXY, impl="cuda", ties=name)
    Up = ops.focus_general(DXZ, DYZ, DXY, impl="torch", ties=name)
    assert pald_focus.focus_general_cuda.launches == f0 + 1
    _assert_u(name, Uk.cpu().numpy(), Up.cpu().numpy())
    routes = ([{"xw_offsets": (3, 8)}, {"xwins": XW}]
              if tw.resolve_weight(name).needs_index_tiebreak else [{}])
    for r in routes:
        Ck = ops.cohesion_general(DXZ, DYZ, DXY, W, impl="cuda", ties=name,
                                  **r)
        Cp = ops.cohesion_general(DXZ, DYZ, DXY, W, impl="torch", ties=name,
                                  **r)
        torch.cuda.synchronize()
        np.testing.assert_allclose(Ck.cpu().numpy(), Cp.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_operands(cuda_device):
    a = torch.zeros((8, 8), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        pald_focus.focus_general_cuda(a.double(), a, a)
    with pytest.raises(ValueError, match="contiguous"):
        pald_focus.focus_general_cuda(a[:, ::2], a[:, ::2], a)
    # a user functional compiles unless an op is outside the table
    user = tw.WeightFunctional("_user_cuda", tw.DROP.focus,
                               lambda o, t, p, w=None: torch.cos(o))
    with pytest.raises(NotImplementedError, match="aten.cos"):
        pald_cohesion.cohesion_general_cuda(a, a, a, a, ties=user)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_cohesion_matches_cpu(cuda_device, name):
    """The facade on its default device (the GPU, through both kernels)
    against the same call on the CPU (the plain versions)."""
    from repro_torch.core import pald

    X = np.random.default_rng(11).integers(0, 6, size=(200, 3))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    f0 = pald_focus.focus_general_cuda.launches
    c0 = pald_cohesion.cohesion_general_cuda.launches
    Cg = pald.cohesion(D, method="kernel", weight=name)
    assert Cg.device.type == "cuda" and Cg.dtype == torch.float32
    assert pald_focus.focus_general_cuda.launches == f0 + 1
    assert pald_cohesion.cohesion_general_cuda.launches == c0 + 1
    Cc = pald.cohesion(D, method="kernel", weight=name, device="cpu")
    np.testing.assert_allclose(Cg.cpu().numpy(), Cc.numpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the fused features kernels (csrc/pald_fused.cu)
# ---------------------------------------------------------------------------
METRICS = ["sqeuclidean", "euclidean", "cosine", "manhattan"]


def _features(n, d, seed=0):
    """Features quantized to 0.1 (rounded products and sums, exact ties)
    with every fifth row a duplicate of an earlier one; no +inf."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    dup = np.arange(5, n, 5)
    X[dup] = X[rng.integers(0, 5, size=dup.size)]
    return X.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 300])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_fused_distances_bitwise(cuda_device, metric, d):
    """The kernels' distance code against cdist_reference, bitwise, on the
    card and on the CPU; rows past n_valid are +inf, the diagonal 0."""
    from repro_torch.core.features import cdist_reference, masked_dist_tile
    from repro_torch.kernels.pald_fused import dist_fused_cuda

    X = _features(257, d, seed=d)
    Xg = torch.as_tensor(X, device=cuda_device)
    Dk = dist_fused_cuda(Xg, metric=metric)
    _assert_bitwise("kernel vs cdist_reference on the card", Dk,
                    cdist_reference(Xg, metric=metric))
    _assert_bitwise("kernel vs cdist_reference on the CPU", Dk.cpu(),
                    cdist_reference(torch.as_tensor(X), metric=metric))
    Dp = dist_fused_cuda(Xg, metric=metric, n_valid=200)
    _assert_bitwise("kernel vs masked_dist_tile, n_valid=200", Dp,
                    masked_dist_tile(Xg, Xg, metric, 0, 0, 200))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 300])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_fused_kernels_vs_plain(cuda_device, name, metric, d):
    """Each fused kernel against its plain version on the card (ragged
    n = 257): U bitwise for the exact-count families, C to rtol 1e-5."""
    from repro_torch.kernels import pald_fused
    from repro_torch.kernels.ref import weights_ref

    Xg = torch.as_tensor(_features(257, d, seed=d), device=cuda_device)
    kw = dict(metric=metric, ties=name)
    f0 = pald_fused.focus_fused_cuda.launches
    c0 = pald_fused.cohesion_fused_cuda.launches
    Uk = pald_fused.focus_fused_cuda(Xg, **kw)
    Up = pald_fused.focus_fused_torch(Xg, **kw)
    _assert_u(name, Uk.cpu().numpy(), Up.cpu().numpy())
    W = weights_ref(Up)
    Ck = pald_fused.cohesion_fused_cuda(Xg, W, **kw)
    Cp = pald_fused.cohesion_fused_torch(Xg, W, **kw)
    torch.cuda.synchronize()
    assert pald_fused.focus_fused_cuda.launches == f0 + 1
    assert pald_fused.cohesion_fused_cuda.launches == c0 + 1
    np.testing.assert_allclose(Ck.cpu().numpy(), Cp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 300])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", ["drop", "split", "ignore"])
def test_cuda_fused_vs_dense_kernels(cuda_device, name, metric, d):
    """The fused kernels against the dense ones on cdist_reference(X): the
    same distances through the same loops, so U and C are bitwise."""
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_fused
    from repro_torch.kernels.ref import weights_ref

    Xg = torch.as_tensor(_features(257, d, seed=d), device=cuda_device)
    D = cdist_reference(Xg, metric=metric)
    Uf = pald_fused.focus_fused_cuda(Xg, metric=metric, ties=name)
    Ud = ops.focus(D, impl="cuda", ties=name)
    assert torch.equal(Uf, Ud)
    W = weights_ref(Ud)
    Cf = pald_fused.cohesion_fused_cuda(Xg, W, metric=metric, ties=name)
    Cd = ops.cohesion_from_weights(D, W, impl="cuda", ties=name)
    assert torch.equal(Cf, Cd)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_from_features_matches_cpu(cuda_device, metric):
    """The facade with default knobs on the card (the fused kernels once
    each, the dense kernels not at all) against the same call on the CPU
    (the plain versions)."""
    from repro_torch.core import pald
    from repro_torch.kernels import pald_fused

    X = _features(300, 7, seed=3)
    f0 = pald_fused.focus_fused_cuda.launches
    c0 = pald_fused.cohesion_fused_cuda.launches
    d0 = (pald_focus.focus_general_cuda.launches,
          pald_cohesion.cohesion_general_cuda.launches)
    Cg = pald.from_features(X, metric=metric)
    assert Cg.device.type == "cuda" and Cg.shape == (300, 300)
    assert pald_fused.focus_fused_cuda.launches == f0 + 1
    assert pald_fused.cohesion_fused_cuda.launches == c0 + 1
    assert (pald_focus.focus_general_cuda.launches,
            pald_cohesion.cohesion_general_cuda.launches) == d0
    Cc = pald.from_features(X, metric=metric, device="cpu")
    np.testing.assert_allclose(Cg.cpu().numpy(), Cc.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_fused_panel_size_invariance(cuda_device, name, metric):
    """U and C bitwise the same at every panel size, at a ragged n = 257:
    the default P (one 320-row panel), 64 (five panels, the last one row)
    and 192 (two, the last 65 rows); U bitwise the dense kernel's for the
    exact-count families.  Each call counts the grids the rule gives."""
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_fused
    from repro_torch.kernels.ref import weights_ref

    Xg = torch.as_tensor(_features(257, 5, seed=11), device=cuda_device)
    kw = dict(metric=metric, ties=name)
    sizes = (None, 64, 192)
    U, C = {}, {}
    for rows in sizes:
        g0 = pald_fused.focus_fused_cuda.grid_launches
        U[rows] = pald_fused.focus_fused_cuda(Xg, _panel_rows=rows, **kw)
        assert (pald_fused.focus_fused_cuda.grid_launches - g0
                == pald_fused.fused_grids(257, metric, rows))
    W = weights_ref(U[None])
    for rows in sizes:
        C[rows] = pald_fused.cohesion_fused_cuda(Xg, W, _panel_rows=rows,
                                                 **kw)
    for rows in sizes[1:]:
        assert torch.equal(U[rows], U[None]), rows
        assert torch.equal(C[rows], C[None]), rows
    if not name.startswith("soft"):
        D = cdist_reference(Xg, metric=metric)
        assert torch.equal(U[None], ops.focus(D, impl="cuda", ties=name))


@pytest.mark.cuda
def test_cuda_fused_panel_freed_after_the_call(cuda_device):
    """A fused call holds its (P, ldp) panel and the (n,) norms besides its
    output, and frees both when it returns."""
    from repro_torch.kernels import pald_fused
    from repro_torch.kernels.ref import weights_ref

    n = 300
    Xg = torch.as_tensor(_features(n, 7, seed=12), device=cuda_device)
    panel = 4 * 192 * pald_fused.panel_stride(n)
    slack = 3 * 512   # the caching allocator rounds each block up to 512 B
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    U = pald_fused.focus_fused_cuda(Xg, _panel_rows=192)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert panel <= peak <= 4 * n * n + panel + 4 * n + slack
    W = weights_ref(U)
    del U
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    C = pald_fused.cohesion_fused_cuda(Xg, W, _panel_rows=192)
    del C
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# the sparse k-NN kernels (csrc/pald_topk.cu, csrc/pald_knn.cu)
# ---------------------------------------------------------------------------
def _knn_features(n, d, seed=0, quantum=0.1):
    """Quantized features with every fifth row a duplicate: exact distance
    ties at the k boundary, and zero distances."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) / quantum) * quantum
    dup = np.arange(5, n, 5)
    X[dup] = X[rng.integers(0, 5, size=dup.size)]
    return X.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2, 1), (33, 7), (33, 32), (257, 1),
                                 (257, 31), (257, 32), (257, 33), (257, 256),
                                 (1100, 1024)])
@pytest.mark.parametrize("d", [1, 5, 8, 300])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_topk_vs_plain(cuda_device, metric, d, n, k):
    """The selection kernel against its plain version on the card, indices
    and distances bitwise, on tie-heavy quantized rows at a ragged n; a
    second call bitwise the first, with its grids counted."""
    from repro_torch.kernels import pald_topk

    Xg = torch.as_tensor(_knn_features(n, d, seed=n + d), device=cuda_device)
    t0 = pald_topk.topk_select_cuda.launches
    gk = pald_topk.topk_select_cuda(Xg, k, metric=metric)
    gp = pald_topk.topk_select_torch(Xg, k, metric=metric)
    torch.cuda.synchronize()
    assert pald_topk.topk_select_cuda.launches == t0 + 1
    assert torch.equal(gk.indices, gp.indices)
    assert torch.equal(gk.distances, gp.distances)
    g0 = pald_topk.topk_select_cuda.grid_launches
    gs = pald_topk.topk_select_cuda(Xg, k, metric=metric)
    assert (pald_topk.topk_select_cuda.grid_launches - g0
            == (metric != "manhattan") + 1)
    assert torch.equal(gs.indices, gk.indices)
    assert torch.equal(gs.distances, gk.distances)


@pytest.mark.cuda
def test_cuda_topk_limits(cuda_device):
    from repro_torch.kernels import pald_topk

    X = torch.zeros((1100, 2), device=cuda_device)
    g = pald_topk.topk_select_cuda(X, 1025)  # the large-k variant
    assert g.indices.shape == (1100, 1025)
    with pytest.raises(ValueError, match="exceeds the n-1"):
        pald_topk.topk_select_cuda(X[:5], 5)
    g = pald_topk.topk_select_cuda(X[:1], 0)
    assert g.indices.shape == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 65, 128, 129, 256, 257,
                               1024, 1025, 2048, 4096, 16384])
def test_cuda_knn_smem_estimates_are_the_kernels(cuda_device, k):
    """``pald_topk.smem_per_cta`` and ``pald_knn.smem_per_cta`` give the
    bytes that the C launches set (``pald_topk_smem_bytes``,
    ``pald_knn_smem_bytes``) at every width, past k = 1024 the large-k
    variants': the Python copies of the layouts cannot drift from the
    kernels unnoticed."""
    from repro_torch.kernels import _build, pald_knn, pald_topk

    topk_c = _build.load("pald_topk_smem_bytes")
    knn_c = _build.load("pald_knn_smem_bytes")
    assert knn_c(k, -1) == pald_knn.smem_per_cta(k)
    for d in (0, 1, 2, 5, 8, 63, 64, 65, 128, 300, 4097):
        assert topk_c(k, d) == pald_topk.smem_per_cta(k, d), (k, d)
        assert knn_c(k, d) == pald_knn.smem_per_cta(k, d), (k, d)
    assert max(topk_c(k, d) for d in range(0, 260)) == \
        pald_topk.smem_per_cta(k)
    assert topk_c(0, 8) == knn_c(0, 8) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["distance", "features"])
def test_cuda_knn_sources_reject_out_of_range_indices(cuda_device, kind):
    """A caller's graph with an index past the rows raises before the
    kernel would read outside X or D."""
    from repro_torch.core.knn import NeighborGraph

    X = torch.rand((40, 3), device=cuda_device)
    x = torch.cdist(X, X) if kind == "distance" else X
    g = ops.topk_select(X, 4)
    idx = g.indices.clone()
    idx[3, 1] = 40
    with pytest.raises(ValueError, match="outside the 40 rows"):
        ops.knn_values(x, NeighborGraph(idx, g.distances), kind=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 32, 256])
@pytest.mark.parametrize("kind", ["distance", "features"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_knn_values_vs_plain(cuda_device, name, kind, k):
    """The values kernel against its plain version on the same gathered
    tiles, to rtol 1e-5 (the sums run in another order)."""
    from repro_torch.core import knn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn

    Xg = torch.as_tensor(_knn_features(300, 5, seed=k), device=cuda_device)
    D = cdist_reference(Xg)
    graph = knn.knn_from_distances(D, k)
    idx = graph.indices
    g = (knn.gather_tile_from_distances(D, idx) if kind == "distance"
         else knn.gather_tile_from_features(Xg, idx, "euclidean"))
    v0 = pald_knn.knn_values_cuda.launches
    vk = pald_knn.knn_values_cuda(graph.distances, g, idx, ties=name)
    vp = pald_knn.knn_values_torch(graph.distances, g, idx, ties=name)
    torch.cuda.synchronize()
    assert pald_knn.knn_values_cuda.launches == v0 + 1
    np.testing.assert_allclose(vk.cpu().numpy(), vp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 32, 33, 100, 1024])
@pytest.mark.parametrize("kind", ["distance", "features"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_knn_sources_bitwise_cube(cuda_device, name, kind, k):
    """The values kernel's features and D sources, which compute or read
    each row's tile themselves, bitwise its cube source on the gathered
    (n, k, k) tiles (one kernel body, the same sums in the same order):
    the tile in shared memory up to k = 64, computed in each pass past it,
    at a ragged n."""
    from repro_torch.core import knn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_knn, pald_topk

    n = 1030 if k == 1024 else 301
    Xg = torch.as_tensor(_knn_features(n, 5, seed=k), device=cuda_device)
    graph = pald_topk.topk_select_cuda(Xg, k)
    idx, dn = graph.indices, graph.distances
    if kind == "distance":
        D = cdist_reference(Xg)
        g = knn.gather_tile_from_distances(D, idx)
        counter = pald_knn.knn_values_from_distances_cuda
        vs = counter(D, dn, idx, ties=name)
    else:
        g = ops._gather_tiles(Xg, idx, "features", "euclidean")
        counter = pald_knn.knn_values_from_features_cuda
        before = counter.launches
        vs = counter(Xg, dn, idx, ties=name)
        assert counter.launches == before + 1
    vk = pald_knn.knn_values_cuda(dn, g, idx, ties=name)
    torch.cuda.synchronize()
    _assert_bitwise(f"{kind} source vs the cube", vs, vk)


@pytest.mark.cuda
def test_cuda_select_cohere_allocates_no_cube(cuda_device):
    """select_cohere on the card holds the graph, the values and the norms
    at most: its peak above the input stays under the (n, k, k) cube's
    bytes."""
    from repro_torch.kernels import ops

    n, k = 4096, 32
    Xg = torch.as_tensor(_knn_features(n, 8, seed=3), device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    graph, vals = ops.select_cohere(Xg, k=k, normalize=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    need = 8 * n * k + 4 * n * (k + 1) + 4 * n
    assert peak <= need + (1 << 20)
    assert peak < 4 * n * k * k
    assert vals.shape == (n, k + 1) and bool(torch.isfinite(vals).all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_knn_facade_matches_cpu(cuda_device, metric):
    """from_features(X, k=...) on the card (the selection kernel and the
    values kernel's features source once each, no dense or fused kernel)
    against the same call on the CPU."""
    from repro_torch.core import pald
    from repro_torch.kernels import pald_fused, pald_knn, pald_topk

    X = _knn_features(300, 7, seed=5)
    counted = (pald_topk.topk_select_cuda,
               pald_knn.knn_values_from_features_cuda,
               pald_knn.knn_values_cuda, pald_fused.focus_fused_cuda,
               pald_focus.focus_general_cuda)
    before = [f.launches for f in counted]
    Cg = pald.from_features(X, metric=metric, k=16, ties="ignore")
    after = [f.launches for f in counted]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0, 0]
    Cc = pald.from_features(X, metric=metric, k=16, ties="ignore",
                            device="cpu")
    np.testing.assert_allclose(Cg.cpu().numpy(), Cc.numpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the tri kernels (the focus kernel's square entry in csrc/pald_focus.cu, and
# csrc/pald_cohesion_tri.cu)
# ---------------------------------------------------------------------------
def _tri_D(n, seed=0):
    """Symmetric float32 distances: multiples of 0.5 (exact ties), a few
    +inf pairs, an exactly-zero diagonal."""
    rng = np.random.default_rng(seed)
    A = rng.integers(1, 8, size=(n, n)).astype(np.float32) * 0.5
    A[rng.random((n, n)) < 0.03] = np.inf
    D = np.triu(A, 1)
    D = D + D.T
    np.fill_diagonal(D, 0.0)
    return D


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 257])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_tri_kernels_vs_plain(cuda_device, name, n):
    from repro_torch.kernels.ref import weights_ref

    D = torch.as_tensor(_tri_D(n, seed=13), device=cuda_device)
    f0 = pald_focus_tri.focus_tri_cuda.launches
    c0 = pald_cohesion_tri.cohesion_tri_cuda.launches
    g0 = pald_cohesion_tri.cohesion_tri_cuda.grid_launches
    Uk = pald_focus_tri.focus_tri_cuda(D, ties=name)
    Up = pald_focus_tri.focus_tri_torch(D, ties=name)
    _assert_u(name, Uk.cpu().numpy(), Up.cpu().numpy())
    if not name.startswith("soft"):  # exact counts: the dense kernel's U
        assert torch.equal(Uk, ops.focus(D, impl="cuda", ties=name))
    W = weights_ref(Up)
    Ck = pald_cohesion_tri.cohesion_tri_cuda(D, W, ties=name)
    Ck2 = pald_cohesion_tri.cohesion_tri_cuda(D, W, ties=name)
    Cp = pald_cohesion_tri.cohesion_tri_torch(D, W, ties=name)
    Cd = ops.cohesion_from_weights(D, W, impl="cuda", ties=name)
    torch.cuda.synchronize()
    assert pald_focus_tri.focus_tri_cuda.launches == f0 + 1
    assert pald_cohesion_tri.cohesion_tri_cuda.launches == c0 + 2
    # one grid a call
    assert pald_cohesion_tri.cohesion_tri_cuda.grid_launches == g0 + 2
    assert torch.equal(Ck, Ck2)
    assert torch.equal(Ck, Cd)
    np.testing.assert_allclose(Ck.cpu().numpy(), Cp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 130, 257])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_cohesion_kernels_ragged(cuda_device, name, n):
    """The dense and the tri cohesion kernels at ragged n on a symmetric,
    tie-heavy D with +inf pairs: each within tolerance of its plain
    version, tri bitwise across two calls and bitwise the dense kernel."""
    from repro_torch.kernels.ref import weights_ref

    D = torch.as_tensor(_tri_D(n, seed=23), device=cuda_device)
    W = weights_ref(pald_focus_tri.focus_tri_torch(D, ties=name))
    Cd = ops.cohesion_from_weights(D, W, impl="cuda", ties=name)
    Cdp = ops.cohesion_from_weights(D, W, impl="torch", ties=name)
    Ct = pald_cohesion_tri.cohesion_tri_cuda(D, W, ties=name)
    Ctp = pald_cohesion_tri.cohesion_tri_torch(D, W, ties=name)
    torch.cuda.synchronize()
    np.testing.assert_allclose(Cd.cpu().numpy(), Cdp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Ct.cpu().numpy(), Ctp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(Ct, pald_cohesion_tri.cohesion_tri_cuda(D, W,
                                                               ties=name))
    assert torch.equal(Ct, Cd)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_cohesion_nonfinite_w(cuda_device, name):
    """An ops-level W with an inf and a nan: the kernels take the multiply
    form and give the plain versions' nan and inf (0 * inf is nan), on
    the asymmetric rectangular operands and on the tri schedule."""
    DXZ, DYZ, DXY, W, _ = [torch.as_tensor(a, device=cuda_device)
                           for a in _operands(63, 65, 130, seed=29)]
    W[3, 7] = np.inf
    W[40, 2] = np.nan
    kw = dict(ties=name, xw_offsets=(3, 8))
    Ck = ops.cohesion_general(DXZ, DYZ, DXY, W, impl="cuda", **kw)
    Cp = pald_cohesion.cohesion_general_torch(DXZ, DYZ, DXY, W, **kw)
    D = torch.as_tensor(_tri_D(130, seed=31), device=cuda_device)
    Ws = torch.as_tensor(np.random.default_rng(31).random((130, 130)),
                         dtype=torch.float32, device=cuda_device)
    Ws = (Ws + Ws.T).contiguous()
    Ws[5, 70] = Ws[70, 5] = np.inf
    Ws[9, 9] = np.nan
    Ct = pald_cohesion_tri.cohesion_tri_cuda(D, Ws, ties=name)
    Ctp = pald_cohesion_tri.cohesion_tri_torch(D, Ws, ties=name)
    torch.cuda.synchronize()
    for got, want in ((Ck, Cp), (Ct, Ctp)):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert not np.isfinite(want).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["dense", "tri"])
def test_cuda_ragged_split_counts_padded_z(cuda_device, schedule):
    """At n = 521 (prime: the reference's Pallas route pads it to 1024 on
    both schedules) the ops-level U under ``split`` on the card is bitwise
    the plain versions', and exceeds the kernel's own U by exactly 0.5 per
    padded z on the +inf pairs."""
    n = 521
    D = _tri_D(n, seed=19)
    Dg = torch.as_tensor(D, device=cuda_device)
    kw = dict(schedule=schedule, ties="split")
    Ug = ops.focus(Dg, impl="cuda", **kw).cpu()
    assert torch.equal(Ug, ops.focus(torch.from_numpy(D), impl="torch",
                                     **kw))
    if schedule == "tri":
        raw = pald_focus_tri.focus_tri_cuda(Dg, ties="split")
    else:
        raw = pald_focus.focus_general_cuda(Dg, Dg, Dg, ties="split")
    np.testing.assert_array_equal(Ug.numpy() - raw.cpu().numpy(),
                                  0.5 * (1024 - n) * np.isinf(D))
    assert np.isinf(D).any()


@pytest.mark.cuda
def test_cuda_tri_wrappers_reject_bad_operands(cuda_device):
    a = torch.zeros((8, 8), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        pald_focus_tri.focus_tri_cuda(a.double())
    with pytest.raises(ValueError, match="shape"):
        pald_cohesion_tri.cohesion_tri_cuda(a, a[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        pald_focus_tri.focus_tri_cuda(a.T[:4, :4])
    user = tw.WeightFunctional("_user_cuda_tri", tw.DROP.focus,
                               lambda o, t, p, w=None: torch.cos(o))
    with pytest.raises(NotImplementedError, match="aten.cos"):
        pald_focus_tri.focus_tri_cuda(a, ties=user)
    with pytest.raises(NotImplementedError, match="aten.cos"):
        pald_cohesion_tri.cohesion_tri_cuda(a, a, ties=user)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_tri_cohesion_matches_cpu(cuda_device, name):
    """The facade with schedule='tri' on its default device (the GPU,
    through both tri kernels and no dense one) against the same call on
    the CPU (the plain versions)."""
    from repro_torch.core import pald

    D = _tri_D(200, seed=17)
    counters = (pald_focus_tri.focus_tri_cuda,
                pald_cohesion_tri.cohesion_tri_cuda,
                pald_focus.focus_general_cuda,
                pald_cohesion.cohesion_general_cuda)
    before = [f.launches for f in counters]
    Cg = pald.cohesion(D, method="kernel", schedule="tri", weight=name)
    assert Cg.device.type == "cuda" and Cg.dtype == torch.float32
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]
    Cc = pald.cohesion(D, method="kernel", schedule="tri", weight=name,
                       device="cpu")
    np.testing.assert_allclose(Cg.cpu().numpy(), Cc.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_default_cohesion_runs_tri_kernels(cuda_device, name):
    """``pald.cohesion(D)`` past n = 256 resolves to ``method="triplet"``,
    which on the card runs the tri kernels (and no dense one), against
    the same call on the CPU (the plain versions)."""
    from repro_torch.core import pald

    D = _tri_D(300, seed=19)
    assert pald.plan(D, weight=name).explain()["method"] == "triplet"
    counters = (pald_focus_tri.focus_tri_cuda,
                pald_cohesion_tri.cohesion_tri_cuda,
                pald_focus.focus_general_cuda,
                pald_cohesion.cohesion_general_cuda)
    before = [f.launches for f in counters]
    Cg = pald.cohesion(D, weight=name)
    assert Cg.device.type == "cuda" and Cg.dtype == torch.float32
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]
    Cc = pald.cohesion(D, weight=name, device="cpu")
    np.testing.assert_allclose(Cg.cpu().numpy(), Cc.numpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the focus kernel's square entry (csrc/pald_focus.cu), the dense and tri
# schedules' pass 1: upper tile pairs, a tile mirrored when its thresholds
# are symmetric
# ---------------------------------------------------------------------------
def _upper_pairs(n):
    nb = -(-n // pald_focus.TILE)
    return nb * (nb + 1) // 2


def _asymmetric(D, tiles, seed=0):
    """D with the thresholds of the given 64 x 64 tiles (X, Y) perturbed
    (by +-0.5, kept >= 0), so that D[x, y] != D[y, x] there."""
    rng = np.random.default_rng(seed)
    D = D.copy()
    t = pald_focus.TILE
    for bx, by in tiles:
        blk = D[bx * t:(bx + 1) * t, by * t:(by + 1) * t]
        step = rng.choice([-0.5, 0.5], size=blk.shape).astype(np.float32)
        blk[...] = np.abs(blk + step)
    return D


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 130, 257])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_focus_square_and_tri_vs_plain(cuda_device, name, n):
    """``ops.focus(D)`` on a symmetric D runs the square entry over the
    nb (nb + 1) / 2 upper tile pairs with no second z loop: U against the
    plain version (bitwise except soft), the tri entry's U bitwise the
    dense one's for every family (the same code), and the rectangular
    entry's U (every tile, both orders) bitwise too.  n not a multiple of
    4 takes the 4-byte copies."""
    D = torch.as_tensor(_tri_D(n, seed=37), device=cuda_device)
    f0 = pald_focus.focus_general_cuda.launches
    t0 = pald_focus_tri.focus_tri_cuda.launches
    pald_focus.reset_tile_counts()
    Uk = ops.focus(D, impl="cuda", ties=name)
    Up = ops.focus(D, impl="torch", ties=name)
    _assert_u(name, Uk.cpu().numpy(), Up.cpu().numpy())
    Ut = ops.focus(D, impl="cuda", schedule="tri", ties=name)
    _assert_bitwise("tri vs dense", Ut, Uk)
    Ur = pald_focus.focus_general_cuda(D, D.clone(), D.clone(), ties=name)
    assert pald_focus.focus_general_cuda.launches - f0 == 2
    assert pald_focus_tri.focus_tri_cuda.launches - t0 == 1
    # blocks run on the card: the upper pairs twice (dense, tri) and every
    # tile once (rectangular); no tile pair ran its mirror apart
    assert pald_focus.tile_counts(cuda_device) == (
        2 * _upper_pairs(n) + (-(-n // 64)) ** 2, 0)
    _assert_bitwise("rectangular entry vs square", Ur, Uk)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,tiles,reverse", [
    ("one off-diagonal tile", 257, [(1, 3)], 1),
    ("one off-diagonal tile, n % 4 == 0", 200, [(0, 2)], 1),
    ("the mirror tile", 200, [(2, 0)], 1),
    ("one diagonal tile", 130, [(1, 1)], 0),
    ("every tile", 130, "all", 3),
])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_focus_square_asymmetric(cuda_device, name, case, n, tiles,
                                      reverse):
    """A square asymmetric D through ``ops.focus(D)``: U equals
    ``focus_general_torch(D, D, D)`` (bitwise except soft) and is bitwise
    the rectangular entry's; only the upper pairs whose thresholds are
    not symmetric ran the second z loop."""
    D = _tri_D(n, seed=41)
    if tiles == "all":
        D = _asymmetric(D, [(x, y) for x in range(-(-n // 64))
                            for y in range(-(-n // 64))], seed=43)
    else:
        D = _asymmetric(D, tiles, seed=43)
    assert not np.array_equal(D, D.T)
    Dg = torch.as_tensor(D, device=cuda_device)
    pald_focus.reset_tile_counts()
    Uk = ops.focus(Dg, impl="cuda", ties=name)
    assert pald_focus.tile_counts(cuda_device) == (_upper_pairs(n),
                                                   reverse), case
    Up = pald_focus.focus_general_torch(Dg, Dg, Dg, ties=name)
    _assert_u(name, Uk.cpu().numpy(), Up.cpu().numpy())
    Ur = pald_focus.focus_general_cuda(Dg, Dg.clone(), Dg.clone(),
                                       ties=name)
    _assert_bitwise(f"rectangular entry vs square, {case}", Ur, Uk)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [521, 130])
def test_cuda_focus_square_asymmetric_split_pads(cuda_device, n):
    """An asymmetric D with +inf entries at a ragged n under ``split``:
    the ops-level U on the card is bitwise the plain versions', padded z
    counted once (0.5 each on the +inf thresholds, in either order)."""
    D = _asymmetric(_tri_D(n, seed=47), [(0, 1), (1, 1)], seed=53)
    D[5, 70] = np.inf  # an +inf threshold whose mirror is finite
    D[70, 5] = 1.5
    Ug = ops.focus(torch.as_tensor(D, device=cuda_device), impl="cuda",
                   ties="split").cpu()
    Up = ops.focus(torch.from_numpy(D), impl="torch", ties="split")
    _assert_bitwise("split U on the card vs plain", Ug, Up)
    raw = pald_focus.focus_general_torch(torch.from_numpy(D),
                                         torch.from_numpy(D),
                                         torch.from_numpy(D), ties="split")
    pad = ops._padded_extent(n, 512) - n
    np.testing.assert_array_equal(Ug.numpy() - raw.numpy(),
                                  0.5 * pad * np.isinf(D))


@pytest.mark.cuda
def test_cuda_focus_block_counters(cuda_device):
    """The kernel counts the thread blocks a grid ran
    (``pald_focus.tile_counts``): every tile of a rectangular U, the upper
    pairs of a square D, dense or tri; ``.grid_launches`` one grid a
    call."""
    DXZ, DYZ, DXY, _, _ = [torch.as_tensor(a, device=cuda_device)
                           for a in _operands(130, 70, 257, seed=59)]
    D = torch.as_tensor(_tri_D(257, seed=61), device=cuda_device)
    f, t = pald_focus.focus_general_cuda, pald_focus_tri.focus_tri_cuda
    before = (f.launches, f.grid_launches, t.launches, t.grid_launches)
    pald_focus.reset_tile_counts()
    ops.focus_general(DXZ, DYZ, DXY, impl="cuda")
    assert pald_focus.tile_counts(cuda_device) == (3 * 2, 0)
    ops.focus(D, impl="cuda")
    assert pald_focus.tile_counts(cuda_device) == (3 * 2 + 15, 0)
    ops.focus(D, impl="cuda", schedule="tri")
    assert pald_focus.tile_counts(cuda_device) == (3 * 2 + 30, 0)
    after = (f.launches, f.grid_launches, t.launches, t.grid_launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 1, 1]
    pald_focus.reset_tile_counts()
    assert pald_focus.tile_counts(cuda_device) == (0, 0)
    assert pald_focus.focus_blocks(8192, 8192, True) == 8256
    assert pald_focus.focus_blocks(8192, 8192, False) == 16384


@pytest.mark.cuda
def test_cuda_property_laws_through_focus_kernels(cuda_device):
    """The reference's laws (tests/test_pald_properties.py) through the
    CUDA kernels, at n across the 64-row tiles so that the square and tri
    focus entries mirror off-diagonal tiles: mass n/2 on tie-free input
    (dense and tri pipelines), permutation equivariance (U bitwise, C to
    rtol 1e-4 as the reference), and no tile of a distance matrix ran the
    second z loop."""
    from hypothesis import given, settings, strategies as st
    from repro_torch.core import pald

    @settings(max_examples=10, deadline=None)
    @given(st.integers(60, 200), st.integers(0, 2**32 - 1))
    def laws(n, seed):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 3)) * rng.uniform(0.1, 10.0)
        D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
        np.fill_diagonal(D, 0.0)
        D = D.astype(np.float32)
        iu = np.triu_indices(n, 1)
        tie_free = len(np.unique(D[iu])) == len(iu[0])
        perm = rng.permutation(n)
        Dg = torch.as_tensor(D, device=cuda_device)
        Dp = torch.as_tensor(D[np.ix_(perm, perm)], device=cuda_device)
        pald_focus.reset_tile_counts()
        U = ops.focus(Dg, impl="cuda")
        Up = ops.focus(Dp, impl="cuda")
        assert pald_focus.tile_counts(cuda_device)[1] == 0
        pt = torch.as_tensor(perm, device=cuda_device)
        assert torch.equal(Up, U[pt][:, pt])
        for sched in ("dense", "tri"):
            C = pald.cohesion(Dg, method="kernel", schedule=sched)
            Cp = pald.cohesion(Dp, method="kernel", schedule=sched)
            C, Cp = C.cpu().numpy(), Cp.cpu().numpy()
            if tie_free:
                assert abs(C.sum() - n / 2) < 1e-3 * n, sched
            np.testing.assert_allclose(Cp, C[np.ix_(perm, perm)],
                                       rtol=1e-4, atol=1e-5)

    laws()


# ---------------------------------------------------------------------------
# guarded execution and batch chunks on the card
# ---------------------------------------------------------------------------
KERNEL_CELLS = [("distance", "kernel", "dense"), ("distance", "kernel", "tri"),
                ("distance", "knn", "dense"), ("features", "fused", "dense"),
                ("features", "kernel", "dense"), ("features", "kernel", "tri"),
                ("features", "knn", "dense")]


def _cell_input(kind, n, dev, seed=0):
    if kind == "features":
        return torch.as_tensor(_features(n, 4, seed=seed), device=dev)
    return torch.as_tensor(_tri_D(n, seed=seed), device=dev)


def _cell_plan(cell, x, dev, **kw):
    from repro_torch.core import pald

    kind, method, schedule = cell
    if method == "knn":
        kw["k"] = 8
    return pald.plan(x, kind=kind, method=method, schedule=schedule,
                     ties="ignore", device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", KERNEL_CELLS, ids=["-".join(c)
                                                    for c in KERNEL_CELLS])
def test_cuda_dead_kernels_end_exhausted_on_the_card(cuda_device, cell):
    """``fail_kernel(impl="cuda")``: every CUDA entry point dies, and a
    plan on the card is not answered by a plain version or the host: each
    rung is unavailable, the call ends in ``FallbackExhausted`` chained
    from the injected failure, nothing is recorded, and the kernels answer
    again once the fault is gone."""
    from repro_torch.core import resilience
    from repro_torch.testing import faults

    x = _cell_input(cell[0], 150, cuda_device, seed=3)
    strict = _cell_plan(cell, x, cuda_device).execute(x)
    p = _cell_plan(cell, x, cuda_device, on_error="fallback")
    labels = [s.label for s in resilience.chain_for(p)]
    assert labels and "impl:cuda" not in labels
    faults.reset()
    try:
        with faults.fail_kernel(impl="cuda") as rule:
            with pytest.raises(resilience.FallbackExhausted) as ei:
                p.execute(x)
    finally:
        faults.reset()
    assert rule.trips == 1
    assert "injected fault" in str(ei.value.__cause__)
    for label in labels:
        assert f"{label}: FallbackUnavailable" in str(ei.value), label
    assert p.explain()["degradations"] == []
    _assert_bitwise(f"{cell} after the fault", p.execute(x), strict)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["dense", "tri"])
def test_cuda_fallback_plan_without_fault_runs_the_kernels(cuda_device,
                                                           schedule):
    from repro_torch.core import pald

    D = torch.as_tensor(_tri_D(200, seed=5), device=cuda_device)
    focus = (pald_focus_tri.focus_tri_cuda if schedule == "tri"
             else pald_focus.focus_general_cuda)
    coh = (pald_cohesion_tri.cohesion_tri_cuda if schedule == "tri"
           else pald_cohesion.cohesion_general_cuda)
    strict = pald.cohesion(D, method="kernel", schedule=schedule)
    f0, c0 = focus.launches, coh.launches
    p = pald.plan(D, method="kernel", schedule=schedule, on_error="fallback")
    out = p.execute(D)
    assert (focus.launches, coh.launches) == (f0 + 1, c0 + 1)
    assert p.explain()["degradations"] == []
    _assert_bitwise(f"fallback plan {schedule}", out, strict)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 130, 257])
@pytest.mark.parametrize("schedule", ["dense", "tri"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_chunk_one_grid_bitwise_items(cuda_device, name, schedule, n):
    """A chunk of b = 5 symmetric, tie-heavy D through ``ops.pald``: one
    launch (one grid) per pass for the chunk, the focus kernel's blocks
    b x the upper tile pairs (counted on the card), U and C bitwise the
    items one at a time."""
    b = 5
    Db = torch.as_tensor(np.stack([_tri_D(n, seed=40 + i) for i in range(b)]),
                         device=cuda_device)
    tri = schedule == "tri"
    focus = (pald_focus_tri.focus_tri_cuda if tri
             else pald_focus.focus_general_cuda)
    coh = (pald_cohesion_tri.cohesion_tri_cuda if tri
           else pald_cohesion.cohesion_general_cuda)
    f0, fg0 = focus.launches, focus.grid_launches
    c0, cg0 = coh.launches, coh.grid_launches
    pald_focus.reset_tile_counts()
    Ub = ops.focus(Db, impl="cuda", schedule=schedule, ties=name)
    Cb = ops.pald(Db, impl="cuda", schedule=schedule, ties=name)
    blocks, twice = pald_focus.tile_counts(cuda_device)
    assert (focus.launches, focus.grid_launches) == (f0 + 2, fg0 + 2)
    assert (coh.launches, coh.grid_launches) == (c0 + 1, cg0 + 1)
    assert blocks == 2 * b * pald_focus.focus_blocks(n, n, True)
    assert twice == 0
    for i in range(b):
        _assert_bitwise(f"U item {i}", Ub[i],
                        ops.focus(Db[i], impl="cuda", schedule=schedule,
                                  ties=name))
        _assert_bitwise(f"C item {i}", Cb[i],
                        ops.pald(Db[i], impl="cuda", schedule=schedule,
                                 ties=name))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["dense", "tri"])
def test_cuda_engine_chunks_bitwise(cuda_device, schedule):
    """``cohesion(Db, batch=b)`` on the card: every chunk size gives the
    per-item C bitwise; the kernels launch once per chunk and pass."""
    from repro_torch.core import pald

    Db = torch.as_tensor(np.stack([_tri_D(190, seed=60 + i)
                                   for i in range(7)]), device=cuda_device)
    coh = (pald_cohesion_tri.cohesion_tri_cuda if schedule == "tri"
           else pald_cohesion.cohesion_general_cuda)
    one = pald.cohesion(Db, method="kernel", schedule=schedule, batch=1)
    for b in (2, 3, 7, None):
        c0 = coh.launches
        out = pald.cohesion(Db, method="kernel", schedule=schedule, batch=b)
        assert coh.launches - c0 == -(-7 // (b or 7))
        _assert_bitwise(f"batch={b}", out, one)


@pytest.mark.cuda
@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("name", ["drop", "ignore", "kernelized"])
def test_cuda_chunk_nonfinite_item_keeps_finite_bits(cuda_device, name, tri):
    """``add_form`` decides once per chunk: one item with an infinite W
    sends the chunk to the multiply form, and the finite items keep the
    bits of their own (predicated) calls."""
    b, n = 3, 130
    D = torch.as_tensor(np.stack([_tri_D(n, seed=70 + i) for i in range(b)]),
                        device=cuda_device)
    W = torch.as_tensor(np.random.default_rng(7).random((b, n, n)),
                        dtype=torch.float32, device=cuda_device)
    W = (W + W.transpose(1, 2)).contiguous()
    W[1, 5, 70] = W[1, 70, 5] = np.inf
    wid = tw.kernel_spec(name)[0]
    assert pald_cohesion.add_form(wid, W) == 0
    assert pald_cohesion.add_form(wid, W[0]) == 1
    if tri:
        run = lambda d, w: pald_cohesion_tri.cohesion_tri_cuda(  # noqa: E731
            d, w, ties=name)
    else:
        run = lambda d, w: pald_cohesion.cohesion_general_cuda(  # noqa: E731
            d, d, d, w, ties=name, xw_offsets=(0, 0))
    Cb = run(D, W)
    for i in (0, 2):
        _assert_bitwise(f"finite item {i}", Cb[i], run(D[i], W[i]))
    got, want = Cb[1].cpu().numpy(), run(D[1], W[1]).cpu().numpy()
    assert not np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)  # nan where nan, bits else


@pytest.mark.cuda
def test_cuda_knn_beyond_the_kernel_limit(cuda_device):
    """k = 2048 (past ``LARGE_K`` = 1024) on the features k-NN cell runs on
    the kernels' large-k variants under "raise" and under "fallback",
    which records no degradation: the graph bitwise the plain selection's,
    the values within rtol 1e-5, atol 1e-6 of the plain version's on a
    16-row slab."""
    from repro_torch.core import pald
    from repro_torch.core import knn as tknn
    from repro_torch.kernels import pald_knn, pald_topk

    X = torch.as_tensor(_features(2060, 2, seed=9), device=cuda_device)
    k, r0 = 2048, 1000
    wrappers = (pald_topk.topk_select_cuda,
                pald_knn.knn_values_from_features_cuda)
    for on_error in ("raise", "fallback"):
        before = [f.large_launches for f in wrappers]
        p = pald.plan(X, kind="features", k=k, block=32, on_error=on_error,
                      normalize=False)
        C = p.execute(X)
        assert [f.large_launches for f in wrappers] == [b + 1 for b in before]
        assert p.explain()["degradations"] == []
    graph, vals = ops.select_cohere(X, k=k)
    gp = pald_topk.topk_select_torch(X.cpu(), k)
    _assert_bitwise("graph indices", graph.indices.cpu(), gp.indices)
    _assert_bitwise("graph distances", graph.distances.cpu(), gp.distances)
    sl = slice(r0, r0 + 16)
    vp = pald_knn.knn_values_from_features_torch(
        X.cpu(), gp.distances[sl], gp.indices[sl], row_off=r0)
    torch.testing.assert_close(vals[sl].cpu(), vp, rtol=RTOL, atol=ATOL)
    _assert_bitwise("C", C.cpu(), tknn.scatter_dense(graph, vals).cpu())


@pytest.mark.cuda
def test_cuda_knn_large_k_distance_source(cuda_device):
    """``cohesion(D, method="knn", k=2048)``: the D source's large-k
    variant once, C within rtol 1e-5, atol 1e-6 of the plain values on a
    16-row slab, and bitwise the features source on the X D came from."""
    from repro_torch.core import pald
    from repro_torch.core import knn as tknn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn

    X = torch.as_tensor(_features(2100, 3, seed=13), device=cuda_device)
    D = cdist_reference(X)
    k, r0 = 2048, 700
    src = pald_knn.knn_values_from_distances_cuda
    before = src.large_launches
    C = pald.cohesion(D, method="knn", k=k, normalize=False)
    assert src.large_launches == before + 1
    g = tknn.knn_from_distances(D, k)
    vd = src(D, g.distances, g.indices)
    _assert_bitwise("C", C, tknn.scatter_dense(g, vd))
    _assert_bitwise("D source vs features source", vd,
                    pald_knn.knn_values_from_features_cuda(X, g.distances,
                                                           g.indices))
    sl = slice(r0, r0 + 16)
    gs = tknn.gather_tile_from_distances(D.cpu(), g.indices[sl].cpu())
    vp = pald_knn.knn_values_torch(g.distances[sl].cpu(), gs,
                                   g.indices[sl].cpu(), row_off=r0)
    torch.testing.assert_close(vd[sl].cpu(), vp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 64])
@pytest.mark.parametrize("name", ["ignore", "soft"])
def test_cuda_knn_large_k_chunk_bitwise_items(cuda_device, name, d):
    """A chunk of b = 2 items at n = 2100, k = 2048 (d = 4 and 64): the
    selection and the values' features and D sources one launch each,
    each item bitwise the item alone; the block entry on two candidate
    blocks, merged, bitwise the full call."""
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn, pald_topk

    b, n, k = 2, 2100, 2048
    Xb = torch.as_tensor(np.stack([_features(n, d, seed=60 + i)
                                   for i in range(b)]), device=cuda_device)
    Db = torch.stack([cdist_reference(x) for x in Xb])
    sel = pald_topk.topk_select_cuda
    before = sel.large_launches
    gb = sel(Xb, k)
    assert sel.large_launches == before + 1
    for src, x in ((pald_knn.knn_values_from_features_cuda, Xb),
                   (pald_knn.knn_values_from_distances_cuda, Db)):
        before = src.large_launches
        vb = src(x, gb.distances, gb.indices, ties=name)
        assert src.large_launches == before + 1
        for i in range(b):
            gi = sel(Xb[i], k)
            _assert_bitwise(f"graph item {i}", gb.indices[i], gi.indices)
            _assert_bitwise(f"{src.__name__} item {i}", vb[i],
                            src(x[i], gi.distances, gi.indices, ties=name))
    X, full = Xb[0], gb
    parts = [pald_topk.topk_block_cuda(X, X[a:e], k, col_off=a)
             for a, e in ((0, 1000), (1000, n))]
    v, i = pald_topk.merge_pairs(torch.cat([p.distances for p in parts], 1),
                                 torch.cat([p.indices for p in parts], 1), k)
    _assert_bitwise("merged block entries", i, full.indices[0])
    _assert_bitwise("merged block distances", v, full.distances[0])


# the redesigned large-k kernels: the selection by threshold on every
# metric and entry, the values' register tiles at every width
N_LARGE = 2100


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1025, 1040, 2048, N_LARGE - 1])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_topk_large_k_vs_plain(cuda_device, metric, k):
    """Past 1024 the selection by threshold, bitwise its plain version
    (indices and distances) on tie-heavy quantized rows with duplicated
    points (many ties at the k-th value), at d = 5 and 300 (the rows
    staged once, and riding in each slot)."""
    from repro_torch.kernels import pald_topk

    sel = pald_topk.topk_select_cuda
    for d in (5, 300):
        Xg = torch.as_tensor(_knn_features(N_LARGE, d, seed=k + d),
                             device=cuda_device)
        before = sel.large_launches
        gk = sel(Xg, k, metric=metric)
        assert sel.large_launches == before + 1
        gp = pald_topk.topk_select_torch(Xg, k, metric=metric)
        _assert_bitwise(f"indices d={d}", gk.indices, gp.indices)
        _assert_bitwise(f"distances d={d}", gk.distances, gp.distances)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_topk_large_k_block_entry_merges_to_the_full_call(cuda_device,
                                                               metric):
    """The block entry past 1024 on three candidate blocks (one with
    fewer candidates than k, one holding the rows themselves): each
    bitwise its plain version, (+inf, INT32_MAX) past the real candidates
    included, and merged on the (value, index) key bitwise the full
    call's rows."""
    from repro_torch.kernels import pald_topk

    k, r0, m = 1500, 700, 40
    Xg = torch.as_tensor(_knn_features(N_LARGE, 6, seed=11),
                         device=cuda_device)
    full = pald_topk.topk_select_cuda(Xg, k, metric=metric)
    rows = Xg[r0:r0 + m]
    bv = bi = None
    for c0, c1 in ((0, 600), (600, 1800), (1800, N_LARGE)):
        blk = Xg[c0:c1].contiguous()
        gk = pald_topk.topk_block_cuda(rows, blk, k, metric=metric,
                                       row_off=r0, col_off=c0)
        gp = pald_topk.topk_block_torch(rows, blk, k, metric=metric,
                                        row_off=r0, col_off=c0)
        _assert_bitwise(f"block {c0} indices", gk.indices, gp.indices)
        _assert_bitwise(f"block {c0} distances", gk.distances, gp.distances)
        if bv is None:
            bv, bi = gk.distances, gk.indices
        else:
            bv, bi = pald_topk.merge_pairs(torch.cat([bv, gk.distances], 1),
                                           torch.cat([bi, gk.indices], 1), k)
    _assert_bitwise("merged indices", bi, full.indices[r0:r0 + m])
    _assert_bitwise("merged distances", bv, full.distances[r0:r0 + m])


@pytest.mark.cuda
def test_cuda_topk_large_k_sorts_past_shared_memory(cuda_device):
    """Past ``SORT_CAP`` entries below the k-th value the selection sorts
    a row in its outputs: the block entry's 16 rows against 20,000
    candidates at k = 17,000, bitwise the plain version."""
    from repro_torch.kernels import pald_topk

    Xg = torch.as_tensor(_knn_features(20_000, 3, seed=2),
                         device=cuda_device)
    k = 17_000
    assert k > pald_topk.SORT_CAP
    gk = pald_topk.topk_block_cuda(Xg[:16], Xg, k)
    gp = pald_topk.topk_block_torch(Xg[:16], Xg, k)
    _assert_bitwise("indices", gk.indices, gp.indices)
    _assert_bitwise("distances", gk.distances, gp.distances)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 16, 17, 24, 33, 64, 65, 300])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_knn_large_k_values_vs_plain(cuda_device, name, d):
    """The values past 1024 in register tiles at d = 3, 8, 16
    (``pald_knn_large.cu``), 17, 24, 33, 64 (``pald_knn_wide.cu``, widths
    32 and 64) and 65, 300 (``pald_knn_piece.cu``, pieces of 32
    features): within rtol 1e-5,
    atol 1e-6 of the plain version on a 16-row slab, and for an exact
    family bitwise the D source (its sweep)."""
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn, pald_topk

    Xg = torch.as_tensor(_knn_features(N_LARGE, d, seed=d),
                         device=cuda_device)
    g = pald_topk.topk_select_cuda(Xg, 2048)
    src = pald_knn.knn_values_from_features_cuda
    before = src.large_launches
    vk = src(Xg, g.distances, g.indices, ties=name)
    assert src.large_launches == before + 1
    sl = slice(900, 916)
    vp = pald_knn.knn_values_from_features_torch(
        Xg, g.distances[sl], g.indices[sl], ties=name, row_off=900)
    torch.testing.assert_close(vk[sl], vp, rtol=RTOL, atol=ATOL)
    if name in ("drop", "split", "ignore"):
        vd = pald_knn.knn_values_from_distances_cuda(
            cdist_reference(Xg), g.distances, g.indices, ties=name)
        _assert_bitwise("features vs D source", vk, vd)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 64])
@pytest.mark.parametrize("name", ["ignore", "soft"])
def test_cuda_knn_large_k_values_row_offset_and_neighbor_rows(cuda_device,
                                                              name, d):
    """The register tiles on a slice of the graph's rows with their global
    offset (the index tiebreak's), and fed the rows' own (m, k, d)
    neighbor features: bitwise the full call's rows, at widths 8 and 64."""
    from repro_torch.kernels import pald_knn, pald_topk

    Xg = torch.as_tensor(_knn_features(N_LARGE, d, seed=21),
                         device=cuda_device)
    g = pald_topk.topk_select_cuda(Xg, 1500)
    full = pald_knn.knn_values_from_features_cuda(Xg, g.distances,
                                                  g.indices, ties=name)
    r0, m = 300, 64
    dn = g.distances[r0:r0 + m].contiguous()
    idx = g.indices[r0:r0 + m].contiguous()
    part = pald_knn.knn_values_from_features_cuda(Xg, dn, idx, ties=name,
                                                  row_off=r0)
    _assert_bitwise("row offset", part, full[r0:r0 + m])
    nbr = pald_knn.knn_values_from_neighbors_cuda(
        Xg[idx.long()].contiguous(), dn, idx, ties=name, row_off=r0)
    _assert_bitwise("neighbor rows", nbr, part)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONALS + ["smooth"])
def test_cuda_knn_large_k_values_at_1024_vs_the_layout(cuda_device,
                                                       user_libraries, name):
    """At k = 1024, routed to the large-k variant (``LARGE_K`` = 0 for the
    call), the register-tile values bitwise the four-rows-a-block layout
    for a family whose focus is an exact count, within rtol 1e-5, atol
    1e-6 for soft, kernelized and a smooth user functional with a share."""
    from repro_torch.kernels import pald_knn, pald_topk

    ties = SMOOTH if name == "smooth" else name
    Xg = torch.as_tensor(_knn_features(1100, 8, seed=4), device=cuda_device)
    g = pald_topk.topk_select_cuda(Xg, 1024)
    src = pald_knn.knn_values_from_features_cuda
    vs = src(Xg, g.distances, g.indices, ties=ties)
    saved = pald_knn.LARGE_K
    pald_knn.LARGE_K = 0
    try:
        before = src.large_launches
        vl = src(Xg, g.distances, g.indices, ties=ties)
        assert src.large_launches == before + 1
    finally:
        pald_knn.LARGE_K = saved
    if name in ("drop", "split", "ignore"):
        _assert_bitwise("register tiles vs layout", vl, vs)
    else:
        torch.testing.assert_close(vl, vs, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1025, 2048, N_LARGE - 1])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_knn_large_k_distance_source_vs_plain(cuda_device, name, k):
    """The D source past 1024 (one sweep of each row's tile in ascending
    column order) on tie-heavy rows with duplicated points: within rtol
    1e-5, atol 1e-6 of the plain version on a 16-row slab, and for an
    exact family bitwise the features source."""
    from repro_torch.core import knn as tknn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn

    Xg = torch.as_tensor(_knn_features(N_LARGE, 4, seed=k),
                         device=cuda_device)
    D = cdist_reference(Xg)
    g = tknn.knn_from_distances(D, k)
    src = pald_knn.knn_values_from_distances_cuda
    before = src.large_launches
    vd = src(D, g.distances, g.indices, ties=name)
    assert src.large_launches == before + 1
    sl = slice(1000, 1016)
    vp = pald_knn.knn_values_torch(
        g.distances[sl], tknn.gather_tile_from_distances(D, g.indices[sl]),
        g.indices[sl], ties=name, row_off=1000)
    torch.testing.assert_close(vd[sl], vp, rtol=RTOL, atol=ATOL)
    if name in ("drop", "split", "ignore"):
        vf = pald_knn.knn_values_from_features_cuda(Xg, g.distances,
                                                    g.indices, ties=name)
        _assert_bitwise("D source vs features source", vd, vf)


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows", [(4100, 4), (16400, 2)])
@pytest.mark.parametrize("name", ["ignore", "soft"])
def test_cuda_knn_large_k_distance_source_in_pieces(cuda_device, name, k,
                                                    rows):
    """Past 4096 columns the D source runs pass 1 over every piece of 4096
    sorted columns, then pass 2 a piece at a time; past 16384 its sorted
    positions sit in the scratch: the first rows of the graph within rtol
    1e-5, atol 1e-6 of the plain version, and for ``ignore`` bitwise the
    features source."""
    from repro_torch.core import knn as tknn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn, pald_topk

    assert pald_knn.sweep_layout(k)[1] > 1
    Xg = torch.as_tensor(_knn_features(k + 100, 4, seed=k),
                         device=cuda_device)
    D = cdist_reference(Xg)
    g = pald_topk.topk_select_torch(Xg, k, rows=(0, rows))
    vd = pald_knn.knn_values_from_distances_cuda(D, g.distances, g.indices,
                                                 ties=name)
    vp = pald_knn.knn_values_torch(
        g.distances, tknn.gather_tile_from_distances(D, g.indices),
        g.indices, ties=name)
    torch.testing.assert_close(vd, vp, rtol=RTOL, atol=ATOL)
    if name == "ignore":
        vf = pald_knn.knn_values_from_features_cuda(Xg, g.distances,
                                                    g.indices, ties=name)
        _assert_bitwise("D source vs features source", vd, vf)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, None])
@pytest.mark.parametrize("schedule", ["dense", "tri"])
def test_cuda_batched_peak_memory_is_the_chunks(cuda_device, schedule,
                                                batch):
    """A batched call holds one chunk's working buffers at a time: its
    peak above the input is at least a chunk of b items' U, W and W's bool
    mask (2.25 n^2 float32 each) and at most that plus the whole output
    when the batch runs in more than one chunk (``batch=None`` is one
    chunk of all B items: bound memory with ``batch=``)."""
    from repro_torch.core import pald

    B, n = 6, 512
    Db = torch.as_tensor(np.stack([_tri_D(n, seed=80 + i) for i in range(B)]),
                         device=cuda_device)
    p = pald.plan(Db, method="kernel", schedule=schedule, batch=batch)
    want = p.execute(Db)  # builds, and allocates the focus counters
    # garbage of earlier tests (reference cycles holding CUDA tensors)
    # freed by a collection inside the measured call would lower its peak
    gc.collect()
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out = p.execute(Db)
    torch.cuda.synchronize(cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    b, item = (batch or B), 4 * n * n
    lo = 2.25 * b * item
    hi = lo + (B * item if b < B else 0) + (1 << 20)
    assert lo <= peak <= hi, (schedule, batch, peak / item)
    _assert_bitwise(f"batch={batch}", out, want)


# ---------------------------------------------------------------------------
# chunks through the fused, selection and k-NN values kernels: one launch a
# chunk, the item on a grid axis, each item bitwise alone
# ---------------------------------------------------------------------------
def _chunk_features(b, n, d, seed):
    return torch.as_tensor(np.stack([_features(n, d, seed=seed + i)
                                     for i in range(b)]))


def _launches(*wrappers):
    return [(w.launches, w.grid_launches) for w in wrappers]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 130, 200])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_fused_chunk_one_launch_bitwise_items(cuda_device, name, metric,
                                                   n):
    """A chunk of b = 5 tie-heavy items through both fused kernels: one
    launch each (its grids: the norms once, then a panel writer and a pass
    per panel), U and C bitwise each item alone, at the chunk's panel and
    at P = 64."""
    from repro_torch.kernels import pald_fused
    from repro_torch.kernels.ref import weights_ref

    b = 5
    Xb = _chunk_features(b, n, 5, seed=90).to(cuda_device)
    f, c = pald_fused.focus_fused_cuda, pald_fused.cohesion_fused_cuda
    before = _launches(f, c)
    Ub = f(Xb, metric=metric, ties=name)
    Wb = weights_ref(Ub)
    Cb = c(Xb, Wb, metric=metric, ties=name)
    grids = pald_fused.fused_grids(n, metric, items=b)
    assert _launches(f, c) == [(before[0][0] + 1, before[0][1] + grids),
                               (before[1][0] + 1, before[1][1] + grids)]
    for P in (None, 64):
        _assert_bitwise(f"U P={P}", f(Xb, metric=metric, ties=name,
                                      _panel_rows=P), Ub)
        _assert_bitwise(f"C P={P}", c(Xb, Wb, metric=metric, ties=name,
                                      _panel_rows=P), Cb)
    for i in range(b):
        Ui = f(Xb[i], metric=metric, ties=name)
        _assert_bitwise(f"U item {i}", Ub[i], Ui)
        _assert_bitwise(f"C item {i}", Cb[i],
                        c(Xb[i], weights_ref(Ui), metric=metric, ties=name))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2, 1), (200, 7), (200, 32), (257, 100)])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_topk_chunk_one_launch_bitwise_items(cuda_device, metric, n, k):
    """A chunk of b = 5 quantized items with duplicated rows (ties at the
    k boundary): one launch, each item's graph (indices its own) bitwise
    the item alone and the plain version's."""
    from repro_torch.kernels import pald_topk

    b = 5
    Xb = torch.as_tensor(np.stack([_knn_features(n, 5, seed=30 + i)
                                   for i in range(b)]), device=cuda_device)
    sel = pald_topk.topk_select_cuda
    (l0, g0), = _launches(sel)
    gb = sel(Xb, k, metric=metric)
    assert _launches(sel) == [(l0 + 1, g0 + (metric != "manhattan") + 1)]
    assert gb.indices.shape == (b, n, k) and gb.indices.dtype == torch.int32
    for i in range(b):
        gi = sel(Xb[i], k, metric=metric)
        _assert_bitwise(f"indices item {i}", gb.indices[i], gi.indices)
        _assert_bitwise(f"distances item {i}", gb.distances[i], gi.distances)
        gp = pald_topk.topk_select_torch(Xb[i].cpu(), k, metric=metric)
        _assert_bitwise(f"plain item {i}", gb.indices[i].cpu(), gp.indices)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 32, 100])
@pytest.mark.parametrize("kind,metric", [("features", m) for m in METRICS]
                         + [("distance", "euclidean")])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_knn_values_chunk_one_launch_bitwise_items(cuda_device, name,
                                                        kind, metric, k):
    """A chunk of b = 5 graphs at a ragged n through the features source
    (every metric) or the D source of the values kernel: one launch, each
    item's values bitwise the item alone."""
    from repro_torch.core import knn as tknn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn

    b, n = 5, 201
    Xb = torch.as_tensor(np.stack([_knn_features(n, 5, seed=50 + i)
                                   for i in range(b)]), device=cuda_device)
    Db = torch.stack([cdist_reference(x, metric=metric) for x in Xb])
    g = tknn.knn_from_distances(Db, k)
    kw = dict(ties=name)
    if kind == "features":
        src, x = pald_knn.knn_values_from_features_cuda, Xb
        kw["metric"] = metric
    else:
        src, x = pald_knn.knn_values_from_distances_cuda, Db
    (l0, g0), = _launches(src)
    vb = src(x, g.distances, g.indices, **kw)
    assert _launches(src) == [(l0 + 1, g0 + 1)] and vb.shape == (b, n, k + 1)
    for i in range(b):
        _assert_bitwise(f"item {i}", vb[i],
                        src(x[i], g.distances[i].contiguous(),
                            g.indices[i].contiguous(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("ties", ["split", "ignore"])
def test_cuda_engine_fused_and_knn_chunks_bitwise(cuda_device, ties):
    """``from_features(Xb, batch=b)`` (fused and k=) and ``cohesion(Db,
    method="knn", batch=b)`` on the card: every chunk size gives the
    per-item C bitwise, each kernel launching once a chunk."""
    from repro_torch.core import pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_fused, pald_knn, pald_topk

    B, n = 7, 190
    Xb = _chunk_features(B, n, 4, seed=100).to(cuda_device)
    Db = torch.stack([cdist_reference(x) for x in Xb])
    cases = (
        (lambda **kw: pald.from_features(Xb, method="fused", ties=ties, **kw),
         (pald_fused.focus_fused_cuda, pald_fused.cohesion_fused_cuda)),
        (lambda **kw: pald.from_features(Xb, k=16, ties=ties, **kw),
         (pald_topk.topk_select_cuda,
          pald_knn.knn_values_from_features_cuda)),
        (lambda **kw: pald.cohesion(Db, method="knn", k=16, ties=ties, **kw),
         (pald_knn.knn_values_from_distances_cuda,)))
    for run, wrappers in cases:
        one = run(batch=1)
        for b in (2, 3, 7, None):
            before = [w.launches for w in wrappers]
            out = run(batch=b)
            assert [w.launches - l0 for w, l0 in zip(wrappers, before)] == \
                [-(-B // (b or B))] * len(wrappers)
            _assert_bitwise(f"batch={b}", out, one)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["drop", "ignore", "kernelized"])
def test_cuda_fused_chunk_nonfinite_item_keeps_finite_bits(cuda_device,
                                                           name):
    """``add_form`` decides once per fused chunk: one item with an
    infinite W sends the chunk to the multiply form, and the finite items
    keep the bits of their own (predicated) calls."""
    from repro_torch.kernels import pald_cohesion, pald_fused

    b, n = 3, 130
    Xb = _chunk_features(b, n, 3, seed=110).to(cuda_device)
    W = torch.as_tensor(np.random.default_rng(8).random((b, n, n)),
                        dtype=torch.float32, device=cuda_device)
    W[1, 5, 70] = np.inf
    wid = tw.kernel_spec(name)[0]
    assert pald_cohesion.add_form(wid, W) == 0
    assert pald_cohesion.add_form(wid, W[0]) == 1
    Cb = pald_fused.cohesion_fused_cuda(Xb, W, ties=name)
    for i in (0, 2):
        _assert_bitwise(f"finite item {i}", Cb[i],
                        pald_fused.cohesion_fused_cuda(Xb[i], W[i],
                                                       ties=name))
    want = pald_fused.cohesion_fused_cuda(Xb[1], W[1], ties=name)
    assert not torch.isfinite(want).all()
    np.testing.assert_array_equal(Cb[1].cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_chunk_past_one_grid_of_items(cuda_device):
    """b = 65,537 items at n = 8 take two grids of items in every kernel;
    the items at both ends of each grid bitwise alone."""
    from repro_torch.core import knn as tknn
    from repro_torch.kernels import pald_fused, pald_knn, pald_topk
    from repro_torch.kernels.pald_focus import MAX_ITEMS
    from repro_torch.kernels.ref import weights_ref

    b, n, k = MAX_ITEMS + 2, 8, 3
    Xb = torch.as_tensor(np.random.default_rng(3).normal(size=(b, n, 2)),
                         dtype=torch.float32, device=cuda_device)
    Db = (Xb[:, :, None, :] - Xb[:, None, :, :]).abs().sum(-1).contiguous()
    Db.diagonal(dim1=1, dim2=2).zero_()
    f = pald_fused.focus_fused_cuda
    g0 = f.grid_launches
    Ub = f(Xb)
    assert f.grid_launches - g0 == pald_fused.fused_grids(n, "euclidean",
                                                          items=b)
    assert pald_fused.fused_grids(n, "euclidean", items=b) == 1 + 2 * 2
    Cb = pald_fused.cohesion_fused_cuda(Xb, weights_ref(Ub))
    sel = pald_topk.topk_select_cuda
    g0 = sel.grid_launches
    gb = sel(Xb, k)
    assert sel.grid_launches - g0 == 1 + 2
    gd = tknn.knn_from_distances(Db, k)
    vf = pald_knn.knn_values_from_features_cuda(Xb, gb.distances, gb.indices)
    vd = pald_knn.knn_values_from_distances_cuda(Db, gd.distances,
                                                 gd.indices)
    for i in (0, MAX_ITEMS - 1, MAX_ITEMS, b - 1):
        Ui = f(Xb[i])
        _assert_bitwise(f"U {i}", Ub[i], Ui)
        _assert_bitwise(f"C {i}", Cb[i], pald_fused.cohesion_fused_cuda(
            Xb[i], weights_ref(Ui)))
        gi = sel(Xb[i], k)
        _assert_bitwise(f"indices {i}", gb.indices[i], gi.indices)
        _assert_bitwise(f"features values {i}", vf[i],
                        pald_knn.knn_values_from_features_cuda(
                            Xb[i], gi.distances, gi.indices))
        _assert_bitwise(f"D values {i}", vd[i],
                        pald_knn.knn_values_from_distances_cuda(
                            Db[i], gd.distances[i].contiguous(),
                            gd.indices[i].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, None])
def test_cuda_fused_batched_peak_memory_is_the_chunks(cuda_device, batch):
    """A batched fused call holds one chunk's working buffers at a time:
    its cohesion pass holds W, C and the chunk's panel (one n^2 float32
    slab an item at n = 512, where P = n), 3 n^2 float32 an item, and at
    most that plus the whole output when the batch runs in more than one
    chunk."""
    from repro_torch.core import pald
    from repro_torch.kernels import pald_fused

    B, n = 6, 512
    assert pald_fused.panel_rows(n, B) == n
    Xb = _chunk_features(B, n, 8, seed=120).to(cuda_device)
    p = pald.plan(Xb, kind="features", method="fused", batch=batch)
    want = p.execute(Xb)
    gc.collect()
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out = p.execute(Xb)
    torch.cuda.synchronize(cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    b, item = (batch or B), 4 * n * n
    lo = 3 * b * item
    hi = lo + (B * item if b < B else 0) + (1 << 20)
    assert lo <= peak <= hi, (batch, peak / item)
    _assert_bitwise(f"batch={batch}", out, want)


# ---------------------------------------------------------------------------
# the tuning cache on the card: records keyed by the card's name
# ---------------------------------------------------------------------------
def _card_D(n, dev, seed=0):
    from repro_torch.core.features import cdist_reference

    X = np.random.default_rng(seed).normal(size=(n, 5)).astype(np.float32)
    return cdist_reference(torch.from_numpy(X).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("pass_,schedule", [("pald", "dense"),
                                            ("pald_tri", "tri")])
def test_cuda_tune_then_block_auto(cuda_device, tmp_path, monkeypatch,
                                   pass_, schedule):
    """tune() on the card writes a record keyed by the card's name;
    plan(block="auto") reads it, and its C is bitwise the explicit
    block's."""
    from repro_torch.core import pald
    from repro_torch.tuning import autotune

    cache = str(tmp_path / "tune.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", cache)
    n = 200  # ragged: the blocks pad it to 208, 224, 256
    rec = autotune.tune(n, pass_, impl="cuda", device=cuda_device,
                        blocks=(16, 32, 64), iters=1)
    name = torch.cuda.get_device_name(cuda_device)
    key = f"{name}|cuda|{n}|{pass_}"
    assert set(autotune.load_cache(cache)) == {key}
    assert [r["padded_n"] for r in rec["grid"]] == [208, 224, 256]
    D = _card_D(n, cuda_device)
    p = pald.plan(D, method="kernel", schedule=schedule, block="auto")
    assert p.block == rec["block"] and p.block_source == f"cache:{key}"
    assert p.impl == "cuda" and p.device.type == "cuda"
    C = p.execute(D)
    Ce = pald.plan(D, method="kernel", schedule=schedule,
                   block=rec["block"]).execute(D)
    assert torch.equal(C, Ce)
    C128 = pald.plan(D, method="kernel", schedule=schedule,
                     block=128).execute(D)
    torch.testing.assert_close(C, C128, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_method_auto_reads_the_cards_record(cuda_device, tmp_path,
                                                 monkeypatch):
    """method="auto" reads a record keyed by the card's name and ignores
    one keyed "cpu"; the chosen method runs on the card."""
    from repro_torch.core import pald
    from repro_torch.kernels import pald_focus
    from repro_torch.testing import faults

    cache = str(tmp_path / "tune.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", cache)
    name = torch.cuda.get_device_name(cuda_device)
    n = 96
    D = _card_D(n, cuda_device, seed=1)
    faults.write_cache(cache, {f"cpu|-|{n}|method": {"method": "pairwise"}})
    p = pald.plan(D)
    assert (p.method, p.method_source) == ("dense", "heuristic")
    faults.write_cache(cache, {f"cpu|-|{n}|method": {"method": "pairwise"},
                               f"{name}|-|{n}|method": {"method": "kernel"}})
    p = pald.plan(D)
    assert (p.method, p.method_source) == ("kernel",
                                           f"cache:{name}|-|{n}|method")
    assert p.impl == "cuda"
    before = pald_focus.focus_general_cuda.launches
    C = p.execute(D)
    assert pald_focus.focus_general_cuda.launches == before + 1
    torch.testing.assert_close(C, pald.cohesion(D, method="dense"),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_tune_methods_records_the_crossover(cuda_device, tmp_path):
    from repro_torch.tuning import autotune

    cache = str(tmp_path / "tune.json")
    rows = autotune.tune_methods(ns=(48, 96), device=cuda_device, iters=1,
                                 path=cache)
    name = torch.cuda.get_device_name(cuda_device)
    assert set(autotune.load_cache(cache)) == {f"{name}|-|48|method",
                                               f"{name}|-|96|method"}
    for r in rows:
        assert set(r["timings"]) == {"dense", "pairwise", "triplet"}
        assert autotune.method_for_ex(r["n"], device=cuda_device,
                                      path=cache) == (
            r["method"], f"cache:{name}|-|{r['n']}|method")


# ---------------------------------------------------------------------------
# the distributed slice's entries: the selection's block entry and the
# values' row offset / neighbor-row source (core/distributed_knn.py)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 32, 33, 200])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_topk_block_is_the_full_calls_rows(cuda_device, metric, k):
    """Rows [r0, r0 + m) against candidate blocks, each through the block
    entry (global indices, self excluded by global index), merged on the
    (value, index) key: bitwise the full call's rows; each block bitwise
    the block entry's plain version, (+inf, INT32_MAX) past the real
    candidates included."""
    from repro_torch.kernels import pald_topk

    n, d = 601, 5
    Xg = torch.as_tensor(_knn_features(n, d, seed=k), device=cuda_device)
    full = pald_topk.topk_select_cuda(Xg, k, metric=metric)
    for r0, m, cuts in ((0, 601, (0, 601)), (150, 150, (0, 150, 300, 601)),
                        (433, 168, (0, 5, 128, 433, 601))):
        rows = Xg[r0:r0 + m]
        bv = bi = None
        for c0, c1 in zip(cuts[:-1], cuts[1:]):
            before = pald_topk.topk_block_cuda.launches
            gk = pald_topk.topk_block_cuda(rows, Xg[c0:c1].contiguous(), k,
                                           metric=metric, row_off=r0,
                                           col_off=c0)
            assert pald_topk.topk_block_cuda.launches == before + 1
            gp = pald_topk.topk_block_torch(rows, Xg[c0:c1], k,
                                            metric=metric, row_off=r0,
                                            col_off=c0)
            torch.cuda.synchronize()
            assert torch.equal(gk.indices, gp.indices)
            assert torch.equal(gk.distances, gp.distances)
            if bv is None:
                bv, bi = gk.distances, gk.indices
            else:
                bv, bi = pald_topk.merge_pairs(
                    torch.cat([bv, gk.distances], 1),
                    torch.cat([bi, gk.indices], 1), k)
        assert torch.equal(bi, full.indices[r0:r0 + m])
        assert torch.equal(bv, full.distances[r0:r0 + m])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 32, 100])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cuda_knn_values_row_offset_is_the_full_calls_rows(cuda_device,
                                                           name, k):
    """The features source on a slice of the graph's rows, with their
    global offset (the index tiebreak's), and the neighbor-row source on
    the rows' own (m, k, d) neighbor features: bitwise the full call's
    rows, each counting its launch."""
    from repro_torch.kernels import pald_knn, pald_topk

    n = 301
    Xg = torch.as_tensor(_knn_features(n, 5, seed=k + 1), device=cuda_device)
    graph = pald_topk.topk_select_cuda(Xg, k)
    full = pald_knn.knn_values_from_features_cuda(
        Xg, graph.distances, graph.indices, ties=name)
    for r0, m in ((0, 301), (77, 100), (300, 1)):
        dn = graph.distances[r0:r0 + m]
        idx = graph.indices[r0:r0 + m]
        v_off = pald_knn.knn_values_from_features_cuda(
            Xg, dn, idx, ties=name, row_off=r0)
        before = pald_knn.knn_values_from_neighbors_cuda.launches
        Xn = Xg[idx.long()].contiguous()
        v_nbr = pald_knn.knn_values_from_neighbors_cuda(
            Xn, dn, idx, ties=name, row_off=r0)
        assert pald_knn.knn_values_from_neighbors_cuda.launches == before + 1
        torch.cuda.synchronize()
        _assert_bitwise("row offset", v_off, full[r0:r0 + m])
        _assert_bitwise("neighbor rows", v_nbr, full[r0:r0 + m])


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["allgather", "ring", "2d"])
def test_cuda_sharded_knn_in_a_world(cuda_device, strategy):
    """A world of 4 ranks sharing the card (gloo, host-staged): the sharded
    graph and values bitwise the single-device ``select_cohere`` on the
    card, in every rank."""
    from repro_torch.testing.world import MeshSpec, World

    X = _knn_features(1000, 8, seed=5)
    g1, v1 = ops.select_cohere(torch.as_tensor(X, device=cuda_device), k=16,
                               normalize=True)
    shape = (2, 2) if strategy == "2d" else (4,)
    axes = ("rows", "cols")[:len(shape)]
    with World(4, device="cuda", timeout=300.0) as w:
        outs = w.run("repro_torch.core.distributed_knn:pald_knn_sharded", X,
                     MeshSpec(shape, axes), k=16, strategy=strategy)
    for g, v in outs:
        assert np.array_equal(g.indices, g1.indices.cpu().numpy())
        assert np.array_equal(g.distances, g1.distances.cpu().numpy())
        assert np.array_equal(v, v1.cpu().numpy())


@pytest.mark.cuda
def test_cuda_sharded_step_matches_two_microbatches(cuda_device):
    """2 gloo ranks sharing the card, reduced gemma2-2b, fsdp on (2,):
    the sharded backward and step against the single-device step in 2
    microbatches on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim import adamw
    from repro_torch.testing.world import MeshSpec, World
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b")),
                              sharding_profile="fsdp")
    opt = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10)
    batch = SyntheticTokens(cfg.vocab_size, 32, 8, seed=0,
                            device=cuda_device).batch_at(0)
    state = ts.init_state(cfg, 0, cuda_device)
    loss, _ = ts.backward(ts.make_loss_fn(cfg), state["params"], batch, 2)
    want = {n.replace(".", "/"): p.grad.cpu().numpy()
            for n, p in state["params"].named_parameters()}
    state, _ = ts.make_train_step(cfg, adamw.AdamWConfig(**opt),
                                  microbatches=2)(state, batch)
    mesh = MeshSpec((2,), ("data",))
    jobs = "repro_torch.testing.training"
    with World(2, device="cuda", timeout=300.0) as w:
        grads = w.run(f"{jobs}:gradients", cfg, mesh, batch=8, seq=32,
                      device="cuda")
        stepped = w.run(f"{jobs}:train", cfg, mesh, steps=1, batch=8,
                        seq=32, opt=opt, device="cuda")
    for o in grads:
        assert o["loss"] == pytest.approx(float(loss), rel=1e-6)
        for k, g in want.items():
            err = np.abs(o["grads"][k] - g).max()
            assert err <= 2.0 ** -8 * np.abs(g).max(), k
    got = stepped[0]["state"]
    for n, p in state["params"].named_parameters():
        np.testing.assert_allclose(got[f"params/{n.replace('.', '/')}"],
                                   p.detach().cpu().numpy(), rtol=0,
                                   atol=4e-3, err_msg=n)


@pytest.mark.cuda
def test_cuda_dryrun_decode_peak_within_twice_the_estimate(cuda_device):
    """gemma2-2b decode_32k on the single pod (8 rows a rank, the whole
    bfloat16 serving copy and the rank's caches: ~21 GB of arguments):
    measured at full depth on the card, its peak within 2x of the
    estimate counted on meta."""
    from repro_torch.launch import dryrun

    cell = dryrun.run_cell("gemma2-2b", "decode_32k", False,
                           device=cuda_device, reps=1, verbose=False)
    assert cell["status"] == "ok"
    m = cell["measured"]
    assert m["fits"] and m["depth"] == "full" and m["step_ms"] > 0
    ma = cell["memory_analysis"]
    est = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
    assert m["peak_estimate_bytes"] == est
    assert 0.5 <= m["peak_bytes"] / est <= 2.0, (m["peak_bytes"], est)


# ---------------------------------------------------------------------------
# user-registered weight functionals: their generated functors in every
# kernel entry (kernels/_functor.py, the user libraries of kernels/_build.py)
# ---------------------------------------------------------------------------
def _clone(name, new):
    """A user functional with a built-in's callables and no kernel id."""
    w = tw.resolve_weight(name)
    return tw.WeightFunctional(new, w.focus, w.support, share=w.share,
                               needs_index_tiebreak=w.needs_index_tiebreak,
                               conserves_mass=w.conserves_mass,
                               is_strict=w.is_strict)


def _smooth_exp():
    """A smooth functional with exp and a share, exact zeros on +inf."""
    def focus(dxz, dyz, dxy):
        d = dxy - torch.minimum(dxz, dyz)
        f = 1.0 - torch.exp(-torch.maximum(d, torch.zeros_like(d)) * 3.0)
        return torch.where(torch.isnan(d), 0.0, f)

    def share(own, other):
        return torch.clamp(0.5 + (other - own) * 2.0, 0.0, 1.0)

    def support(own, other, pair, own_wins=None):
        res = share(own, other) * focus(own, other, pair)
        return torch.where(torch.isnan(res), 0.0, res)

    return tw.WeightFunctional("_smooth_exp", focus, support, share=share)


CLONES = {"drop": _clone("drop", "_harsh"),
          "ignore": _clone("ignore", "_ignore_clone"),
          "soft": _clone("soft", "_soft_clone")}
SMOOTH = _smooth_exp()


@pytest.fixture(scope="module")
def user_libraries():
    """Every user functor's libraries, built at once (the wrappers would
    build each source at its first call, one after another)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: see README.md)")
    from repro_torch.kernels import _build

    funcs = [tw.kernel_spec(w).functor for w in (*CLONES.values(), SMOOTH)]
    _build.build_user(*funcs)
    return {f.name: f for f in funcs}


def _pair(kernel, name, *args, **kw):
    """(the clone's result, the built-in's) of one wrapper call, the
    wrapper's launch count up by one for the clone."""
    before = kernel.launches
    got = kernel(*args, ties=CLONES[name], **kw)
    assert kernel.launches == before + 1
    return got, kernel(*args, ties=name, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLONES))
def test_cuda_user_clone_dense_and_tri_bitwise(cuda_device, user_libraries,
                                               name):
    """A clone's generated functor, in the multiply form, bitwise the
    built-in's hand-written one on the rectangular focus and cohesion
    entries (both tiebreak routes), the square focus entry, the tri
    cohesion entry and a (b, n, n) chunk of each."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import weights_ref

    DXZ, DYZ, DXY, W, XW = [torch.as_tensor(a, device=cuda_device)
                            for a in _operands(130, 70, 257, seed=21)]
    U, Ub = _pair(pald_focus.focus_general_cuda, name, DXZ, DYZ, DXY)
    _assert_bitwise("focus rect", U, Ub)
    routes = ([{"xw_offsets": (3, 8)}, {"xwins": XW}]
              if CLONES[name].needs_index_tiebreak else [{}])
    for r in routes:
        C, Cb = _pair(pald_cohesion.cohesion_general_cuda, name, DXZ, DYZ,
                      DXY, W, **r)
        _assert_bitwise(f"cohesion rect {sorted(r)}", C, Cb)
    for D in (torch.as_tensor(_tri_D(257, seed=22), device=cuda_device),
              torch.as_tensor(np.stack([_tri_D(65, seed=s)
                                        for s in range(3)]),
                              device=cuda_device)):
        U, Ub = _pair(pald_focus_tri.focus_tri_cuda, name, D)
        _assert_bitwise(f"focus square {tuple(D.shape)}", U, Ub)
        Wd = weights_ref(Ub)
        C, Cb = _pair(pald_cohesion_tri.cohesion_tri_cuda, name, D, Wd)
        _assert_bitwise(f"cohesion tri {tuple(D.shape)}", C, Cb)
        off = {"xw_offsets": (0, 0)} if name == "ignore" else {}
        C, Cb = _pair(pald_cohesion.cohesion_general_cuda, name, D, D, D, Wd,
                      **off)
        _assert_bitwise(f"cohesion dense {tuple(D.shape)}", C, Cb)
    key = tw.kernel_spec(CLONES[name]).key
    assert set(_build.user_status(key)) == set(_build.WEIGHT_SOURCES)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("name", list(CLONES))
def test_cuda_user_clone_fused_bitwise(cuda_device, user_libraries, name,
                                       metric):
    """The fused pair with a clone: one item and a (3, n, d) chunk, U and
    C bitwise the built-in's."""
    from repro_torch.kernels import pald_fused
    from repro_torch.kernels.ref import weights_ref

    for X in (torch.as_tensor(_features(200, 5, seed=23), device=cuda_device),
              _chunk_features(3, 130, 5, seed=24).to(cuda_device)):
        U, Ub = _pair(pald_fused.focus_fused_cuda, name, X, metric=metric)
        _assert_bitwise(f"fused U {tuple(X.shape)}", U, Ub)
        C, Cb = _pair(pald_fused.cohesion_fused_cuda, name, X,
                      weights_ref(Ub), metric=metric)
        _assert_bitwise(f"fused C {tuple(X.shape)}", C, Cb)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [33, 65])
@pytest.mark.parametrize("name", list(CLONES) + ["smooth"])
def test_cuda_user_knn_large_k(cuda_device, user_libraries, name, d):
    """Past k = 1024 a user functional's generated functor in the
    features source at d = 33 (``pald_knn_wide.cu``) and d = 65
    (``pald_knn_piece.cu``) and in the D source's sweep: a clone bitwise
    the built-in's, the smooth one within rtol 1e-5, atol 1e-6 of the
    plain version on a 16-row slab."""
    from repro_torch.core import knn as tknn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import pald_knn, pald_topk

    k, sl = 1500, slice(700, 716)
    Xg = torch.as_tensor(_knn_features(N_LARGE, d, seed=31),
                         device=cuda_device)
    D = cdist_reference(Xg)
    g = pald_topk.topk_select_cuda(Xg, k)
    feats = pald_knn.knn_values_from_features_cuda
    dsrc = pald_knn.knn_values_from_distances_cuda
    if name != "smooth":
        v, vb = _pair(feats, name, Xg, g.distances, g.indices)
        _assert_bitwise("features", v, vb)
        v, vb = _pair(dsrc, name, D, g.distances, g.indices)
        _assert_bitwise("distances", v, vb)
        return
    gp = tknn.gather_tile_from_distances(D, g.indices[sl])
    vp = pald_knn.knn_values_torch(g.distances[sl], gp, g.indices[sl],
                                   ties=SMOOTH, row_off=700)
    for f, x in ((feats, Xg), (dsrc, D)):
        before = f.large_launches
        v = f(x, g.distances, g.indices, ties=SMOOTH)
        assert f.large_launches == before + 1
        torch.testing.assert_close(v[sl], vp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 32, 100])
@pytest.mark.parametrize("name", list(CLONES))
def test_cuda_user_clone_knn_bitwise(cuda_device, user_libraries, name, k):
    """The k-NN values kernel with a clone, its three sources and a chunk
    of the features and D sources, bitwise the built-in's (the soft clone
    through the generic share trait)."""
    from repro_torch.core import knn
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_knn, pald_topk

    Xg = torch.as_tensor(_knn_features(301, 5, seed=k), device=cuda_device)
    graph = pald_topk.topk_select_cuda(Xg, k)
    idx, dn = graph.indices, graph.distances
    D = cdist_reference(Xg)
    g = ops._gather_tiles(Xg, idx, "features", "euclidean")
    v, vb = _pair(pald_knn.knn_values_cuda, name, dn, g, idx)
    _assert_bitwise("cube", v, vb)
    v, vb = _pair(pald_knn.knn_values_from_features_cuda, name, Xg, dn, idx)
    _assert_bitwise("features", v, vb)
    v, vb = _pair(pald_knn.knn_values_from_distances_cuda, name, D, dn, idx)
    _assert_bitwise("distances", v, vb)
    Xb = torch.as_tensor(np.stack([_knn_features(201, 5, seed=60 + i)
                                   for i in range(3)]), device=cuda_device)
    Db = torch.stack([cdist_reference(x) for x in Xb])
    gb = knn.knn_from_distances(Db, k)
    v, vb = _pair(pald_knn.knn_values_from_features_cuda, name, Xb,
                  gb.distances, gb.indices)
    _assert_bitwise("features chunk", v, vb)
    v, vb = _pair(pald_knn.knn_values_from_distances_cuda, name, Db,
                  gb.distances, gb.indices)
    _assert_bitwise("distances chunk", v, vb)


@pytest.mark.cuda
def test_cuda_smooth_user_functional_vs_plain(cuda_device, user_libraries):
    """The smooth exp functional (its own functor) on every entry (the
    fused pair on one item and a chunk, the three k-NN sources) against its
    plain version within rtol 1e-5, atol 1e-6, with +inf entries in the
    rectangular operands; then through the user's entry points."""
    from repro_torch.core import knn, pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_fused, pald_knn
    from repro_torch.kernels.ref import weights_ref

    def close(what, got, want):
        assert bool(torch.isfinite(got).all()), what
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=what)

    DXZ, DYZ, DXY, W, _ = [torch.as_tensor(a, device=cuda_device)
                           for a in _operands(130, 70, 257, seed=25)]
    close("focus rect", ops.focus_general(DXZ, DYZ, DXY, impl="cuda",
                                          ties=SMOOTH),
          ops.focus_general(DXZ, DYZ, DXY, impl="torch", ties=SMOOTH))
    close("cohesion rect",
          ops.cohesion_general(DXZ, DYZ, DXY, W, impl="cuda", ties=SMOOTH),
          ops.cohesion_general(DXZ, DYZ, DXY, W, impl="torch", ties=SMOOTH))
    D = torch.as_tensor(_tri_D(257, seed=26), device=cuda_device)
    U = pald_focus_tri.focus_tri_cuda(D, ties=SMOOTH)
    close("focus square", U, ops.focus(D, impl="torch", ties=SMOOTH))
    Wd = weights_ref(U)
    close("cohesion tri", pald_cohesion_tri.cohesion_tri_cuda(
        D, Wd, ties=SMOOTH), ops.cohesion_from_weights(D, Wd, impl="torch",
                                                        ties=SMOOTH))
    X = torch.as_tensor(_features(200, 5, seed=27), device=cuda_device)
    Uf = pald_fused.focus_fused_cuda(X, ties=SMOOTH)
    close("fused U", Uf, pald_fused.focus_fused_torch(X, ties=SMOOTH))
    Wf = weights_ref(Uf)
    close("fused C", pald_fused.cohesion_fused_cuda(X, Wf, ties=SMOOTH),
          pald_fused.cohesion_fused_torch(X, Wf, ties=SMOOTH))
    Xb = _chunk_features(3, 130, 5, seed=30).to(cuda_device)
    Ub = pald_fused.focus_fused_cuda(Xb, ties=SMOOTH)
    Cb = pald_fused.cohesion_fused_cuda(Xb, weights_ref(Ub), ties=SMOOTH)
    for i in range(3):
        close(f"fused chunk U {i}", Ub[i],
              pald_fused.focus_fused_torch(Xb[i], ties=SMOOTH))
        close(f"fused chunk C {i}", Cb[i], pald_fused.cohesion_fused_torch(
            Xb[i], weights_ref(Ub[i]), ties=SMOOTH))
    Xg = torch.as_tensor(_knn_features(301, 5, seed=28), device=cuda_device)
    Dg = cdist_reference(Xg)
    graph = knn.knn_from_distances(Dg, 32)
    dn, idx = graph.distances, graph.indices
    close("knn features", pald_knn.knn_values_from_features_cuda(
        Xg, dn, idx, ties=SMOOTH),
        pald_knn.knn_values_from_features_torch(Xg, dn, idx, ties=SMOOTH))
    close("knn distances", pald_knn.knn_values_from_distances_cuda(
        Dg, dn, idx, ties=SMOOTH),
        pald_knn.knn_values_from_distances_torch(Dg, dn, idx, ties=SMOOTH))
    g = knn.gather_tile_from_distances(Dg, idx)
    close("knn cube", pald_knn.knn_values_cuda(dn, g, idx, ties=SMOOTH),
          pald_knn.knn_values_torch(dn, g, idx, ties=SMOOTH))
    for run in (lambda **kw: pald.cohesion(D, method="kernel", **kw),
                lambda **kw: pald.from_features(X, **kw),
                lambda **kw: pald.from_features(Xg, k=32, **kw)):
        close("entry point", run(weight=SMOOTH),
              run(weight=SMOOTH, impl="torch"))


@pytest.mark.cuda
def test_cuda_untraceable_functional_raises_on_the_card(cuda_device):
    """An op outside the compiler's table raises NotImplementedError on
    the card, naming the op; under the guard the walk ends in
    FallbackExhausted (a plan on the card keeps its kernels)."""
    from repro_torch.core import pald, resilience

    bad = tw.WeightFunctional("_cosine", lambda a, b, c: torch.cos(a - c),
                              tw.DROP.support)
    D = torch.as_tensor(_tri_D(64, seed=29), device=cuda_device)
    with pytest.raises(NotImplementedError, match="aten.cos"):
        pald.cohesion(D, method="kernel", weight=bad)
    with pytest.raises(resilience.FallbackExhausted) as ei:
        pald.cohesion(D, method="kernel", weight=bad, on_error="fallback")
    assert "aten.cos" in repr(ei.value.__cause__) or "aten.cos" in str(
        ei.value)
