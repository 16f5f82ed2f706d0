"""The port's k-NN selection (``repro_torch.core.knn.knn_from_distances``,
``kernels/pald_topk.py``, ``ops.topk_select``) against the JAX reference.

On this CPU the port runs the selection kernel's plain version (the
wrapper takes it for CPU tensors).  Held to:

- selection from D: bitwise the reference's ``knn_from_distances``
  (indices and distances), on random and tie-heavy quantized matrices,
  k in {0, 1, 4, n-1};
- selection from features: bitwise the port's own selection from
  ``cdist_reference(X)``, and its indices bitwise the reference's
  ``_top_k_rows`` applied to the port's distances, for four metrics, d in
  {1, 5, 8}, k in {1, 7, n-1}, on rows with duplicates.  The reference's
  streaming-kernel *distances* are not an oracle here: its tiled paths
  compute ``na + nb - 2 dot`` in a shape-dependent order (ROADMAP.md,
  queue 3), so they differ from the port's by ulps.

The CUDA kernel is held bitwise to the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import knn as jknn
from repro_torch.core import knn
from repro_torch.core.features import METRICS, cdist_reference
from repro_torch.kernels import ops, pald_topk


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


def _points_D(n, seed=0, d=3):
    X = np.random.default_rng(seed).normal(size=(n, d))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D.astype(np.float32)


def _quantized_D(n, seed=0):
    """A tie-heavy Euclidean distance matrix of integer points."""
    X = np.random.default_rng(seed).integers(0, 5, size=(n, 3))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D.astype(np.float32)


def _dup_X(n, d, seed=0):
    """Features quantized to 0.5 (exact ties) with every fifth row a
    duplicate of an earlier one."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 2) / 2
    X[5::5] = X[rng.integers(0, 5, size=X[5::5].shape[0])]
    return X.astype(np.float32)


N = 41


# ---------------------------------------------------------------------------
# selection from a materialized D
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [0, 1, 4, N - 1])
@pytest.mark.parametrize("kind", ["points", "quantized"])
def test_knn_from_distances_matches_reference(kind, k):
    D = _points_D(N) if kind == "points" else _quantized_D(N)
    g = knn.knn_from_distances(torch.from_numpy(D), k)
    jg = jknn.knn_from_distances(jnp.asarray(D), k)
    assert g.indices.dtype == torch.int32 and g.indices.shape == (N, k)
    assert g.distances.dtype == torch.float32 and g.n == N and g.k == k
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_array_equal(g.distances.numpy(),
                                  np.asarray(jg.distances))


@pytest.mark.parametrize("row_chunk", [1, 7, 1024])
def test_knn_from_distances_row_chunk_is_pure_chunking(row_chunk):
    D = torch.from_numpy(_quantized_D(N, seed=3))
    g = knn.knn_from_distances(D, 9, row_chunk=row_chunk)
    ref = knn.knn_from_distances(D, 9, row_chunk=N)
    assert torch.equal(g.indices, ref.indices)
    assert torch.equal(g.distances, ref.distances)


def test_knn_from_distances_rejects_k_beyond_n_minus_1():
    D = _points_D(6)
    with pytest.raises(ValueError, match="exceeds the n-1"):
        knn.knn_from_distances(torch.from_numpy(D), 6)
    with pytest.raises(ValueError, match="exceeds the n-1"):
        jknn.knn_from_distances(jnp.asarray(D), 6)


# ---------------------------------------------------------------------------
# selection from features (the kernel's plain version)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 7, N - 1])
@pytest.mark.parametrize("d", [1, 5, 8])
@pytest.mark.parametrize("metric", METRICS)
def test_topk_select_matches_distance_selection(metric, d, k):
    X = torch.from_numpy(_dup_X(N, d, seed=d))
    g = ops.topk_select(X, k, metric=metric)
    D = cdist_reference(X, metric=metric)
    ref = knn.knn_from_distances(D, k)
    assert torch.equal(g.indices, ref.indices)
    assert torch.equal(g.distances, ref.distances)
    # the reference's selection contract on the port's own distances
    neg = jnp.asarray(np.where(np.eye(N, dtype=bool), -np.inf,
                               -D.numpy()))
    jd, ji = jknn._top_k_rows(neg, k)
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(g.distances.numpy(), np.asarray(jd))


@pytest.mark.parametrize("block", [1, 6, 64])
def test_topk_select_block_is_pure_chunking(block):
    X = torch.from_numpy(_dup_X(N, 4, seed=9))
    g = ops.topk_select(X, 11, block=block)
    ref = ops.topk_select(X, 11, block=N)
    assert torch.equal(g.indices, ref.indices)
    assert torch.equal(g.distances, ref.distances)


def test_topk_select_row_range_matches_full_rows():
    X = torch.from_numpy(_dup_X(N, 3, seed=4))
    full = pald_topk.topk_select_torch(X, 6, metric="cosine")
    part = pald_topk.topk_select_torch(X, 6, metric="cosine", rows=(13, 29),
                                       block=5)
    assert torch.equal(part.indices, full.indices[13:29])
    assert torch.equal(part.distances, full.distances[13:29])


def test_topk_self_loses_to_infinite_candidates():
    """Self sorts after every real candidate, even one at +inf (the
    kernel's contract), where the D selection gives self the place of its
    index among the +inf entries (the reference's)."""
    X = torch.tensor([[0.0, 0.0], [3e38, 3e38], [-3e38, -3e38]])
    g = ops.topk_select(X, 2, metric="manhattan")
    D = cdist_reference(X, metric="manhattan")
    assert bool(torch.isinf(D[1, [0, 2]]).all())
    assert g.indices[1].tolist() == [0, 2]
    assert knn.knn_from_distances(D, 2).indices[1].tolist() == [0, 1]
    assert g.indices[0].tolist() == [1, 2] and g.indices[2].tolist() == [0, 1]


def test_topk_select_edge_sizes():
    g = ops.topk_select(torch.zeros((1, 3)), 0)
    assert g.indices.shape == (1, 0) and g.distances.shape == (1, 0)
    g = ops.topk_select(torch.tensor([[0.0], [2.0]]), 1, metric="sqeuclidean")
    assert g.indices.tolist() == [[1], [0]]
    assert g.distances.tolist() == [[4.0], [4.0]]
    # all rows equal: every distance 0, lower index first
    g = ops.topk_select(torch.ones((5, 2)), 4)
    assert g.indices.tolist()[2] == [0, 1, 3, 4]
    assert not bool(g.distances.any())


def test_topk_select_errors():
    X = torch.from_numpy(_dup_X(8, 2))
    with pytest.raises(ValueError, match="exceeds the n-1"):
        ops.topk_select(X, 8)
    with pytest.raises(ValueError, match="unknown metric"):
        ops.topk_select(X, 2, metric="chebyshev")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.topk_select(X, 2, impl="pallas")


def test_topk_cuda_wrapper_takes_plain_version_on_cpu():
    X = torch.from_numpy(_dup_X(N, 5, seed=2))
    before = pald_topk.topk_select_cuda.launches
    g = pald_topk.topk_select_cuda(X, 5, metric="euclidean")
    ref = pald_topk.topk_select_torch(X, 5, metric="euclidean")
    assert pald_topk.topk_select_cuda.launches == before
    assert torch.equal(g.indices, ref.indices)
    assert torch.equal(g.distances, ref.distances)


def test_knn_from_features_facade():
    X = torch.from_numpy(_dup_X(N, 5, seed=6))
    g = knn.knn_from_features(X, 7, metric="manhattan", row_chunk=10)
    ref = ops.topk_select(X, 7, metric="manhattan")
    assert torch.equal(g.indices, ref.indices)
    assert torch.equal(g.distances, ref.distances)


@pytest.mark.parametrize("k", [1, 32, 128, 129, 512, 513, 1024, 1025, 2048,
                               4096, 16384])
def test_topk_smem_estimate_fits_the_card(k):
    """The kernel's per-block shared memory stays within the H100's 227 KB
    at every k; past ``LARGE_K`` (the large-k variant, selection by
    threshold) it no longer grows with k: the ring of two 128-candidate
    slots with the rows riding in each (past 64 features), the 16 rows'
    norms and sorted counts, and their 2048-bin histograms."""
    assert 0 < pald_topk.smem_per_cta(k) <= 232448
    if k > pald_topk.LARGE_K:
        slot = 128 * 68 + 128 + 16 * 68
        assert pald_topk.smem_per_cta(k) == \
            4 * (2 * slot + 2 * 16) + 4 * 16 * pald_topk.BINS
        assert pald_topk.SORT_CAP * 8 == 4 * 16 * pald_topk.BINS


@pytest.mark.parametrize("d", [1, 8, 64, 65, 300])
@pytest.mark.parametrize("k", [1, 32, 33, 128, 129, 512, 513, 1024, 1025,
                               2048, 4096, 16384])
def test_topk_smem_estimate_fits_the_card_at_every_width(k, d):
    """The per-block shared memory at each feature width stays within the
    H100's 227 KB and under the estimate over every width."""
    assert 0 < pald_topk.smem_per_cta(k, d) <= pald_topk.smem_per_cta(k)
    assert pald_topk.smem_per_cta(k) <= 232448


@pytest.mark.parametrize("k", [1, 32, 33])
@pytest.mark.parametrize("block", [1, 7, 32])
@pytest.mark.parametrize("metric", METRICS)
def test_row_slabs_do_not_change_the_selection(metric, block, k):
    """The plain selection in slabs of ``block`` rows is bitwise the one
    slab of all rows, on tie-heavy rows with duplicates: the composite
    (value, index) key orders every row alike, however rows are grouped
    (the kernel's blocks group them by 32)."""
    X = torch.from_numpy(_dup_X(90, 5, seed=block + k))
    want = pald_topk.topk_select_torch(X, k, metric=metric)
    got = pald_topk.topk_select_torch(X, k, metric=metric, block=block)
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.distances, want.distances)


# ---------------------------------------------------------------------------
# the tile-min prefilter of the plain selection (``tile=``; the reference's
# jnp strategy, repro/kernels/ops.py::_topk_chunk)
# ---------------------------------------------------------------------------
def _prefilter_X(kind, seed):
    if kind == "random":
        return np.random.default_rng(seed).normal(size=(N, 4)).astype(
            np.float32)
    if kind == "tied":  # integer grid: every row full of exact ties
        return np.random.default_rng(seed).integers(0, 3, size=(N, 2)).astype(
            np.float32)
    X = _dup_X(N, 3, seed=seed)
    if kind == "inf":  # rows whose every candidate is at +inf
        X[[3, 17, 30]] = [[3e38] * 3, [-3e38] * 3, [3e38, -3e38, 3e38]]
    return X


@pytest.mark.parametrize("tile", [1, 3, 8, 32, N])
@pytest.mark.parametrize("kind", ["random", "tied", "dup", "inf"])
def test_prefilter_is_bitwise_the_direct_strategy(kind, tile):
    X = torch.from_numpy(_prefilter_X(kind, seed=tile))
    for metric in METRICS:
        for k in (1, 2, 7, N - 2, N - 1):
            want = pald_topk.topk_select_torch(X, k, metric=metric)
            for block in (5, N):
                got = ops.topk_select(X, k, metric=metric, impl="torch",
                                      block=block, tile=tile)
                assert torch.equal(got.indices, want.indices), (metric, k)
                assert torch.equal(got.distances.isnan(),
                                   want.distances.isnan())
                assert torch.equal(got.distances.nan_to_num(),
                                   want.distances.nan_to_num())


@pytest.mark.parametrize("tile", [1, 3, 8, 32, N])
def test_prefilter_indices_match_the_references_jnp_prefilter(tile):
    """On tie-free rows the port's prefilter selects the reference's jnp
    prefilter's neighbors; its distances agree to rtol 1e-5 (the two
    packages order the distance sums differently, ROADMAP.md queue 3)."""
    from repro.kernels import ops as jops

    X = _prefilter_X("random", seed=40 + tile)
    for metric in METRICS:
        for k in (1, 7, N - 1):
            g = ops.topk_select(torch.from_numpy(X), k, metric=metric,
                                impl="torch", block=16, tile=tile)
            jg = jops.topk_select(jnp.asarray(X), k, metric=metric,
                                  impl="jnp", block=16, tile=tile)
            np.testing.assert_array_equal(g.indices.numpy(),
                                          np.asarray(jg.indices))
            np.testing.assert_allclose(g.distances.numpy(),
                                       np.asarray(jg.distances),
                                       rtol=1e-5, atol=1e-6)


def test_prefilter_tile_auto_reads_the_cache(tmp_path, monkeypatch):
    """``tile="auto"`` / ``select_tile`` resolve under the
    ``pald_topk:k<k>:d<d>`` pass; any tile gives the same graph and C."""
    from repro_torch.core import pald
    from repro_torch.testing import faults
    from repro_torch.tuning import autotune

    cache = str(tmp_path / "tune.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", cache)
    X = torch.from_numpy(_dup_X(N, 3, seed=11))
    direct = ops.topk_select(X, 5, impl="torch")
    faults.write_cache(cache, {
        f"cpu|torch|{N}|pald_topk:k5:d3": {"block": 8, "block_z": 4}})
    assert autotune.resolve_blocks(N, "pald_topk", k=5, d=3,
                                   device="cpu") == (8, 4)
    g = ops.topk_select(X, 5, impl="torch")
    assert torch.equal(g.indices, direct.indices)
    assert torch.equal(g.distances, direct.distances)
    p = pald.plan(X, kind="features", k=5, device="cpu")
    assert (p.select_block, p.select_tile) == (8, 4)
    assert p.select_source == f"cache:cpu|torch|{N}|pald_topk:k5:d3"
    C = p.execute(X)
    for st in (1, N):
        assert torch.equal(pald.from_features(X, k=5, select_tile=st,
                                              device="cpu"), C)
