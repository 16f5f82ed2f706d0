"""The k-NN selection and values past k = 1024 (the kernels' large-k
variants) against the JAX reference, whose ``topk_pallas`` and
``knn_values_pallas`` take any k.

On this CPU the wrappers take their plain versions, which hold any k; the
card runs the large-k variants and ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them to these plain versions.  Held to:

- selection at n = 1100, k in {1025, 1040, n-1}: indices and distances
  bitwise the reference's ``_top_k_rows`` on the port's own
  ``cdist_reference`` distances (self masked last, as the kernel masks
  it), on Gaussian and on tie-heavy quantized features; the block entry's
  plain version on two candidate blocks (fewer candidates than k each),
  merged by ``merge_pairs``, bitwise the full call;
- values at k = 1040 on 16-row slabs: the D, features and neighbor-row
  sources within rtol 1e-5, atol 1e-6 of the reference's ``pald_knn``
  (``impl="jnp"``, ``block=8``) for the five built-in functionals and one
  user functional, the three sources bitwise each other on
  ``cdist_reference(X)``, and ``row_off`` against the reference's tile
  body with the slab's global row indices; tie-heavy features, so the
  ``ignore`` tiebreak acts.  The (n, k, k) cube of a
  whole graph would be 4.7 GB here, so the tests run slabs;
- the redesigned kernels' host-side sizing at every k up to n - 1 (shared
  memory within the card's 227 KB, the values' scratch, the D source's
  sweep), the width the features source pads d to and the C entry it
  launches, and that zero-padding leaves every metric's distances
  bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import knn as jknn
from repro.core import weights as jw
from repro.kernels import ops as jops
from repro_torch.core import knn
from repro_torch.core import weights as tw
from repro_torch.core.features import cdist_reference
from repro_torch.kernels import _build, pald_knn, pald_topk

N = 1100
K_VALUES = 1040
SLAB = 16
RTOL, ATOL = 1e-5, 1e-6
METRICS = ["sqeuclidean", "euclidean", "cosine", "manhattan"]


def _smooth(xp, where, clamp):
    """A smooth functional with a share, in one array library's spelling
    (``tests/test_torch_user_weights.py``'s)."""
    def focus(dxz, dyz, dxy):
        d = dxy - xp.minimum(dxz, dyz)
        f = 1.0 - xp.exp(-xp.maximum(d, xp.zeros_like(d)) * 3.0)
        return where(xp.isnan(d), 0.0, f)

    def share(own, other):
        return clamp(0.5 + (other - own) * 2.0, 0.0, 1.0)

    def support(own, other, pair, own_wins=None):
        res = share(own, other) * focus(own, other, pair)
        return where(xp.isnan(res), 0.0, res)

    return focus, support, share


USER = "_user_smooth_large_k"
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized", USER]


@pytest.fixture(autouse=True, scope="module")
def _registered(tmp_path_factory):
    """Both registries hold the user functional for this module only;
    both packages' tuning caches point at a temporary directory."""
    d = tmp_path_factory.mktemp("tuning")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(d / "port.json"))
        mp.setenv("REPRO_TUNE_CACHE", str(d / "reference.json"))
        f, s, sh = _smooth(torch, torch.where, torch.clamp)
        jf, js, jsh = _smooth(jnp, jnp.where, jnp.clip)
        tw.register_weight(tw.WeightFunctional(USER, f, s, share=sh))
        jw.register_weight(jw.WeightFunctional(USER, jf, js, share=jsh))
        try:
            yield
        finally:
            tw._REGISTRY.pop(USER, None)
            jw._REGISTRY.pop(USER, None)


def _gauss_X(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _dup_X(n, d, seed):
    """Features quantized to 0.5 (exact ties) with every fifth row a
    duplicate of an earlier one."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 2) / 2
    X[5::5] = X[rng.integers(0, 5, size=X[5::5].shape[0])]
    return X.astype(np.float32)


def _reference_selection(X, k):
    """The reference's ``_top_k_rows`` on the port's distances, self
    masked after every candidate."""
    D = cdist_reference(X).numpy()
    neg = jnp.asarray(np.where(np.eye(len(D), dtype=bool), -np.inf, -D))
    jd, ji = jknn._top_k_rows(neg, k)
    return np.asarray(jd), np.asarray(ji)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1025, 1040, N - 1])
@pytest.mark.parametrize("d", [1, 4])
def test_large_k_selection_matches_reference(d, k):
    X = torch.from_numpy(_gauss_X(N, d, seed=d))
    g = pald_topk.topk_select_cuda(X, k)  # the plain version on the CPU
    jd, ji = _reference_selection(X, k)
    assert g.indices.shape == (N, k) and g.indices.dtype == torch.int32
    np.testing.assert_array_equal(g.indices.numpy(), ji)
    np.testing.assert_array_equal(g.distances.numpy(), jd)


@pytest.mark.parametrize("k", [1025, N - 1])
def test_large_k_selection_on_ties_matches_reference(k):
    X = torch.from_numpy(_dup_X(N, 4, seed=5))
    g = pald_topk.topk_select_torch(X, k)
    jd, ji = _reference_selection(X, k)
    assert int((g.distances == 0).sum()) > 0  # duplicates: exact ties
    np.testing.assert_array_equal(g.indices.numpy(), ji)
    np.testing.assert_array_equal(g.distances.numpy(), jd)


@pytest.mark.parametrize("d", [1, 4])
def test_large_k_block_entry_merges_to_the_full_call(d):
    """Each candidate block holds fewer than k candidates, so each list
    ends in (+inf, SENTINEL) entries; merged on the (value, index) key the
    lists are the full call's."""
    k, cut = 1040, 500
    X = torch.from_numpy(_dup_X(N, d, seed=20 + d))
    full = pald_topk.topk_select_torch(X, k)
    rows = slice(100, 164)
    parts = [pald_topk.topk_block_torch(X[rows], X[a:b], k, row_off=100,
                                        col_off=a)
             for a, b in ((0, cut), (cut, N))]
    for p, w in zip(parts, (cut, N - cut)):
        assert bool((p.indices[:, w:] == pald_topk.SENTINEL).all())
        assert bool(torch.isinf(p.distances[:, w:]).all())
    v, i = pald_topk.merge_pairs(
        torch.cat([p.distances for p in parts], 1),
        torch.cat([p.indices for p in parts], 1), k)
    assert torch.equal(i, full.indices[rows])
    assert torch.equal(v, full.distances[rows])


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graph_case():
    X = torch.from_numpy(_dup_X(N, 4, seed=11))
    D = cdist_reference(X)
    return X, D, knn.knn_from_distances(D, K_VALUES)


def _sources(X, D, dn, idx, name, row_off):
    """The three plain sources' values of one slab: D, features, neighbor
    rows."""
    return (pald_knn.knn_values_from_distances_torch(D, dn, idx, ties=name)
            if row_off == 0 else None,
            pald_knn.knn_values_from_features_torch(X, dn, idx, ties=name,
                                                    row_off=row_off),
            pald_knn.knn_values_from_neighbors_torch(
                X[idx.long()], dn, idx, ties=name, row_off=row_off))


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_large_k_values_match_reference(graph_case, name):
    X, D, g = graph_case
    dn, idx = g.distances[:SLAB], g.indices[:SLAB]
    jg = jknn.NeighborGraph(jnp.asarray(idx.numpy()),
                            jnp.asarray(dn.numpy()))
    _, jv = jops.pald_knn(jnp.asarray(D.numpy()), k=K_VALUES,
                          kind="distance", impl="jnp", block=8, ties=name,
                          graph=jg)
    vd, vf, vn = _sources(X, D, dn, idx, name, 0)
    assert vd.shape == (SLAB, K_VALUES + 1)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(vf, vd) and torch.equal(vn, vd)


@pytest.mark.parametrize("name", ["ignore", USER])
def test_large_k_values_honour_row_off(graph_case, name):
    """A slab of rows 300.. with ``row_off=300`` against the reference's
    tile body given those rows' global indices ("index of x > index of
    nbr_j" for the ``ignore`` tiebreak)."""
    X, D, g = graph_case
    r0 = 300
    dn, idx = g.distances[r0:r0 + SLAB], g.indices[r0:r0 + SLAB]
    ix = idx.numpy()
    gj = D.numpy()[ix[:, :, None], ix[:, None, :]]
    own = (r0 + np.arange(SLAB))[:, None] > ix
    jv = jknn.knn_values_tile(jnp.asarray(dn.numpy()), jnp.asarray(gj),
                              jnp.asarray(own), jw.resolve_weight(name))
    _, vf, vn = _sources(X, D, dn, idx, name, r0)
    np.testing.assert_allclose(vf.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(vn, vf)
    if name == "ignore":  # the offset moves the tiebreak
        assert not torch.equal(
            vf, pald_knn.knn_values_from_features_torch(X, dn, idx,
                                                        ties=name))


# ---------------------------------------------------------------------------
# the large-k variants' layouts and scratch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [None, 1, 8, 300])
@pytest.mark.parametrize("k", [1025, 2048, 4096, 16384])
def test_large_k_values_smem_fits_the_card(k, d):
    """Past ``LARGE_K`` a values block holds one row and keeps its state
    out of shared memory: the features source up to 64 features stages
    tiles of 256 neighbor rows at its padded width (features, norm, dn,
    index, W), past 64 tiles of 32 rows a piece of 32 features at a time
    beside the 256 threads' owned pieces;
    the D source (``d=None``) its reduction buffer (512 B) and the row's
    sorted positions while they fit in 64 KB."""
    smem = pald_knn.smem_per_cta(k, d)
    assert 0 <= smem <= 232448
    if d is None:
        assert smem == 512 + (4 * k if 4 * k <= 64 << 10 else 0)
    elif d <= 64:
        assert smem == 4 * 256 * (pald_knn.feature_width(d) + 4)
    else:
        assert smem == 4 * (32 + 256) * (32 + 4)


def test_large_k_scratch_bounds_the_rows_in_flight():
    """The large-k values scratch is 2 k float32 for each block of a grid:
    at most 1024 blocks an item and 65535 items a grid."""
    assert pald_knn.large_scratch(50_000, 2048) == 2 * 2048 * 1024
    assert pald_knn.large_scratch(700, 1500, items=3) == 2 * 1500 * 700 * 3
    assert pald_knn.large_scratch(2100, 2048, items=70_000) == \
        2 * 2048 * 1024 * 65535


def test_large_k_wrappers_take_the_plain_versions_on_the_cpu():
    """On the CPU the wrappers run the plain versions at any k and count
    no launch of either variant."""
    X = torch.from_numpy(_gauss_X(1030, 2, seed=3))
    wrappers = (pald_topk.topk_select_cuda,
                pald_knn.knn_values_from_features_cuda)
    before = [(f.launches, f.large_launches) for f in wrappers]
    g = pald_topk.topk_select_cuda(X, 1026)
    assert torch.equal(g.indices, pald_topk.topk_select_torch(X, 1026).indices)
    v = pald_knn.knn_values_from_features_cuda(X, g.distances[:2],
                                               g.indices[:2])
    assert v.shape == (2, 1027)
    assert [(f.launches, f.large_launches) for f in wrappers] == before


# ---------------------------------------------------------------------------
# the redesigned large-k kernels' host-side sizing and the padded width
# ---------------------------------------------------------------------------
N_MAIN = 50_000  # the k-NN example's n: every k past LARGE_K up to n - 1
WIDTHS = [1, 3, 8, 16, 17, 64, 65]


@pytest.mark.parametrize("d", WIDTHS)
def test_large_k_sizing_fits_the_card_at_every_k(d):
    """For every k from 1025 to n - 1 at n = 50,000: the selection's block
    (its ring and the rows' 2048-bin histograms, the same at every k) and
    the values block stay within the H100's 227 KB of shared memory; the
    values' scratch is 2 k float32 for each of its 1024 row blocks (the
    selection needs none: it sorts in shared memory or in its outputs)."""
    ks = np.arange(pald_topk.LARGE_K + 1, N_MAIN)
    sel = {pald_topk.smem_per_cta(int(k), d) for k in ks}
    assert len(sel) == 1 and 0 < sel.pop() <= 232448
    val = {pald_knn.smem_per_cta(int(k), d) for k in ks}
    # one tile of 256 rows at every k, past 64 features one of 32 rows and
    # the 256 owned pieces
    assert val == {4 * 256 * (pald_knn.feature_width(d) + 4) if d <= 64
                   else 4 * (32 + 256) * (32 + 4)}
    assert max(val) <= 232448
    scratch = np.array([pald_knn.large_scratch(N_MAIN, int(k)) for k in ks])
    np.testing.assert_array_equal(scratch, 2 * ks * 1024)
    assert 4 * scratch.max() <= 8 * N_MAIN * 1024  # 410 MB at k = n - 1


@pytest.mark.parametrize("d,width", [(0, 8), (1, 8), (3, 8), (8, 8),
                                     (9, 16), (16, 16), (17, 32),
                                     (24, 32), (32, 32), (33, 64),
                                     (64, 64), (65, 96), (96, 96),
                                     (300, 320)])
def test_large_k_feature_width(d, width):
    """Past LARGE_K the features source pads d to 8, 16, 32 or 64
    features in registers (``pald_knn_large.cu`` up to 16,
    ``pald_knn_wide.cu`` past); past 64 to whole pieces of 32 features
    (``pald_knn_piece.cu``)."""
    assert pald_knn.feature_width(d) == width


@pytest.mark.parametrize("k,d,entry", [
    (1, 8, "pald_knn_values_features_f32"),
    (1024, 300, "pald_knn_values_features_f32"),
    (1025, 0, "pald_knn_values_features_large_f32"),
    (1025, 16, "pald_knn_values_features_large_f32"),
    (1025, 17, "pald_knn_values_features_wide_f32"),
    (2048, 64, "pald_knn_values_features_wide_f32"),
    (4096, 65, "pald_knn_values_features_piece_f32"),
    (49_999, 300, "pald_knn_values_features_piece_f32")])
def test_features_source_picks_the_c_entry(k, d, entry):
    """The features source launches the four-rows layouts up to LARGE_K
    and the register tiles past it, as three C entries split at 16 and 64
    features, each a source the build compiles (and compiles again for a
    user functional)."""
    assert pald_knn.features_entry(k, d) == entry
    source = _build.SIGNATURES[entry][0]
    assert source in _build.SOURCES and source in _build.WEIGHT_SOURCES


def test_large_k_distance_source_sizing_at_every_k():
    """For every k from 1025 to n - 1 at n = 50,000 the D source's sweep
    block is whole warps of 8 columns each, at most 512 threads; its
    columns cover the row in one piece up to k = 4096 (each entry of the
    row's tile read once) and in the fewest pieces past it; its shared
    memory (the reduction buffer, the sorted positions up to 64 KB of
    them, else none: they go to the scratch beside W) stays within the
    H100's 227 KB; the scratch stays 2 k float32 a block."""
    for k in range(pald_knn.LARGE_K + 1, N_MAIN):
        threads, pieces, in_smem = pald_knn.sweep_layout(k)
        assert threads % 32 == 0 and 32 <= threads <= 512
        assert threads * 8 * pieces >= k > threads * 8 * (pieces - 1)
        assert (pieces == 1) == (k <= 4096)
        assert threads == (512 if k > 4096 else -(-k // 256) * 32)
        assert in_smem == (k <= 16384)
        smem = pald_knn.smem_per_cta(k)
        assert smem == 512 + (4 * k if in_smem else 0) <= 232448
        assert pald_knn.large_scratch(N_MAIN, k) == 2 * k * 1024


def _steps(X, metric):
    """pald_dist.cuh's steps in numpy float32, one feature at a time in
    order: the (n, n) pair sums and the rows' norm terms."""
    n, d = X.shape
    acc = np.zeros((n, n), np.float32)
    nrm = np.zeros(n, np.float32)
    for f in range(d):
        a, b = X[:, f, None], X[None, :, f]
        term = np.abs(a - b) if metric == "manhattan" else a * b
        acc = (acc + term).astype(np.float32)
        nrm = (nrm + X[:, f] * X[:, f]).astype(np.float32)
    return acc, nrm


@pytest.mark.parametrize("metric", METRICS)
def test_zero_padding_keeps_the_distances_bitwise(metric):
    """Zero features appended to every row add exactly +0 to each pair sum
    and norm (0 * 0 and |0 - 0| are +0, and a sum that starts at +0 is
    never -0), so the padded distances of all four metrics are bitwise
    the plain ones: numpy's float32 steps and ``cdist_reference``, on
    quantized rows with duplicates and zero rows."""
    for d in (1, 3, 5, 8, 13, 17, 33, 65):
        X = _dup_X(60, d, seed=d)
        X[7] = 0.0
        width = pald_knn.feature_width(d)
        Xp = np.concatenate([X, np.zeros((60, width - d), np.float32)], 1)
        for got, want in zip(_steps(Xp, metric), _steps(X, metric)):
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        ref = cdist_reference(torch.from_numpy(X), metric=metric)
        pad = cdist_reference(torch.from_numpy(Xp), metric=metric)
        assert torch.equal(pad.view(torch.int32), ref.view(torch.int32))
