"""The port's feature distances (repro_torch.core.features) against the JAX
reference's (repro.core.features), and the port's own contracts.

The port computes every dot, norm and absolute sum by a fixed-order loop
over the feature axis; the reference by matrix products whose sums XLA
orders by shape.  So the two agree to a tolerance, not bitwise: rtol 1e-5,
atol 1e-6 (cosine: atol 1e-5, a difference of two numbers near 1 loses
the relative precision of each).  Bitwise, the port's distances do not
depend on the tile an entry lies in, are symmetric, and keep the padding
contract of ``masked_dist_tile`` exactly as the reference does: +inf at
global index >= n_valid, exactly 0 on the global diagonal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import features as jfeatures
from repro_torch.core import features

RTOL = 1e-5
ATOL = {"sqeuclidean": 1e-6, "euclidean": 1e-6, "cosine": 1e-5,
        "manhattan": 1e-6}


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


def _X(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _dup_X(n, d, seed=0):
    """Features quantized to 0.1 with every fourth row a duplicate."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    X[3::4] = X[0:n - 3:4][:X[3::4].shape[0]]
    return X.astype(np.float32)


def test_metrics_match_reference():
    assert features.METRICS == jfeatures.METRICS
    assert features._NORM_EPS == jfeatures._NORM_EPS


@pytest.mark.parametrize("metric", features.METRICS)
def test_dist_tile_matches_reference(metric):
    A, B = _X(23, 5, seed=1), _X(17, 5, seed=2)
    got = features.dist_tile(torch.tensor(A), torch.tensor(B), metric)
    assert got.dtype == torch.float32 and got.shape == (23, 17)
    want = np.asarray(jfeatures.dist_tile(jnp.asarray(A), jnp.asarray(B),
                                          metric))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL[metric])


@pytest.mark.parametrize("metric", features.METRICS)
def test_masked_dist_tile_matches_reference(metric):
    """Offsets, padding rows past n_valid and the diagonal inside a tile."""
    X = _X(40, 6, seed=3)
    A, B = X[8:24], X[4:36]
    got = features.masked_dist_tile(torch.tensor(A), torch.tensor(B), metric,
                                    8, 4, 30).numpy()
    want = np.asarray(jfeatures.masked_dist_tile(
        jnp.asarray(A), jnp.asarray(B), metric, 8, 4, 30))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL[metric])
    rows = 8 + np.arange(16)[:, None]
    cols = 4 + np.arange(32)[None, :]
    assert (got[rows == cols] == 0).all()
    assert np.isinf(got[((rows >= 30) | (cols >= 30)) & (rows != cols)]).all()


@pytest.mark.parametrize("metric", features.METRICS)
def test_cdist_reference_matches_reference(metric):
    X = _X(31, 4, seed=4)
    D = features.cdist_reference(torch.tensor(X), metric=metric).numpy()
    Dj = np.asarray(jfeatures.cdist_reference(jnp.asarray(X), metric=metric))
    np.testing.assert_allclose(D, Dj, rtol=RTOL, atol=ATOL[metric])
    assert (np.diag(D) == 0).all()
    np.testing.assert_array_equal(D, D.T)  # bitwise symmetric


@pytest.mark.parametrize("metric", features.METRICS)
def test_cdist_reference_rectangular(metric):
    X, Y = _X(9, 3, seed=5), _X(14, 3, seed=6)
    D = features.cdist_reference(torch.tensor(X), torch.tensor(Y),
                                 metric=metric).numpy()
    Dj = np.asarray(jfeatures.cdist_reference(jnp.asarray(X), jnp.asarray(Y),
                                              metric=metric))
    np.testing.assert_allclose(D, Dj, rtol=RTOL, atol=ATOL[metric])


@pytest.mark.parametrize("metric", features.METRICS)
def test_distances_do_not_depend_on_the_tile(metric):
    """Every tile of every shape and offset holds bitwise the entries of
    the square matrix, duplicated rows and their residues included."""
    X = torch.tensor(_dup_X(45, 7, seed=7))
    D = features.cdist_reference(X, metric=metric)
    for (r0, r1), (c0, c1) in [((0, 45), (0, 45)), ((3, 20), (11, 45)),
                               ((17, 18), (0, 45)), ((40, 45), (2, 9))]:
        T = features.masked_dist_tile(X[r0:r1], X[c0:c1], metric, r0, c0, 45)
        assert torch.equal(T, D[r0:r1, c0:c1]), (r0, r1, c0, c1)
    # the transposed tile: d(a, b) and d(b, a) are the same operations
    T = features.masked_dist_tile(X[11:45], X[3:20], metric, 11, 3, 45)
    assert torch.equal(T, D[3:20, 11:45].T)


def test_duplicates_keep_the_reference_formula():
    """The residue of (na + nb) - 2 dot on duplicated rows is kept, as in
    the reference (no re-derivation as a sum of squared differences):
    duplicated rows tie exactly with each other's third points."""
    X = _dup_X(24, 5, seed=8)
    D = features.cdist_reference(torch.tensor(X), metric="sqeuclidean")
    a, b = 0, 3  # row 3 duplicates row 0
    assert np.array_equal(X[a], X[b])
    assert torch.equal(D[a, 5:], D[b, 5:])
    # the residue itself: what the formula gives, not 0
    na = float(features.row_norms(torch.tensor(X[a:a + 1]), "sqeuclidean"))
    acc = np.float32(0)
    for k in range(X.shape[1]):
        acc = np.float32(acc + np.float32(X[a, k] * X[b, k]))
    want = max(np.float32(np.float32(na + na) - np.float32(2 * acc)),
               np.float32(0))
    assert float(D[a, b]) == float(want)


def test_row_norms_and_zero_rows():
    """Cosine guards zero rows: distance 1 to everything else, 0 to itself,
    as in the reference."""
    X = _X(6, 3, seed=9)
    X[2] = 0.0
    D = features.cdist_reference(torch.tensor(X), metric="cosine").numpy()
    Dj = np.asarray(jfeatures.cdist_reference(jnp.asarray(X),
                                              metric="cosine"))
    np.testing.assert_allclose(D, Dj, rtol=RTOL, atol=ATOL["cosine"])
    assert (D[2, [0, 1, 3, 4, 5]] == 1.0).all() and D[2, 2] == 0.0
    assert torch.equal(features.row_norms(torch.tensor(X), "manhattan"),
                       torch.zeros(6))


def test_padding_contract():
    """Zero-padded rows become +inf from every real point and keep a zero
    diagonal, as in tests/test_fused_kernels.py for the reference."""
    X = torch.tensor(_X(8, 3, seed=10))
    Xp, n0 = features.pad_features(X, 12)
    assert n0 == 8 and Xp.shape == (12, 3) and (Xp[8:] == 0).all()
    D = features.masked_dist_tile(Xp, Xp, "euclidean", 0, 0, 8).numpy()
    assert np.isinf(D[8:, :8]).all() and np.isinf(D[:8, 8:]).all()
    assert (np.diag(D) == 0).all()
    assert np.isfinite(D[:8, :8]).all()
    Xj, nj = jfeatures.pad_features(jnp.asarray(X.numpy()), 12)
    np.testing.assert_array_equal(Xp.numpy(), np.asarray(Xj))
    assert nj == n0
    same, n1 = features.pad_features(X, 4)
    assert same is X and n1 == 8


def test_unknown_metric_raises():
    X = torch.zeros((3, 2))
    for fn in (lambda: features.dist_tile(X, X, "chebyshev"),
               lambda: features.cdist_reference(X, metric="chebyshev")):
        with pytest.raises(ValueError, match="unknown metric"):
            fn()


def test_square_root_is_correctly_rounded():
    """The plain versions' square root is IEEE's (numpy's float32 sqrt, and
    __fsqrt_rn in the kernels) wherever an entry lies in its tensor."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.random(200_003) * 100, rng.random(1000) * 1e-30,
                        [0.0, 1e-30, np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(features._sqrt_rn(torch.tensor(x)).numpy(),
                                  np.sqrt(x))
