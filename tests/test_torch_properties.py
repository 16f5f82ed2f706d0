"""The reference's hypothesis laws (``tests/test_pald_properties.py``,
``tests/test_ties_properties.py``) held on the port, on the CPU.

PaLD's cohesion depends only on the order of the distances; it conserves
mass (n/2 on tie-free input, and per pair for the functionals that
declare it), is permutation-equivariant, and every method computes the
same C.  Each law runs on ``repro_torch`` with ``device="cpu"`` (the plain
versions); one law also holds the port's C against the JAX package's on
the same tied draws.  The sharded laws of the reference wait for the
port's distributed slice.  ``tests/test_torch_cuda.py`` runs the laws
that reach the focus kernels' mirror logic on the card.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from hypothesis import assume, given, settings, strategies as st

from repro.core import pald as jpald
from repro_torch.core import pald, reference
from repro_torch.core.weights import (TIE_MODES, registered_weights,
                                      resolve_weight)

from conftest import euclidean_distance_matrix


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


def _cohesion(D, **kw):
    return pald.cohesion(D, device="cpu", **kw).numpy()


@st.composite
def distance_matrices(draw, nmin=4, nmax=24, dim=3):
    """Euclidean distances of n drawn points, jittered deterministically
    so that no two points coincide (the reference's strategy)."""
    n = draw(st.integers(nmin, nmax))
    flat = draw(st.lists(st.floats(-100, 100, allow_nan=False, width=32),
                         min_size=n * dim, max_size=n * dim))
    X = np.asarray(flat, np.float64).reshape(n, dim)
    X = X + np.arange(n * dim).reshape(n, dim) * 1e-3
    return euclidean_distance_matrix(X)


@st.composite
def tied_distance_matrices(draw, nmin=4, nmax=12, values=4):
    """Symmetric integer distances from {1..values} off the diagonal:
    n (n - 1) / 2 >= 6 pairs over <= 4 values force ties."""
    n = draw(st.integers(nmin, nmax))
    flat = draw(st.lists(st.integers(1, values),
                         min_size=n * (n - 1) // 2,
                         max_size=n * (n - 1) // 2))
    D = np.zeros((n, n))
    D[np.triu_indices(n, 1)] = flat
    return D + D.T


def _tie_free(D) -> bool:
    iu = np.triu_indices(D.shape[0], 1)
    return len(np.unique(D[iu])) == len(iu[0])


@settings(max_examples=25, deadline=None)
@given(distance_matrices())
def test_total_mass_is_half_n(D):
    """sum C = n/2 on tie-free input (a tie drops its mass under the
    default ``drop``)."""
    n = D.shape[0]
    assume(_tie_free(D))
    assert abs(_cohesion(D, method="dense").sum() - n / 2) < 1e-3 * n


@settings(max_examples=25, deadline=None)
@given(distance_matrices())
def test_monotone_transform_invariance(D):
    """C depends only on the ordering of the distances."""
    D2 = np.sqrt(D) * 3.0 + np.tanh(D)  # strictly increasing on [0, inf)
    np.fill_diagonal(D2, 0.0)
    np.testing.assert_allclose(_cohesion(D2, method="dense"),
                               _cohesion(D, method="dense"),
                               rtol=1e-4, atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(distance_matrices(), st.randoms(use_true_random=False))
def test_permutation_equivariance(D, rnd):
    perm = list(range(D.shape[0]))
    rnd.shuffle(perm)
    perm = np.asarray(perm)
    C = _cohesion(D, method="dense")
    Cp = _cohesion(D[np.ix_(perm, perm)], method="dense")
    np.testing.assert_allclose(Cp, C[np.ix_(perm, perm)], rtol=1e-4,
                               atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(distance_matrices())
def test_methods_agree(D):
    """The blocked pairwise, block-symmetric and kernel pipelines (their
    plain versions) agree with the dense formulation."""
    Cd = _cohesion(D, method="dense")
    for method in ("pairwise", "triplet", "kernel"):
        np.testing.assert_allclose(_cohesion(D, method=method, block=8), Cd,
                                   rtol=1e-4, atol=1e-5, err_msg=method)
    np.testing.assert_allclose(
        _cohesion(D, method="kernel", schedule="tri", block=8), Cd,
        rtol=1e-4, atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(distance_matrices())
def test_self_cohesion_dominates_row(D):
    """c_xx >= c_xz: a point supports itself in every focus it is in."""
    C = _cohesion(D, method="dense")
    assert (np.diag(C)[:, None] >= C - 1e-9).all()


@settings(max_examples=25, deadline=None)
@given(distance_matrices())
def test_cohesion_nonnegative_bounded(D):
    C = _cohesion(D, method="dense")
    assert (C >= -1e-12).all()
    assert (C <= 1.0 + 1e-9).all()


@settings(max_examples=15, deadline=None)
@given(tied_distance_matrices(), st.sampled_from(TIE_MODES))
def test_tied_draws_match_reference(D, ties):
    Cref = reference.pald_pairwise_reference(D, ties=ties, normalize=True)
    np.testing.assert_allclose(_cohesion(D, method="dense", ties=ties), Cref,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _cohesion(D, method="kernel", schedule="tri", block=8, ties=ties),
        Cref, rtol=1e-5, atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(tied_distance_matrices(), st.sampled_from(TIE_MODES))
def test_tied_draws_match_jax_package(D, ties):
    """The same tied draw through the JAX package and the port."""
    Cj = np.asarray(jpald.cohesion(jnp.asarray(D), method="dense", ties=ties))
    np.testing.assert_allclose(_cohesion(D, method="dense", ties=ties), Cj,
                               rtol=1e-5, atol=1e-6)


@settings(max_examples=15, deadline=None)
@given(tied_distance_matrices())
def test_tied_draws_mass_laws(D):
    n = D.shape[0]
    pairs = n * (n - 1) / 2
    total = {t: reference.pald_pairwise_reference(D, ties=t).sum()
             for t in TIE_MODES}
    assert abs(total["split"] - pairs) < 1e-9
    assert abs(total["ignore"] - pairs) < 1e-9
    assert total["drop"] <= pairs + 1e-9


_MASS_CONSERVING = tuple(name for name in registered_weights()
                         if resolve_weight(name).conserves_mass)


@settings(max_examples=10, deadline=None)
@given(tied_distance_matrices(), st.sampled_from(_MASS_CONSERVING))
def test_declared_mass_conservation(D, name):
    """Every functional that declares mass conservation gives each pair
    weight 1 in total."""
    n = D.shape[0]
    pairs = n * (n - 1) / 2
    total = float(_cohesion(D, method="dense", normalize=False,
                            weight=name).sum())
    assert abs(total - pairs) < 1e-3 * pairs


@settings(max_examples=10, deadline=None)
@given(tied_distance_matrices(),
       st.sampled_from(tuple(n for n in registered_weights()
                             if n not in TIE_MODES)))
def test_new_functionals_mass_bounded(D, name):
    """Every functional distributes at most weight 1 per pair."""
    n = D.shape[0]
    pairs = n * (n - 1) / 2
    C = _cohesion(D, method="dense", normalize=False, weight=name)
    assert np.all(C >= -1e-6)
    assert C.sum() <= pairs * (1 + 1e-4)


def test_mass_conserving_families_are_declared():
    """The laws above quantify over the registry: it holds the three tie
    modes and at least one smooth family."""
    assert set(TIE_MODES) <= set(registered_weights())
    assert {"split", "ignore"} <= set(_MASS_CONSERVING)
    assert any(n not in TIE_MODES for n in registered_weights())
