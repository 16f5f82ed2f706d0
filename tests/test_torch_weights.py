"""The port's weight-functional algebra (repro_torch.core.weights) against
the JAX reference (repro.core.weights).

The port's torch bodies repeat the reference's jnp expressions op for op,
so on the same float32 inputs both weights must be BITWISE equal, for every
built-in family: on random values, on the 12-point tie matrix of
tests/test_weights.py, and on +inf padding (where inf - inf = nan must be
guarded to an exact zero in both).  Inputs are made with numpy from a seed
and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import weights as jw
from repro_torch.core import weights as tw
from repro_torch.kernels.pald_cohesion import cohesion_general_cuda
from repro_torch.kernels.pald_focus import focus_general_cuda

BUILTINS = ["drop", "split", "ignore", "soft", "kernelized"]
PARAMETRIZED = [("soft_threshold", 0.05), ("soft_threshold", 1e-4),
                ("kernelized", 0.5), ("kernelized", 3.0)]


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


def _tie_matrix():
    """The 12-point integer tie matrix of tests/test_weights.py."""
    rng = np.random.default_rng(42)
    A = rng.integers(1, 6, size=(12, 12))
    D = np.triu(A, 1)
    return (D + D.T).astype(np.float32)


def _random_triples(seed=0, a=9, b=7, c=11):
    rng = np.random.default_rng(seed)
    return (rng.random((a, 1, c), dtype=np.float32) * 3,
            rng.random((1, b, c), dtype=np.float32) * 3,
            rng.random((a, b, 1), dtype=np.float32) * 3)


def _tie_triples():
    D = _tie_matrix()
    return D[:, None, :], D[None, :, :], D[:, :, None]


def _padded_triples():
    """Distances with +inf padding rows/columns, inf-inf cases included."""
    rng = np.random.default_rng(3)
    D = rng.integers(0, 4, size=(10, 10)).astype(np.float32)
    D[7:, :] = np.inf
    D[:, 8:] = np.inf
    return D[:, None, :], D[None, :, :], D[:, :, None]


INPUTS = {"random": _random_triples, "ties12": _tie_triples,
          "inf_padding": _padded_triples}


def _own_wins(shape, seed=1):
    return np.random.default_rng(seed).random(shape) < 0.5


def _both(triples):
    return ([torch.from_numpy(np.ascontiguousarray(t)) for t in triples],
            [jnp.asarray(t) for t in triples])


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("name", BUILTINS)
def test_focus_weight_bitwise(name, inputs):
    (a, b, c), (ja, jb, jc) = _both(INPUTS[inputs]())
    got = tw.focus_weight(a, b, c, name)
    want = np.asarray(jw.focus_weight(ja, jb, jc, name))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("name", BUILTINS)
def test_support_weight_bitwise(name, inputs):
    (a, b, c), (ja, jb, jc) = _both(INPUTS[inputs]())
    own = own_j = None
    if tw.resolve_weight(name).needs_index_tiebreak:
        shape = np.broadcast_shapes(a.shape, b.shape, c.shape)
        w = _own_wins(shape)
        own, own_j = torch.from_numpy(w), jnp.asarray(w)
    got = tw.support_weight(a, b, c, name, own)
    want = np.asarray(jw.support_weight(ja, jb, jc, name, own_j))
    assert got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("factory,param", PARAMETRIZED)
def test_parametrized_families_bitwise(factory, param):
    """Non-default temperatures / bandwidths, both weights, all inputs."""
    wt = getattr(tw, factory)(param)
    wj = getattr(jw, factory)(param)
    assert wt.name == wj.name
    for make in INPUTS.values():
        (a, b, c), (ja, jb, jc) = _both(make())
        np.testing.assert_array_equal(
            tw.focus_weight(a, b, c, wt).numpy(),
            np.asarray(jw.focus_weight(ja, jb, jc, wj)))
        np.testing.assert_array_equal(
            tw.support_weight(a, b, c, wt).numpy(),
            np.asarray(jw.support_weight(ja, jb, jc, wj)))


def test_soft_share_bitwise():
    (a, b, _), (ja, jb, _) = _both(_padded_triples())
    got = tw.soft_threshold().share(a, b).numpy()
    want = np.asarray(jw.soft_threshold().share(ja, jb))
    np.testing.assert_array_equal(got, want)


def test_padding_contributes_exact_zero():
    """+inf operands: focus membership and support are exact zeros."""
    inf = torch.tensor([np.inf], dtype=torch.float32)
    one = torch.tensor([1.0], dtype=torch.float32)
    for name in BUILTINS:
        assert tw.focus_weight(inf, inf, one, name).item() == 0.0
        own = torch.tensor([True])
        assert tw.support_weight(inf, inf, one, name, own).item() == 0.0
        assert tw.support_weight(inf, one, one, name, own).item() == 0.0


@pytest.mark.parametrize("offs", [(0, 0), (5, 2), (3, 11)])
def test_index_xwins_matches_reference(offs):
    got = tw.index_xwins(offs[0], 7, offs[1], 9).numpy()
    want = np.asarray(jw.index_xwins(offs[0], 7, offs[1], 9))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# registry, resolution and declared properties
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert set(BUILTINS) <= set(tw.registered_weights())
    assert tw.TIE_MODES == jw.TIE_MODES
    assert tw.DEFAULT_TIES == jw.DEFAULT_TIES


@pytest.mark.parametrize("name", BUILTINS)
def test_properties_match_reference(name):
    assert (tw.resolve_weight(name).properties()
            == jw.resolve_weight(name).properties())


def test_resolve_weight_name_instance_none():
    w = tw.resolve_weight("split")
    assert isinstance(w, tw.WeightFunctional) and w.name == "split"
    assert tw.resolve_weight(w) is w
    assert tw.resolve_weight(None).name == tw.DEFAULT_TIES


def test_resolve_unknown_lists_registered():
    with pytest.raises(ValueError) as ei:
        tw.resolve_weight("bogus")
    for name in tw.registered_weights():
        assert name in str(ei.value)


def test_validate_ties():
    assert tw.validate_ties("ignore") == "ignore"
    assert tw.validate_ties(tw.IGNORE) == "ignore"
    with pytest.raises(ValueError, match="weight="):
        tw.validate_ties("soft")


def test_register_duplicate_rejected_and_overwrite():
    w1 = tw.WeightFunctional("_dup_test", tw.DROP.focus, tw.DROP.support)
    w2 = tw.WeightFunctional("_dup_test", tw.SPLIT.focus, tw.SPLIT.support)
    try:
        tw.register_weight(w1)
        assert tw.register_weight(w1) is w1  # same instance: idempotent
        with pytest.raises(ValueError, match="already registered"):
            tw.register_weight(w2)
        tw.register_weight(w2, overwrite=True)
        assert tw.resolve_weight("_dup_test") is w2
    finally:
        tw._REGISTRY.pop("_dup_test", None)


def test_factories_memoized():
    assert tw.soft_threshold(0.2) is tw.soft_threshold(0.2)
    assert tw.kernelized(2.0) is tw.kernelized(2.0)
    assert tw.resolve_weight("soft") is tw.soft_threshold()


# ---------------------------------------------------------------------------
# the kernel seam: ids and parameters, and user functionals' specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,wid", [("drop", 0), ("split", 1),
                                      ("ignore", 2), ("soft", 3),
                                      ("kernelized", 4)])
def test_kernel_spec_builtins(name, wid):
    kid, p0, p1 = tw.kernel_spec(name)
    assert kid == wid
    if name == "soft":
        assert (p0, p1) == (10.0, 2.5)
    elif name == "kernelized":
        assert (p0, p1) == (1.0, 0.0)
    else:
        assert (p0, p1) == (0.0, 0.0)


def _user_functional():
    return tw.WeightFunctional("_user_half", lambda a, b, c: 0.5 * (a < c),
                               lambda o, t, p, w=None: 0.5 * (o < p))


def _untraceable_functional():
    return tw.WeightFunctional("_user_cos", lambda a, b, c: torch.cos(a - c),
                               lambda o, t, p, w=None: 0.5 * (o < p))


def test_kernel_spec_user_functional_raises():
    """A traceable user functional gets the user id and its compiled key
    (the kernels run its generated functor); one with an op outside the
    compiler's table raises, naming the op."""
    spec = tw.kernel_spec(_user_functional())
    assert tuple(spec) == (tw.KERNEL_USER, 0.0, 0.0)
    assert spec.key is not None and len(spec.key) == 16
    with pytest.raises(NotImplementedError, match=r"_user_cos.*aten\.cos"):
        tw.kernel_spec(_untraceable_functional())


class _OnCuda:
    """Stands in for a CUDA tensor: the wrappers read only its device
    before they compile the functional."""

    device = torch.device("cuda", 0)


def test_user_functional_raises_on_cuda_wrappers():
    """On the card the wrappers compile the functional before anything
    else: an untraceable one raises there, naming its op."""
    user = _untraceable_functional()
    with pytest.raises(NotImplementedError, match="aten.cos"):
        focus_general_cuda(_OnCuda(), None, None, ties=user)
    with pytest.raises(NotImplementedError, match="aten.cos"):
        cohesion_general_cuda(_OnCuda(), None, None, None, ties=user)


def test_user_functional_runs_on_cpu():
    """The plain paths take any functional: the CPU route of the wrapper
    evaluates the Python callables."""
    user = _user_functional()
    D = torch.from_numpy(_tie_matrix())
    U = focus_general_cuda(D, D, D, ties=user)
    assert U.shape == (12, 12) and torch.isfinite(U).all()
