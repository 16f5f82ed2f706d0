"""User-registered weight functionals: the port against the JAX reference.

The same three user functionals are registered at test time in both
packages' registries (jnp and torch spellings): a strict one (``drop``'s
callables), one with the index tiebreak (``ignore``'s) and a smooth one
with ``exp`` and a ``share``.  Nothing in the reference changes: it traces
them into its Pallas bodies, run here in interpret mode (the k-NN path:
its jnp body).  On this CPU the port runs its plain versions on the
callables, and on the callables rebuilt from the compiled IR
(``kernels/_functor.evaluate``: what the card's functor is emitted from).
C is held within rtol 1e-5, atol 1e-6 (tests/test_conformance.py), U
bitwise for the strict functionals, n <= 64.  The card runs the functors
themselves (tests/test_torch_cuda.py, ``chip_smoke.py`` phase 29).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pald as jpald
from repro.core import weights as jw
from repro.kernels import ops as jops
from repro_torch.core import pald
from repro_torch.core import weights as tw
from repro_torch.core.features import cdist_reference
from repro_torch.kernels import _functor, ops

RTOL, ATOL = 1e-5, 1e-6


def _smooth(xp, where, clamp, name):
    """The smooth functional in one array library's spelling."""
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


def _both(name, port_base=None, ref_base=None, **flags):
    if port_base is None:
        f, s, sh = _smooth(torch, torch.where, torch.clamp, name)
        jf, js, jsh = _smooth(jnp, jnp.where, jnp.clip, name)
    else:
        f, s, sh = port_base.focus, port_base.support, None
        jf, js, jsh = ref_base.focus, ref_base.support, None
    return (tw.WeightFunctional(name, f, s, share=sh, **flags),
            jw.WeightFunctional(name, jf, js, share=jsh, **flags))


FAMILIES = {
    "_user_strict": _both("_user_strict", tw.DROP, jw.DROP, is_strict=True),
    "_user_tiebreak": _both("_user_tiebreak", tw.IGNORE, jw.IGNORE,
                            needs_index_tiebreak=True, conserves_mass=True,
                            is_strict=True),
    "_user_smooth": _both("_user_smooth"),
}


def _from_ir(w):
    """``w`` with callables that run its compiled IR (the programs the
    card's functor is emitted from)."""
    progs = _functor.compile_functional(w).programs
    tb = w.needs_index_tiebreak

    def support(o, t, p, own_wins=None):
        return _functor.evaluate(progs["support"], o, t, p,
                                 *([own_wins] if tb else []))

    share = (None if "share" not in progs else
             lambda o, t: _functor.evaluate(progs["share"], o, t))
    return tw.WeightFunctional(
        w.name + "_ir", lambda a, b, c: _functor.evaluate(progs["focus"], a,
                                                          b, c),
        support, share=share, needs_index_tiebreak=tb,
        conserves_mass=w.conserves_mass, is_strict=w.is_strict)


@pytest.fixture(autouse=True, scope="module")
def _registered(tmp_path_factory):
    """Both registries hold the three functionals for this module only;
    both packages' tuning caches point at a temporary directory."""
    d = tmp_path_factory.mktemp("tuning")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(d / "port.json"))
        mp.setenv("REPRO_TUNE_CACHE", str(d / "reference.json"))
        for tw_w, jw_w in FAMILIES.values():
            tw.register_weight(tw_w)
            jw.register_weight(jw_w)
        try:
            yield
        finally:
            for name in FAMILIES:
                tw._REGISTRY.pop(name, None)
                jw._REGISTRY.pop(name, None)


def _ports(name):
    """The port's functional, by name and rebuilt from its IR."""
    w = FAMILIES[name][0]
    return {"callables": name, "ir": _from_ir(w)}


def _D(n, seed):
    """Tie-heavy quantized distances (duplicated points: zero distances)."""
    X = np.random.default_rng(seed).integers(0, 5, size=(n, 3))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("schedule", ["dense", "tri"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_cohesion_kernel_matches_reference(name, schedule):
    D = _D(40, seed=1)
    Cj = jpald.cohesion(jnp.asarray(D), method="kernel", impl="interpret",
                        schedule=schedule, block=16, block_z=16, weight=name)
    for how, w in _ports(name).items():
        C = pald.cohesion(D, method="kernel", schedule=schedule, weight=w,
                          device="cpu")
        assert C.dtype == torch.float32 and C.shape == (40, 40), how
        _close(C.numpy(), Cj)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_focus_matches_reference(name):
    """U of the reference's focus kernel (interpret): bitwise for the
    strict functionals."""
    D = _D(48, seed=2)
    Uj = np.asarray(jops.focus(jnp.asarray(D), block=16, block_z=16,
                               impl="interpret", ties=name))
    for how, w in _ports(name).items():
        U = ops.focus(torch.from_numpy(D), impl="torch", ties=w).numpy()
        if FAMILIES[name][0].is_strict:
            np.testing.assert_array_equal(U, Uj, err_msg=how)
        else:
            _close(U, Uj)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_from_features_matches_reference(name):
    X = np.random.default_rng(3).normal(size=(45, 4)).astype(np.float32)
    Cj = jpald.from_features(jnp.asarray(X), method="fused", block=16,
                             weight=name)
    for how, w in _ports(name).items():
        C = pald.from_features(X, method="fused", weight=w, device="cpu")
        _close(C.numpy(), Cj)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_knn_matches_reference(name):
    """``method="knn"`` on distances and ``from_features(X, k=)``, both
    against the reference's k-NN cohesion."""
    X = np.random.default_rng(4).normal(size=(40, 3)).astype(np.float32)
    D = cdist_reference(torch.from_numpy(X)).numpy()
    Cj = jpald.cohesion(jnp.asarray(D), method="knn", k=9, weight=name,
                        block=16, impl="jnp")
    for how, w in _ports(name).items():
        _close(pald.cohesion(D, k=9, weight=w, device="cpu").numpy(), Cj)
        _close(pald.from_features(X, k=9, weight=w, device="cpu").numpy(),
               Cj)
