"""The port's upper-triangular schedule (tri) and block-symmetric method
(triplet) against the JAX reference.

On this CPU the port runs the tri kernels' plain versions
(``pald_focus_tri.focus_tri_torch`` / ``pald_cohesion_tri.
cohesion_tri_torch``; the CUDA wrappers take them for CPU tensors).  They
are held to the reference's ``focus_tri_pallas`` / ``cohesion_tri_pallas``
in interpret mode (bit-faithful to the TPU kernel body; n <= 64, block 16),
and to the reference's ``ops.focus`` / ``ops.cohesion_from_weights`` /
``ops.pald_tri`` with ``impl="jnp"`` up to n = 130, on symmetric, tie-heavy
distances (multiples of 0.5, some +inf pairs, zero diagonal), ragged n,
every built-in functional.  U is bitwise for every functional whose focus
is an exact count (all but ``soft``); C, and the smooth ``soft`` U, to
rtol 1e-5, atol 1e-6 (the conformance tolerance of
tests/test_conformance.py): the two sum their terms in another order.
The port's tri is held to its own dense schedule the same way, and
``method="triplet"`` to the reference's ``pald_block_symmetric``.

The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py`` (phases 12-14).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pald as jpald
from repro.kernels import ops as jops
from repro.kernels.pald_cohesion_tri import cohesion_tri_pallas
from repro.kernels.pald_focus_tri import focus_tri_pallas
from repro_torch.core import engine, pald
from repro_torch.core.features import cdist_reference
from repro_torch.kernels import ops, pald_cohesion_tri, pald_focus_tri
from repro_torch.kernels.ref import weights_ref

RTOL, ATOL = 1e-5, 1e-6
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized"]
NS = [1, 2, 17, 33, 64, 65, 130]
BLOCK = 16


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


def _tri_D(n, seed=0):
    """Symmetric float32 distances: multiples of 0.5 (many exact ties), a
    few +inf pairs, an exactly-zero diagonal."""
    rng = np.random.default_rng(500 + n + seed)
    A = rng.integers(1, 8, size=(n, n)).astype(np.float32) * 0.5
    A[rng.random((n, n)) < 0.03] = np.inf
    D = np.triu(A, 1)
    D = D + D.T
    np.fill_diagonal(D, 0.0)
    return D


def _assert_u(name, got, want):
    if name.startswith("soft"):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _port_U(D, name):
    return ops.focus(torch.from_numpy(D), block=BLOCK, block_z=BLOCK,
                     impl="torch", schedule="tri", ties=name).numpy()


def _port_C(D, W, name):
    return ops.cohesion_from_weights(
        torch.from_numpy(D), torch.from_numpy(W), block=BLOCK,
        block_z=BLOCK, impl="torch", schedule="tri", ties=name).numpy()


def _jax_tri(fn, *args, impl, name):
    return np.asarray(fn(*[jnp.asarray(a) for a in args], block=BLOCK,
                         block_z=BLOCK, impl=impl, schedule="tri",
                         ties=name))


# ---------------------------------------------------------------------------
# the two kernel modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_focus_tri_matches_reference(name, n):
    D = _tri_D(n)
    U = _port_U(D, name)
    _assert_u(name, U, _jax_tri(jops.focus, D, impl="jnp", name=name))
    if n <= 64:
        _assert_u(name, U, _jax_tri(jops.focus, D, impl="interpret",
                                    name=name))
    np.testing.assert_array_equal(U, U.T)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cohesion_tri_matches_reference(name, n):
    D = _tri_D(n)
    W = weights_ref(torch.from_numpy(_port_U(D, name))).numpy()
    C = _port_C(D, W, name)
    impls = ("jnp", "interpret") if n <= 64 else ("jnp",)
    for impl in impls:
        Cj = _jax_tri(jops.cohesion_from_weights, D, W, impl=impl, name=name)
        np.testing.assert_allclose(C, Cj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_tri_plain_versions_match_pallas_kernels(name, n):
    """The plain versions against the TPU kernels themselves (interpret
    mode), at a tile multiple: block 16, z tile 16."""
    D = _tri_D(n, seed=1)
    Dj = jnp.asarray(D)
    U = pald_focus_tri.focus_tri_torch(torch.from_numpy(D), block=BLOCK,
                                       ties=name).numpy()
    _assert_u(name, U, np.asarray(focus_tri_pallas(
        Dj, block=BLOCK, block_z=BLOCK, interpret=True, ties=name)))
    W = weights_ref(torch.from_numpy(U)).numpy()
    C = pald_cohesion_tri.cohesion_tri_torch(
        torch.from_numpy(D), torch.from_numpy(W), block=BLOCK,
        ties=name).numpy()
    Cj = cohesion_tri_pallas(Dj, jnp.asarray(W), block=BLOCK, block_z=BLOCK,
                             interpret=True, ties=name)
    np.testing.assert_allclose(C, np.asarray(Cj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_tri_matches_dense_schedule(name, n):
    """The port's tri against its own dense schedule at a ragged n: U
    bitwise for the exact families, C to the conformance tolerance.  The
    two schedules' entry points count the padded z of other extents, as
    the reference's do (the tri one pads to max(block, block_z), the dense
    one only where the tile has no reasonable divisor), so under ``split``
    the U of an +inf pair differs by 0.5 per z of the difference; the
    cohesion schedules are compared on the same weights."""
    D = _tri_D(n)
    Dt = torch.from_numpy(D)
    kw = dict(block=BLOCK, block_z=BLOCK, impl="torch", ties=name)
    Ut = ops.focus(Dt, schedule="tri", **kw).numpy()
    Ud = ops.focus(Dt, **kw).numpy()
    if name == "split":
        tri_pad = -(-n // BLOCK) * BLOCK
        dense_pad = jops._block_and_pad(n, BLOCK)[1]
        Ud = Ud + 0.5 * (tri_pad - dense_pad) * np.isinf(D)
    _assert_u(name, Ut, Ud)
    W = weights_ref(torch.from_numpy(Ut))
    np.testing.assert_allclose(
        ops.pald(Dt, schedule="tri", **kw).numpy(),
        ops.cohesion_from_weights(Dt, W, **kw).numpy(), rtol=RTOL,
        atol=ATOL)


def test_tri_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the CUDA wrappers run the plain versions and count
    no launch."""
    D = torch.from_numpy(_tri_D(33))
    f0 = pald_focus_tri.focus_tri_cuda.launches
    c0 = pald_cohesion_tri.cohesion_tri_cuda.launches
    U = pald_focus_tri.focus_tri_cuda(D, ties="ignore")
    torch.testing.assert_close(
        U, pald_focus_tri.focus_tri_torch(D, ties="ignore"), rtol=0, atol=0)
    W = weights_ref(U)
    torch.testing.assert_close(
        pald_cohesion_tri.cohesion_tri_cuda(D, W, ties="ignore"),
        pald_cohesion_tri.cohesion_tri_torch(D, W, ties="ignore"), rtol=0,
        atol=0)
    assert pald_focus_tri.focus_tri_cuda.launches == f0
    assert pald_cohesion_tri.cohesion_tri_cuda.launches == c0


@pytest.mark.parametrize("n,block", [(7, 2), (9, 3), (10, 4), (1, 16)])
def test_tri_pairs(n, block):
    """Upper block pairs X-major as numpy's triu_indices orders them, the
    last block ragged."""
    nb = -(-n // block)
    xs, ys = np.triu_indices(nb)
    want = [((x * block, min(x * block + block, n)),
             (y * block, min(y * block + block, n))) for x, y in zip(xs, ys)]
    assert pald_focus_tri.tri_pairs(n, block) == want


# ---------------------------------------------------------------------------
# the pipeline and the facades
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 33, 130])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_pald_tri_matches_reference(name, n):
    """As the kernel executor calls it: on D padded to the tile by the
    engine, with the padded points' weights zeroed (``n_valid``)."""
    Dp, _ = engine.pad_distance_matrix(torch.from_numpy(_tri_D(n, seed=2)),
                                       BLOCK)
    nv = n if Dp.shape[0] != n else None
    kw = dict(block=BLOCK, block_z=BLOCK, n_valid=nv, ties=name)
    C = ops.pald_tri(Dp, impl="torch", **kw).numpy()
    Cj = jops.pald_tri(jnp.asarray(Dp.numpy()), impl="jnp", **kw)
    np.testing.assert_allclose(C, np.asarray(Cj), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        ops.pald(Dp, impl="torch", schedule="tri", **kw).numpy(), C)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_pald_block_symmetric_matches_reference(name, n):
    """``core.triplet.pald_block_symmetric`` against the reference's, with
    its signature and its block-multiple assertion."""
    from repro.core.triplet import pald_block_symmetric as jblock_symmetric
    from repro_torch.core.triplet import pald_block_symmetric

    D = _tri_D(n, seed=4)
    C = pald_block_symmetric(torch.from_numpy(D), block=32, ties=name)
    Cj = jblock_symmetric(jnp.asarray(D), block=32, ties=name)
    assert C.dtype == torch.float32
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(AssertionError, match="block multiple"):
        pald_block_symmetric(torch.from_numpy(D[:-1, :-1].copy()), block=32)


@pytest.mark.parametrize("n", [7, 40])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_cohesion_tri_facade_matches_reference(name, n):
    D = _tri_D(n, seed=3)
    kw = dict(method="kernel", schedule="tri", weight=name, block=BLOCK)
    C = pald.cohesion(D, device="cpu", **kw)
    assert C.dtype == torch.float32 and C.device.type == "cpu"
    Cj = jpald.cohesion(jnp.asarray(D), **kw)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n", [2, 33, 130])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_triplet_matches_reference(name, n):
    D = _tri_D(n, seed=4)
    kw = dict(method="triplet", weight=name, block=BLOCK)
    C = pald.cohesion(D, device="cpu", **kw).numpy()
    Cj = jpald.cohesion(jnp.asarray(D), **kw)
    np.testing.assert_allclose(C, np.asarray(Cj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        C, pald.cohesion(D, method="kernel", weight=name, block=BLOCK,
                         device="cpu").numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["triplet", "kernel"])
def test_batched_tri_and_triplet_match_reference(method):
    Db = np.stack([_tri_D(21, seed=s) for s in range(3)])
    kw = dict(method=method, ties="ignore", block=8)
    if method == "kernel":
        kw["schedule"] = "tri"
    C = pald.cohesion(Db, device="cpu", **kw).numpy()
    assert C.shape == (3, 21, 21)
    np.testing.assert_allclose(C, np.asarray(jpald.cohesion(jnp.asarray(Db),
                                                            **kw)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("knobs", [{"method": "triplet"},
                                   {"schedule": "tri"},
                                   {"method": "kernel", "schedule": "tri"}])
def test_from_features_tri_and_triplet_materialize_D(knobs):
    """On features, triplet and the tri kernel pipeline materialize D once
    and run the distance cell of the same method and schedule."""
    X = np.round(np.random.default_rng(5).normal(size=(30, 3)) * 4) / 4
    C = pald.from_features(X, device="cpu", ties="ignore", block=8, **knobs)
    p = pald.plan(X, kind="features", device="cpu", ties="ignore", block=8,
                  **knobs)
    D = cdist_reference(torch.as_tensor(X, dtype=torch.float32))
    dist = {**knobs, "method": p.method}
    np.testing.assert_array_equal(
        C.numpy(), pald.cohesion(D, device="cpu", ties="ignore", block=8,
                                 **dist).numpy())
    Cj = jpald.from_features(jnp.asarray(X, jnp.float32), ties="ignore",
                             block=8, **knobs)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["distance", "features"])
def test_plan_auto_with_tri_resolves_to_kernel(kind):
    x = _tri_D(20) if kind == "distance" else np.ones((20, 3))
    info = pald.plan(x, kind=kind, schedule="tri", device="cpu").explain()
    assert info["method"] == "kernel" and info["schedule"] == "tri"
    assert info["method_source"] == "schedule=tri"
    assert info["impl"] == "torch"
    assert info["executor"].endswith(
        "ops._exec_kernel_tri" if kind == "distance"
        else "engine._materialize_then")
    assert info["est_smem_bytes_per_cta"] == max(
        pald_focus_tri.SMEM_PER_CTA, pald_cohesion_tri.SMEM_PER_CTA)


@pytest.mark.parametrize("schedule", ["dense", "tri"])
def test_kernel_smem_estimate_follows_schedule(schedule):
    """explain() reports the shared memory of the kernels that the
    schedule launches."""
    from repro_torch.kernels import pald_cohesion, pald_focus

    mods = {"dense": (pald_focus, pald_cohesion),
            "tri": (pald_focus_tri, pald_cohesion_tri)}[schedule]
    info = pald.plan(_tri_D(20), method="kernel", schedule=schedule,
                     device="cpu").explain()
    assert info["est_smem_bytes_per_cta"] == max(m.SMEM_PER_CTA
                                                 for m in mods)


@pytest.mark.parametrize("knobs", [{"method": "dense"},
                                   {"method": "pairwise"},
                                   {"method": "triplet"},
                                   {"method": "knn", "k": 3},
                                   {"kind": "features", "method": "fused"}])
def test_tri_schedule_off_kernel_raises(knobs):
    x = np.ones((12, 3)) if knobs.get("kind") == "features" else _tri_D(12)
    with pytest.raises(ValueError, match="only available for method='kernel'"):
        pald.plan(x, schedule="tri", device="cpu", **knobs)


def test_triplet_knob_surface():
    D = _tri_D(12)
    info = pald.plan(D, method="triplet", block=4, device="cpu").explain()
    assert info["executor"].endswith("triplet._exec_triplet")
    assert info["padded_n"] == 12 and info["est_smem_bytes_per_cta"] is None
    with pytest.raises(ValueError, match="block_z"):
        pald.plan(D, method="triplet", block_z=8, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        pald.plan(D, method="triplet", impl="torch", device="cpu")
    with pytest.raises(ValueError, match="unknown schedule"):
        engine.plan(D, method="kernel", schedule="diagonal", device="cpu")
