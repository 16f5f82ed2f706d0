"""The port's two kernel modules (focus, cohesion) against the JAX
reference's Pallas kernels.

On this CPU the port runs each kernel's plain torch version (the wrapper
takes it for CPU tensors).  It is held to the reference's
``focus_general_pallas`` / ``cohesion_general_pallas`` run in interpret mode
(bit-faithful to the TPU kernel body; slow, so n <= 64), and to the
reference's ``ops.focus_general`` / ``ops.cohesion_general`` with
``impl="jnp"`` up to n = 130.  Square, ragged and rectangular shapes, every
built-in functional, both index-tiebreak routes.  U is bitwise for every
functional whose focus is an exact count (all but ``soft``); C, and the
smooth ``soft`` U, to rtol 1e-5, atol 1e-6 (the conformance tolerance of
tests/test_conformance.py): the two sum their terms in another order.

The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pald_cohesion import cohesion_general_pallas
from repro.kernels.pald_focus import focus_general_pallas
from repro_torch.core import weights as tw
from repro_torch.kernels import ops, pald_cohesion, pald_focus
from repro_torch.kernels import ref as tref

RTOL, ATOL = 1e-5, 1e-6
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized"]


# (functional, tiebreak route): "ignore" through both routes, the rest none
COHESION_CASES = [(name, route) for name in FUNCTIONALS
                  for route in (("offsets", "xwins") if name == "ignore"
                                else ("none",))]


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


def _exact_u(name) -> bool:
    return not name.startswith("soft")


def _operands(mx, my, mz, seed=0, inf_frac=0.03):
    """Asymmetric, tie-heavy DXZ, DYZ, DXY (multiples of 0.5, a few +inf),
    a positive W and a random explicit tiebreak, as numpy float32."""
    rng = np.random.default_rng(seed)

    def d(shape):
        a = rng.integers(0, 8, size=shape).astype(np.float32) * 0.5
        a[rng.random(shape) < inf_frac] = np.inf
        return a

    return (d((mx, mz)), d((my, mz)), d((mx, my)),
            rng.random((mx, my)).astype(np.float32),
            rng.random((mx, my)) < 0.5)


def _square(n, seed=0):
    """A tie-heavy Euclidean distance matrix of integer points."""
    X = np.random.default_rng(seed).integers(0, 5, size=(n, 3))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D.astype(np.float32)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_u(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if _exact_u(name):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# (mx, my, mz) and Pallas tiles that divide them exactly
PALLAS_SHAPES = {"square48": ((48, 48, 48), (16, 16, 16)),
                 "rect": ((32, 48, 64), (16, 16, 32))}
# shapes the reference's ops pads to its tiles (interpret) or chunks (jnp)
RAGGED_SHAPES = {"ragged37": (37, 37, 37), "rect_ragged": (21, 45, 59)}
JNP_SHAPES = {"square130": (130, 130, 130), "rect_ragged": (70, 130, 101)}


@pytest.mark.parametrize("shape", sorted(PALLAS_SHAPES))
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_focus_vs_pallas_interpret(name, shape):
    (mx, my, mz), (bx, by, bz) = PALLAS_SHAPES[shape]
    DXZ, DYZ, DXY, _, _ = _operands(mx, my, mz)
    want = focus_general_pallas(*_j(DXZ, DYZ, DXY), block_x=bx, block_y=by,
                                block_z=bz, interpret=True, ties=name)
    got = ops.focus_general(*_t(DXZ, DYZ, DXY), ties=name)
    _assert_u(name, got.numpy(), want)


@pytest.mark.parametrize("shape", sorted(PALLAS_SHAPES))
@pytest.mark.parametrize("name,route", COHESION_CASES)
def test_cohesion_vs_pallas_interpret(name, route, shape):
    (mx, my, mz), (bx, by, bz) = PALLAS_SHAPES[shape]
    DXZ, DYZ, DXY, W, XW = _operands(mx, my, mz, seed=1)
    offs = (7, 3)
    jkw = dict(block_x=bx, block_y=by, block_z=bz, interpret=True, ties=name)
    tkw = dict(ties=name)
    if route == "offsets":
        jkw["xw_offsets"], tkw["xw_offsets"] = offs, offs
    want = cohesion_general_pallas(
        *_j(DXZ, DYZ, DXY, W),
        jnp.asarray(XW, jnp.float32) if route == "xwins" else None, **jkw)
    if route == "xwins":
        tkw["xwins"] = torch.from_numpy(XW)
    got = ops.cohesion_general(*_t(DXZ, DYZ, DXY, W), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", sorted(RAGGED_SHAPES))
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_ragged_vs_reference_interpret(name, shape):
    """Ragged shapes: the reference pads to its 16-wide tiles with +inf
    (zero weights); the port's plain versions take them as they are."""
    mx, my, mz = RAGGED_SHAPES[shape]
    DXZ, DYZ, DXY, W, XW = _operands(mx, my, mz, seed=2, inf_frac=0.0)
    kw = dict(block=16, block_z=16, ties=name)
    U = ops.focus_general(*_t(DXZ, DYZ, DXY), **kw)
    _assert_u(name, U.numpy(), jops.focus_general(
        *_j(DXZ, DYZ, DXY), impl="interpret", **kw))
    tb = {"xw_offsets": (2, 9)} if tw.resolve_weight(name).needs_index_tiebreak else {}
    C = ops.cohesion_general(*_t(DXZ, DYZ, DXY, W), **kw, **tb)
    want = jops.cohesion_general(*_j(DXZ, DYZ, DXY, W), impl="interpret",
                                 **kw, **tb)
    np.testing.assert_allclose(C.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", sorted(RAGGED_SHAPES))
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_ragged_inf_pairs_vs_reference_interpret(name, shape):
    """Ragged shapes with +inf pairs: the reference pads to its tile
    extents with +inf and the port counts those padded z, so under
    ``split`` a padded z adds 0.5 to an +inf pair's U in both, and U and C
    agree as on finite inputs."""
    mx, my, mz = RAGGED_SHAPES[shape]
    DXZ, DYZ, DXY, W, XW = _operands(mx, my, mz, seed=7, inf_frac=0.1)
    kw = dict(block=16, block_z=16, ties=name)
    U = ops.focus_general(*_t(DXZ, DYZ, DXY), **kw)
    _assert_u(name, U.numpy(), jops.focus_general(
        *_j(DXZ, DYZ, DXY), impl="interpret", **kw))
    tb = {}
    if tw.resolve_weight(name).needs_index_tiebreak:
        tb = {"xwins": XW}
    C = ops.cohesion_general(*_t(DXZ, DYZ, DXY, W), **kw,
                             **{k: torch.from_numpy(v) for k, v in tb.items()})
    want = jops.cohesion_general(*_j(DXZ, DYZ, DXY, W), impl="interpret",
                                 **kw, **{k: jnp.asarray(v)
                                          for k, v in tb.items()})
    np.testing.assert_allclose(C.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_ragged_split_jnp_route_pads_otherwise(impl):
    """The one case where the reference's two routes differ: its jnp
    ``focus_general`` takes a ragged z as it is, its Pallas route pads z
    to the tile with +inf.  The port counts the Pallas route's padded z
    (on both impls), so under ``split`` it exceeds the jnp route by
    exactly 0.5 per padded z on the +inf pairs, and equals it elsewhere."""
    mx, my, mz = RAGGED_SHAPES["ragged37"]
    DXZ, DYZ, DXY, _, _ = _operands(mx, my, mz, seed=8, inf_frac=0.1)
    kw = dict(block=16, block_z=16, ties="split")
    U = ops.focus_general(*_t(DXZ, DYZ, DXY), impl=impl, **kw).numpy()
    Uj = np.asarray(jops.focus_general(*_j(DXZ, DYZ, DXY), impl="jnp", **kw))
    pad_z = 48 - mz   # 37 has no divisor >= 8 below 16: padded to 48
    np.testing.assert_array_equal(U - Uj, 0.5 * pad_z * np.isinf(DXY))
    assert np.isinf(DXY).any()


@pytest.mark.parametrize("shape", sorted(JNP_SHAPES))
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_focus_vs_reference_jnp(name, shape):
    mx, my, mz = JNP_SHAPES[shape]
    if mx == my == mz:
        DXZ = DYZ = DXY = _square(mx)
    else:
        DXZ, DYZ, DXY, _, _ = _operands(mx, my, mz, seed=3)
    got = ops.focus_general(*_t(DXZ, DYZ, DXY), ties=name)
    want = jops.focus_general(*_j(DXZ, DYZ, DXY), impl="jnp", ties=name)
    _assert_u(name, got.numpy(), want)


@pytest.mark.parametrize("shape", sorted(JNP_SHAPES))
@pytest.mark.parametrize("name,route", COHESION_CASES)
def test_cohesion_vs_reference_jnp(name, route, shape):
    mx, my, mz = JNP_SHAPES[shape]
    DXZ, DYZ, DXY, W, XW = _operands(mx, my, mz, seed=4)
    if mx == my == mz:
        DXZ = DYZ = DXY = _square(mx)
        W = np.asarray(jref.weights_ref(jnp.asarray(
            np.asarray(jops.focus_general(*_j(DXZ, DXZ, DXZ), impl="jnp",
                                          ties=name)))))
    kw = {"offsets": {"xw_offsets": (0, 0)}, "xwins": {"xwins": XW},
          "none": {}}[route]
    got = ops.cohesion_general(*_t(DXZ, DYZ, DXY, W), ties=name,
                               **{k: (torch.from_numpy(v) if k == "xwins"
                                      else v) for k, v in kw.items()})
    want = jops.cohesion_general(*_j(DXZ, DYZ, DXY, W), impl="jnp",
                                 ties=name, **{k: (jnp.asarray(v)
                                                   if k == "xwins" else v)
                                               for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_square_entry_points_vs_reference(name):
    """ops.focus / cohesion_from_weights / pald (dense schedule)."""
    D = _square(40, seed=5)
    U = ops.focus(torch.from_numpy(D), ties=name)
    Uj = jops.focus(jnp.asarray(D), impl="jnp", ties=name)
    _assert_u(name, U.numpy(), Uj)
    W = tref.weights_ref(U)
    Wj = jref.weights_ref(Uj)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=RTOL, atol=0)
    C = ops.cohesion_from_weights(torch.from_numpy(D), W, ties=name)
    Cj = jops.cohesion_from_weights(jnp.asarray(D), Wj, impl="jnp", ties=name)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)
    for normalize in (False, True):
        P = ops.pald(torch.from_numpy(D), ties=name, normalize=normalize)
        Pj = jops.pald(jnp.asarray(D), impl="jnp", ties=name,
                       normalize=normalize)
        np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_oracles_vs_reference(name):
    """kernels/ref.py: focus_ref, weights_ref, cohesion_ref."""
    D = _square(24, seed=6)
    U = tref.focus_ref(torch.from_numpy(D), ties=name)
    Uj = jref.focus_ref(jnp.asarray(D), ties=name)
    _assert_u(name, U.numpy(), Uj)
    np.testing.assert_array_equal(
        tref.weights_ref(U, 20).numpy(),
        np.asarray(jref.weights_ref(jnp.asarray(U.numpy()), 20)))
    W = tref.weights_ref(U)
    C = tref.cohesion_ref(torch.from_numpy(D), W, ties=name)
    Cj = jref.cohesion_ref(jnp.asarray(D), jnp.asarray(W.numpy()), ties=name)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the wrappers' device dispatch and the entry points' contracts
# ---------------------------------------------------------------------------
def test_wrappers_take_plain_version_on_cpu():
    DXZ, DYZ, DXY, W, _ = _operands(20, 30, 25, seed=7)
    t = _t(DXZ, DYZ, DXY, W)
    f0 = pald_focus.focus_general_cuda.launches
    c0 = pald_cohesion.cohesion_general_cuda.launches
    U = pald_focus.focus_general_cuda(*t[:3], ties="split")
    assert torch.equal(U, pald_focus.focus_general_torch(*t[:3],
                                                         ties="split"))
    C = pald_cohesion.cohesion_general_cuda(*t, ties="ignore",
                                            xw_offsets=(4, 1))
    assert torch.equal(C, pald_cohesion.cohesion_general_torch(
        *t, ties="ignore", xw_offsets=(4, 1)))
    assert pald_focus.focus_general_cuda.launches == f0
    assert pald_cohesion.cohesion_general_cuda.launches == c0


@pytest.mark.parametrize("mx,my,square,blocks", [
    (1, 1, True, 1), (64, 64, True, 1), (65, 65, True, 3),
    (257, 257, True, 15), (8192, 8192, True, 8256),
    (8192, 8192, False, 16384), (130, 70, False, 6), (1, 200, False, 4)])
def test_focus_blocks(mx, my, square, blocks):
    """Thread blocks of one focus grid: nb (nb + 1) / 2 upper tile pairs
    on a square D, every 64 x 64 tile otherwise."""
    assert pald_focus.focus_blocks(mx, my, square) == blocks


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_ops_focus_hands_one_matrix_to_the_square_entry(name, monkeypatch):
    """``ops.focus`` casts D once and passes that one tensor as all three
    operands (what sends the CUDA wrapper to its square entry), also from
    a float64 D; U is the JAX package's."""
    seen = []

    def record(DXZ, DYZ, DXY, **kw):
        seen.append((DXZ.data_ptr(), DYZ.data_ptr(), DXY.data_ptr(),
                     DXZ.dtype))
        return pald_focus.focus_general_torch(DXZ, DYZ, DXY, **kw)

    monkeypatch.setattr(ops, "focus_general_cuda", record)
    D = _square(70, seed=17)
    U = ops.focus(torch.from_numpy(D.astype(np.float64)), impl="cuda",
                  ties=name)
    (a, b, c, dtype), = seen
    assert a == b == c and dtype == torch.float32
    _assert_u(name, U, jops.focus(jnp.asarray(D), impl="jnp", ties=name))


def test_focus_wrappers_count_no_blocks_on_cpu():
    """On CPU tensors the wrappers take the plain versions: no launch, and
    no device counter of blocks or tiles made or added to."""
    from repro_torch.kernels import pald_focus_tri

    D = torch.from_numpy(_square(70, seed=19))
    before = (pald_focus.focus_general_cuda.launches,
              pald_focus_tri.focus_tri_cuda.launches)
    pald_focus.reset_tile_counts()
    pald_focus.focus_general_cuda(D, D, D)
    pald_focus_tri.focus_tri_cuda(D)
    assert (pald_focus.focus_general_cuda.launches,
            pald_focus_tri.focus_tri_cuda.launches) == before
    assert pald_focus.tile_counts("cpu") == (0, 0)
    assert torch.device("cpu") not in pald_focus._COUNTS
    assert pald_focus.SMEM_PER_CTA == pald_focus_tri.SMEM_PER_CTA == 35840


def test_wrappers_reject_other_devices():
    m = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pald_focus.focus_general_cuda(m, m, m)
    with pytest.raises(ValueError, match="unsupported device"):
        pald_cohesion.cohesion_general_cuda(m, m, m, m)


def test_impl_cuda_on_cpu_goes_through_wrapper():
    D = torch.from_numpy(_square(30, seed=8))
    for name in FUNCTIONALS:
        assert torch.equal(ops.pald(D, impl="cuda", ties=name),
                           ops.pald(D, impl="torch", ties=name))


def test_check_operands_rejects_bad_operands():
    a = torch.zeros((3, 4))
    with pytest.raises(TypeError, match="float32"):
        pald_focus.check_operands("k", a.device,
                                  A=(a.double(), (3, 4), torch.float32))
    with pytest.raises(ValueError, match="shape"):
        pald_focus.check_operands("k", a.device, A=(a, (4, 3), torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        pald_focus.check_operands("k", a.device,
                                  A=(a.T, (4, 3), torch.float32))
    with pytest.raises(ValueError, match="device"):
        pald_focus.check_operands("k", torch.device("meta"),
                                  A=(a, (3, 4), torch.float32))


def test_tiebreak_required():
    DXZ, DYZ, DXY, W, _ = _operands(8, 8, 8)
    with pytest.raises(ValueError, match="xwins or xw_offsets"):
        ops.cohesion_general(*_t(DXZ, DYZ, DXY, W), ties="ignore")


def test_unknown_impl_rejected():
    D = torch.from_numpy(_square(8))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.focus(D, impl="pallas")


@pytest.mark.parametrize("fn", ["pald_tri"])
def test_unported_pipelines_raise(fn):
    """The tri pipeline (tests/test_torch_tri.py holds it to the
    reference) takes a square D only: anything else raises."""
    with pytest.raises(ValueError, match="square"):
        getattr(ops, fn)(torch.zeros((4, 5)))


@pytest.mark.parametrize("fn", ["focus", "cohesion_from_weights", "pald"])
def test_tri_schedule_raises(fn):
    """schedule='tri' takes a square D only, and an unknown schedule is an
    error; on a square D it runs (tests/test_torch_tri.py)."""
    R = torch.zeros((8, 6))
    args = (R, R) if fn == "cohesion_from_weights" else (R,)
    with pytest.raises(ValueError, match="square"):
        getattr(ops, fn)(*args, schedule="tri")
    D = torch.from_numpy(_square(8))
    args = (D, D) if fn == "cohesion_from_weights" else (D,)
    with pytest.raises(ValueError, match="unknown schedule"):
        getattr(ops, fn)(*args, schedule="upper")
    assert getattr(ops, fn)(*args, schedule="tri").shape == (8, 8)


@pytest.mark.parametrize("n_valid", [None, 17, 23])
def test_weights_ref_matches_reference(n_valid):
    """W = 1/U with zero diagonal, zero where U == 0 and zero padding rows
    and columns: bitwise the reference's, on counts and on fractional U
    (soft) with zeros among them."""
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 9, size=(23, 23)).astype(np.float32)
    frac = (counts * rng.random((23, 23))).astype(np.float32)
    for U in (counts, frac):
        got = tref.weights_ref(torch.tensor(U), n_valid).numpy()
        want = np.asarray(jref.weights_ref(jnp.asarray(U), n_valid))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("entry", ["finite", "inf", "nan"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_add_form_needs_a_predicated_family_and_a_finite_w(name, entry):
    """The cohesion kernels add W under a predicate only for drop, ignore
    and kernelized, and only when every W is finite: a non-finite entry
    takes the multiply form, which keeps the reference's 0 * inf = nan."""
    wid = tw.kernel_spec(name)[0]
    W = torch.rand(5, 7)
    if entry != "finite":
        W[2, 3] = float(entry)
    want = name in ("drop", "ignore", "kernelized") and entry == "finite"
    assert pald_cohesion.add_form(wid, W) == int(want)
