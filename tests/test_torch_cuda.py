"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA GPU: it is marked ``cuda`` and skips without
one (this file imports neither JAX nor ``repro``, so it runs where only
PyTorch is installed):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

U is bitwise for every functional whose focus is an exact count (all but
``soft``); C, and the smooth ``soft`` U, to rtol 1e-5, atol 1e-6 (the
conformance tolerance): kernel and plain version sum in another order.
``chip_smoke.py`` repeats the comparison at the main path's full size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import weights as tw
from repro_torch.kernels import ops, pald_cohesion, pald_focus

RTOL, ATOL = 1e-5, 1e-6
FUNCTIONALS = ["drop", "split", "ignore", "soft", "kernelized"]


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
    user = tw.WeightFunctional("_user_cuda", tw.DROP.focus, tw.DROP.support)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
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
