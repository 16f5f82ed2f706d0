"""PaLD pass 1, local-focus sizes: the CUDA kernel's wrapper and its plain
torch version.

    U[x, y] = sum_z focus_weight(DXZ[x, z], DYZ[y, z], DXY[x, y])

The kernel (``csrc/pald_focus.cu``) replaces the TPU kernel
``repro/kernels/pald_focus.py::focus_general_pallas``.  It is bound by the
FP32 pipe (n^3 triples, ~3 lane instructions each, against 4 n^2 floats of
memory traffic), so it is register-blocked like an SGEMM: a 64 x 64 U tile
per thread block, 4 x 4 outputs per thread with their thresholds in
registers, z streamed through shared memory.  The source note in the
``.cu`` file has the details.

:func:`focus_general_cuda` dispatches on the tensors' device: CUDA tensors
launch the kernel (or raise), CPU tensors take :func:`focus_general_torch`,
the counterpart of the reference's ``ops._focus_general_jnp``.
"""
from __future__ import annotations

import torch

from repro_torch.core.weights import DEFAULT_TIES, focus_weight, kernel_spec

from . import _build

__all__ = ["focus_general_cuda", "focus_general_torch", "adaptive_chunk",
           "check_operands", "SMEM_PER_CTA"]

# the kernel stages two (32, 68) float32 z slabs (csrc/pald_focus.cu)
SMEM_PER_CTA = 4 * 2 * 32 * 68

# The plain versions materialize an (mx, my, chunk) comparison cube per
# step; cap the cube at 512 MiB of bools (2 GiB once cast to float32) so the
# chunk adapts down as the operands grow, as the reference's fallback does.
_CUBE_BUDGET = 512 << 20


def adaptive_chunk(m1: int, m2: int, want: int) -> int:
    """Chunk of the reduced axis for an (m1, m2, chunk) cube: ``want``,
    capped by the cube budget, at least 1."""
    return max(min(int(want), max(_CUBE_BUDGET // max(m1 * m2, 1), 8)), 1)


def focus_general_torch(DXZ, DYZ, DXY, *, chunk: int = 512,
                        ties=DEFAULT_TIES) -> torch.Tensor:
    """Plain torch U (mx, my), z in chunks (any device)."""
    mx, mz = DXZ.shape
    my = DYZ.shape[0]
    c = adaptive_chunk(mx, my, chunk)
    U = torch.zeros((mx, my), dtype=torch.float32, device=DXZ.device)
    thr = DXY[:, :, None]
    for s in range(0, mz, c):
        m = focus_weight(DXZ[:, None, s:s + c], DYZ[None, :, s:s + c], thr,
                         ties)
        U += torch.sum(m, dim=-1, dtype=torch.float32)
    return U


def check_operands(what: str, device, **named) -> None:
    """Raise unless each named ``(tensor, shape, dtype)`` is a contiguous
    tensor of that shape and dtype on ``device``."""
    for name, (t, shape, dtype) in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor")
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device} (all operands on one device)")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def focus_general_cuda(DXZ, DYZ, DXY, *, ties=DEFAULT_TIES) -> torch.Tensor:
    """U (mx, my) through the CUDA kernel for CUDA tensors, through
    :func:`focus_general_torch` for CPU tensors.

    CUDA operands must be contiguous float32 on one device (``ops``
    prepares them); anything else raises, as does a weight functional
    without a kernel id.  Each launch adds one to
    ``focus_general_cuda.launches`` (and to ``.grid_launches``: one grid).
    """
    dev = DXZ.device
    if dev.type == "cpu":
        return focus_general_torch(DXZ, DYZ, DXY, ties=ties)
    if dev.type != "cuda":
        raise ValueError(f"focus_general_cuda: unsupported device {dev}")
    wid, p0, p1 = kernel_spec(ties)
    mx, mz = DXZ.shape
    my = DYZ.shape[0]
    f32 = torch.float32
    check_operands("focus_general_cuda", dev, DXZ=(DXZ, (mx, mz), f32),
                   DYZ=(DYZ, (my, mz), f32), DXY=(DXY, (mx, my), f32))
    U = torch.empty((mx, my), dtype=f32, device=dev)
    if mx == 0 or my == 0:
        return U
    fn = _build.load("pald_focus_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(DXZ.data_ptr(), DYZ.data_ptr(), DXY.data_ptr(),
                    U.data_ptr(), mx, my, mz, wid, p0, p1, stream)
    _build.check(status, "pald_focus_f32")
    focus_general_cuda.launches += 1
    focus_general_cuda.grid_launches += 1
    return U


focus_general_cuda.launches = 0
focus_general_cuda.grid_launches = 0
