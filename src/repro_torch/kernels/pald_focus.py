"""PaLD pass 1, local-focus sizes: the CUDA kernel's wrapper and its plain
torch version.

    U[x, y] = sum_z focus_weight(DXZ[x, z], DYZ[y, z], DXY[x, y])

The kernel (``csrc/pald_focus.cu``, kernel in ``csrc/pald_focus.cuh``)
replaces the TPU kernel ``repro/kernels/pald_focus.py::focus_general_pallas``.
It is bound by the compare pipe (a min and a compare per triple at half the
FP32 rate), so it is register-blocked like an SGEMM: a 64 x 64 U tile per
thread block, 4 x 4 outputs per thread with their thresholds in registers,
z streamed through shared memory in double-buffered 16-byte copies.  When
the three operands are one square D (what ``ops.focus`` passes) the grid
holds only the upper tile pairs: a tile whose thresholds are symmetric is
stored with its transpose, any other one computes its mirror in a second z
loop.  The kernel counts the thread blocks that ran and those second loops
in a device counter (:func:`tile_counts`).  The source notes have the
details.

:func:`focus_general_cuda` dispatches on the tensors' device: CUDA tensors
launch the kernel (or raise), CPU tensors take :func:`focus_general_torch`,
the counterpart of the reference's ``ops._focus_general_jnp``.

The kernel's square entry also takes a (b, n, n) chunk of square D (the
engine's ``batch=`` chunks on the card) and runs it in one grid, the item
on ``blockIdx.z`` (:func:`launch_square`), bitwise its items one at a
time.  The plain version takes one item; the engine splits a chunk for it.
"""
from __future__ import annotations

import torch

from repro_torch.core.weights import DEFAULT_TIES, focus_weight, kernel_spec

from . import _build

__all__ = ["focus_general_cuda", "focus_general_torch", "adaptive_chunk",
           "check_operands", "focus_blocks", "tile_counts",
           "reset_tile_counts", "launch_square", "item_grids",
           "TILE", "SMEM_PER_CTA", "MAX_ITEMS"]

TILE = 64  # the kernel's U tile edge
# the kernel's two (32, 68) float32 z slabs and two (64, 36) landing
# buffers (csrc/pald_focus.cuh: FocusSmem)
SMEM_PER_CTA = 4 * (2 * 32 * 68 + 2 * 64 * 36)

# items of a chunk in one grid (gridDim.z); a larger chunk takes one grid
# per MAX_ITEMS (csrc/pald_focus.cuh, pald_cohesion.cuh: kMaxItems)
MAX_ITEMS = 65535

# The plain versions materialize an (mx, my, chunk) comparison cube per
# step; cap the cube at 512 MiB of bools (2 GiB once cast to float32) so the
# chunk adapts down as the operands grow, as the reference's fallback does.
_CUBE_BUDGET = 512 << 20


def adaptive_chunk(m1: int, m2: int, want: int) -> int:
    """Chunk of the reduced axis for an (m1, m2, chunk) cube: ``want``,
    capped by the cube budget, at least 1."""
    return max(min(int(want), max(_CUBE_BUDGET // max(m1 * m2, 1), 8)), 1)


def item_grids(items: int) -> int:
    """Grids that one launch of a chunk of ``items`` issues."""
    return max(1, -(-items // MAX_ITEMS))


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


def focus_blocks(mx: int, my: int, square: bool) -> int:
    """Thread blocks that one focus grid should run: every 64 x 64 tile of
    an (mx, my) U, or on a square D the nb (nb + 1) / 2 upper tile pairs
    (what :func:`tile_counts` is held to)."""
    bx, by = -(-mx // TILE), -(-my // TILE)
    return bx * (bx + 1) // 2 if square else bx * by


# two int64 counters a device, added to by the kernel of every focus grid
# (this module's and pald_focus_tri's): [0] thread blocks that ran, [1]
# off-diagonal tile pairs of a square D whose thresholds were not symmetric
_COUNTS: dict = {}


def _counts(dev) -> torch.Tensor:
    if dev not in _COUNTS:
        _COUNTS[dev] = torch.zeros((2,), dtype=torch.int64, device=dev)
    return _COUNTS[dev]


def tile_counts(device) -> tuple[int, int]:
    """(thread blocks run, tile pairs run twice) by the focus kernels on
    ``device``, summed over the calls since the last
    :func:`reset_tile_counts`; the kernel counts both (a tile pair runs
    twice when its thresholds are not symmetric: its mirror takes a second
    z loop).  Synchronizes."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    c = _COUNTS.get(dev)
    return (0, 0) if c is None else tuple(int(v) for v in c.tolist())


def reset_tile_counts() -> None:
    for c in _COUNTS.values():
        c.zero_()


def launch_square(D, U, spec) -> None:
    """U (n, n) from one square CUDA D, or U (b, n, n) from a chunk of b,
    through the kernel's square entry (the upper tile pairs of each item,
    all items in one grid; the dense and the tri wrappers), weight family
    ``spec = kernel_spec(ties)`` (a user functional's: its own library).
    Raises on a CUDA error."""
    dev = D.device
    items = D.shape[0] if D.ndim == 3 else 1
    wid, p0, p1 = spec
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.load("pald_focus_square_f32", spec.functor)(
            D.data_ptr(), U.data_ptr(), D.shape[-1], items,
            _counts(dev).data_ptr(), wid, p0, p1, stream)
    _build.check(status, "pald_focus_square_f32")


def focus_general_cuda(DXZ, DYZ, DXY, *, ties=DEFAULT_TIES) -> torch.Tensor:
    """U (mx, my) through the CUDA kernel for CUDA tensors, through
    :func:`focus_general_torch` for CPU tensors.

    CUDA operands must be contiguous float32 on one device (``ops``
    prepares them); anything else raises, as does a weight functional
    that does not compile.  Three operands that are one square (n, n)
    tensor take the kernel's square entry (upper tile pairs), and so do
    three that are one (b, n, n) chunk: one grid for its b items, U
    (b, n, n).  Each launch adds one to ``focus_general_cuda.launches``
    (and to ``.grid_launches``: one grid, :func:`item_grids` for a chunk);
    the kernel counts its thread blocks (:func:`tile_counts`).
    """
    dev = DXZ.device
    if dev.type == "cpu":
        return focus_general_torch(DXZ, DYZ, DXY, ties=ties)
    if dev.type != "cuda":
        raise ValueError(f"focus_general_cuda: unsupported device {dev}")
    spec = kernel_spec(ties)
    if DXZ.ndim == 3:
        return _focus_chunk_cuda(DXZ, DYZ, DXY, spec)
    mx, mz = DXZ.shape
    my = DYZ.shape[0]
    f32 = torch.float32
    check_operands("focus_general_cuda", dev, DXZ=(DXZ, (mx, mz), f32),
                   DYZ=(DYZ, (my, mz), f32), DXY=(DXY, (mx, my), f32))
    U = torch.empty((mx, my), dtype=f32, device=dev)
    if mx == 0 or my == 0:
        return U
    # contiguous, one shape, one address: one matrix
    square = (mx == my == mz
              and DXZ.data_ptr() == DYZ.data_ptr() == DXY.data_ptr())
    if square:
        launch_square(DXZ, U, spec)
    else:
        wid, p0, p1 = spec
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = _build.load("pald_focus_f32", spec.functor)(
                DXZ.data_ptr(), DYZ.data_ptr(), DXY.data_ptr(), U.data_ptr(),
                mx, my, mz, _counts(dev).data_ptr(), wid, p0, p1, stream)
        _build.check(status, "pald_focus_f32")
    focus_general_cuda.launches += 1
    focus_general_cuda.grid_launches += 1
    return U


def _focus_chunk_cuda(DXZ, DYZ, DXY, spec) -> torch.Tensor:
    """A (b, n, n) chunk: one square grid; the three operands must be
    one tensor (the rectangular entry takes one item)."""
    if not (DXZ.data_ptr() == DYZ.data_ptr() == DXY.data_ptr()
            and DXZ.shape == DYZ.shape == DXY.shape
            and DXZ.shape[-1] == DXZ.shape[-2]):
        raise ValueError("focus_general_cuda: a (b, n, n) chunk takes one "
                         "square D as all three operands, got shapes "
                         f"{tuple(DXZ.shape)}, {tuple(DYZ.shape)}, "
                         f"{tuple(DXY.shape)}")
    dev = DXZ.device
    b, n = DXZ.shape[0], DXZ.shape[-1]
    check_operands("focus_general_cuda", dev,
                   D=(DXZ, (b, n, n), torch.float32))
    U = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return U
    launch_square(DXZ, U, spec)
    focus_general_cuda.launches += 1
    focus_general_cuda.grid_launches += item_grids(b)
    return U


focus_general_cuda.launches = 0
focus_general_cuda.grid_launches = 0
