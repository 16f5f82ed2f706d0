"""Sparse k-NN PaLD cohesion values: the CUDA kernel's wrapper and its
plain torch version.

From a neighbor graph's (n, k) distances ``dn`` and indices ``idx`` and the
(n, k, k) gathered neighbor-to-neighbor distances ``g``, the (n, k+1)
values [self, nbr_0, ..., nbr_{k-1}] of ``core.knn.knn_values_tile``:
focus sizes over {x} + N_k(x) per directed pair, W = 1/U, then the support
of each candidate.  The kernel (``csrc/pald_knn.cu``) replaces the TPU
kernel ``repro/kernels/pald_knn.py::knn_values_pallas`` on the real k (no
lane padding); U and W never leave the block.  Bound by reading g; the
source note in the ``.cu`` file has the details.  g is built outside the
kernel by the plain torch ``core.knn.gather_tile_from_*``, as the
reference stages it in HBM.

:func:`knn_values_cuda` dispatches on the tensors' device: CUDA tensors
launch the kernel (or raise), CPU tensors take :func:`knn_values_torch`,
``knn_values_tile`` over row chunks.
"""
from __future__ import annotations

import torch

from repro_torch.core.knn import knn_values_tile
from repro_torch.core.weights import DEFAULT_TIES, kernel_spec, resolve_weight

from . import _build
from .pald_focus import check_operands
from .pald_topk import MAX_K

__all__ = ["knn_values_cuda", "knn_values_torch", "smem_per_cta"]

_WARPS = 4  # rows per thread block (csrc/pald_knn.cu: one warp per row)


def smem_per_cta(k: int) -> int:
    """Shared memory of one thread block of the kernel at ``k``, in bytes:
    each of its four rows' dn, W and idx."""
    return _WARPS * 3 * 4 * k


def knn_values_torch(dn: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                     *, ties=DEFAULT_TIES, block: int = 128,
                     row_off: int = 0) -> torch.Tensor:
    """Plain torch (n, k+1) values (any device), ``block`` rows per chunk;
    ``row_off`` is the global index of the first row (the ``ignore``
    tiebreak compares it with the neighbor indices)."""
    wfun = resolve_weight(ties)
    n, k = dn.shape
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dn.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        ow = None
        if wfun.needs_index_tiebreak:  # "index of x > index of nbr_j"
            rows = row_off + torch.arange(s, e, device=idx.device)
            ow = rows[:, None] > idx[s:e]
        out[s:e] = knn_values_tile(dn[s:e].to(torch.float32),
                                   g[s:e].to(torch.float32), ow, wfun)
    return out


def knn_values_cuda(dn: torch.Tensor, g: torch.Tensor, idx: torch.Tensor,
                    *, ties=DEFAULT_TIES) -> torch.Tensor:
    """(n, k+1) values through the CUDA kernel for CUDA tensors, through
    :func:`knn_values_torch` for CPU tensors.

    CUDA operands must be contiguous (dn, g float32; idx int32) on one
    device, with 1 <= k <= :data:`MAX_K`; anything else raises, as does a
    weight functional without a kernel id.  Each launch adds one to
    ``knn_values_cuda.launches`` (and to ``.grid_launches``: one grid).
    """
    if dn.device.type == "cpu":
        return knn_values_torch(dn, g, idx, ties=ties)
    wid, p0, p1 = kernel_spec(ties)
    dev = dn.device
    if dev.type != "cuda":
        raise ValueError(f"knn_values_cuda: unsupported device {dev}")
    n, k = dn.shape
    check_operands("knn_values_cuda", dev,
                   dn=(dn, (n, k), torch.float32),
                   g=(g, (n, k, k), torch.float32),
                   idx=(idx, (n, k), torch.int32))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_values_cuda: k={k} outside the kernel's "
                         f"range 1..{MAX_K} (ROADMAP.md queue 3)")
    out = torch.empty((n, k + 1), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = _build.load("pald_knn_values_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(dn.data_ptr(), g.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, k, wid, p0, p1, stream)
    _build.check(status, "pald_knn_values_f32")
    knn_values_cuda.launches += 1
    knn_values_cuda.grid_launches += 1
    return out


knn_values_cuda.launches = 0
knn_values_cuda.grid_launches = 0
