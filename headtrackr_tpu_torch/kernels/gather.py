"""Wrapper of the ``take_along`` CUDA kernel (``csrc/gather.cu``).

  take_along   replaces tools/kernel_experiments.py::ta_call (k8), the
               take_along_axis lane gather; mean shift selected its
               prefix-sum lines with it until the ``meanshift`` kernel
               (kernels/meanshift.py) took the whole step, and
               ``kernels.pdf_pallas`` looked up its tables with it until
               the ``pdf_bins`` kernel (kernels/pdfbins.py), so no path of
               the port launches it

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/gather.py), a CUDA tensor launches the kernel, any other device raises.
"""

import torch

from ..ops.gather import take_along_plain
from .launch import launch, on_cuda

__all__ = ["take_along"]


def take_along(src, idx, dim):
    """torch.take_along_dim(src, idx, dim) for a (B, S, L) f32 ``src`` and
    i32 ``idx``: dim 1 gathers rows, idx (B, K, L) or (B, K, 1) -> (B, K, L);
    dim 2 gathers columns, idx (B, S, K) or (B, 1, K) -> (B, S, K).  A
    size-1 axis of idx broadcasts.  Indices must lie in [0, S) (dim 1) or
    [0, L) (dim 2): they are not checked, so callers clamp them."""
    if src.dtype != torch.float32 or src.dim() != 3:
        raise ValueError(f"src must be (B, S, L) float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if dim not in (1, 2):
        raise ValueError(f"dim must be 1 or 2, got {dim}")
    other = 3 - dim  # the non-batch axis that is not gathered
    if (idx.dtype != torch.int32 or idx.dim() != 3
            or idx.shape[0] != src.shape[0]
            or idx.shape[other] not in (1, src.shape[other])):
        raise ValueError(f"idx must be int32 (B, ...) matching src "
                         f"{tuple(src.shape)} off axis {dim}, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if not on_cuda(src, idx):
        return take_along_plain(src, idx, dim)
    B, S, L = src.shape
    K = idx.shape[dim]
    out = torch.empty((B, S, K) if dim == 2 else (B, K, L),
                      dtype=torch.float32, device=src.device)
    if out.numel():
        with torch.cuda.device(src.device):
            launch("take_along", "take_along_launch", src.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), B, S, L, dim, K,
                   int(idx.shape[other] == src.shape[other]))
    return out
