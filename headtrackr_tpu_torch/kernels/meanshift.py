"""Wrapper of the ``meanshift`` CUDA kernel (``csrc/meanshift.cu``).

  mean_shift   replaces headtrackr_tpu/models/camshift.py _mean_shift_core
               (with _marginal_planes, _select_lines,
               _first_moments_marginal and _second_moments) and, on the
               serving path, tools/kernel_experiments.py::ta_call (k8),
               whose port ``take_along`` selected the prefix-sum lines

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/meanshift.py), a CUDA tensor launches the kernel, one launch a call for
every stream; any other device raises, and so does a failed build or
launch.  The twin and the kernel sum in the same order, so their results
are equal to the bit on every device.
"""

import functools

import torch

from ..ops.meanshift import MOMENTS, mean_shift_plain
from .launch import launch, on_cuda

__all__ = ["mean_shift", "MAX_SIDE"]

MAX_SIDE = 1024  # the kernel's limit on the pdf's rows and columns


@functools.lru_cache(maxsize=None)
def _scratch_floats(bh, bw):
    """Floats of global scratch a stream needs (0: the planes fit in shared
    memory)."""
    from .build import load_library
    return load_library().fn("meanshift_scratch_floats")(bh, bw)


def mean_shift(pdf, window, ry=None, rx=None, frame_shape=None):
    """<= 10 mean-shift iterations for every stream, then the second and
    central moments: ``ops.meanshift.mean_shift_plain``'s contract.

    pdf (N, bh, bw) f32 over frame rows [ry, ry+bh) x cols [rx, rx+bw) (ry,
    rx (N,) i32 band origins; the full frame when both are None), window
    (N, 4) i32, frame_shape (H, W) (default: the pdf's); bh, bw <=
    MAX_SIDE.  Returns (window' (N, 4) i32, moments {name: (N,) f32},
    zero_mass (N,) bool, escaped (N,) bool)."""
    if pdf.dtype != torch.float32 or pdf.dim() != 3:
        raise ValueError(f"pdf must be (N, bh, bw) float32, got "
                         f"{tuple(pdf.shape)} {pdf.dtype}")
    N, bh, bw = pdf.shape
    if not (1 <= bh <= MAX_SIDE and 1 <= bw <= MAX_SIDE):
        raise ValueError(f"pdf's rows and columns must lie in [1, "
                         f"{MAX_SIDE}], got {bh} x {bw}")
    if window.dtype != torch.int32 or tuple(window.shape) != (N, 4):
        raise ValueError(f"window must be ({N}, 4) int32, got "
                         f"{tuple(window.shape)} {window.dtype}")
    if (ry is None) != (rx is None):
        raise ValueError("pass both band origins ry and rx, or neither")
    origins = () if ry is None else (ry.contiguous(), rx.contiguous())
    for name, t in zip(("ry", "rx"), origins):
        if t.dtype != torch.int32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be ({N},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    pdf, window = pdf.contiguous(), window.contiguous()
    if not on_cuda(pdf, window, *origins):
        return mean_shift_plain(pdf, window, *(origins or (None, None)),
                                frame_shape)
    H, W = frame_shape if frame_shape is not None else (bh, bw)
    dev = pdf.device
    win = torch.empty((N, 4), dtype=torch.int32, device=dev)
    mom = torch.empty((N, len(MOMENTS)), dtype=torch.float32, device=dev)
    flags = torch.empty((N, 2), dtype=torch.bool, device=dev)
    if N:
        with torch.cuda.device(dev):
            per = _scratch_floats(bh, bw)
            scratch = (torch.empty((N * per,), dtype=torch.float32,
                                   device=dev) if per else None)
            launch("meanshift", "meanshift_launch", pdf.data_ptr(),
                   window.data_ptr(),
                   *([t.data_ptr() for t in origins] or (None, None)),
                   win.data_ptr(), mom.data_ptr(), flags.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), N, bh,
                   bw, int(H), int(W))
    return (win, dict(zip(MOMENTS, mom.unbind(1))), flags[:, 0],
            flags[:, 1])
