"""Wrapper of the ``pyramid`` CUDA kernel (``csrc/pyramid.cu``).

  pyramid   replaces headtrackr_tpu/ops/imageproc.py resize_bilinear and
            build_pyramid (with the packing of the planes into the
            detector's flat buffer, models/detector.py)

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/imageproc.py pack_pyramid), a CUDA tensor launches the kernel, one
launch a generation of the tables' PyramidPlan (6 at 240x320); any other
device raises, and so does a failed build or launch.  The two are equal to
the bit.
"""

import torch

from ..ops.imageproc import pack_pyramid
from .launch import launch, on_cuda

__all__ = ["pyramid"]


def pyramid(gray, tables):
    """gray (N, H, W) u8 -> (N, tables.L) u8: the pyramid planes and the
    pixel-interleaved quarter planes of ``tables`` (a
    models.detector.DetectorTables on gray's device), flat."""
    spec = tables.spec
    if (gray.dtype != torch.uint8 or gray.dim() != 3
            or tuple(gray.shape[1:]) != (spec.h0, spec.w0)):
        raise ValueError(f"gray must be (N, {spec.h0}, {spec.w0}) uint8, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    gray = gray.contiguous()
    plan = tables.plan
    if not on_cuda(gray, plan.jobs):
        return pack_pyramid(gray, spec.interval, tables.plane_keys,
                            tables.geom_levels)
    N = gray.shape[0]
    dev = gray.device
    out = torch.empty((N, tables.L), dtype=torch.uint8, device=dev)
    if N == 0 or tables.L == 0:
        return out
    scratch = torch.empty((N, plan.S), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        for first, end, pixels in plan.gens:
            launch("pyramid", "pyramid_launch", gray.data_ptr(),
                   scratch.data_ptr(), out.data_ptr(),
                   plan.jobs[first].data_ptr(), plan.xi.data_ptr(),
                   plan.xf.data_ptr(), plan.yi.data_ptr(), plan.yf.data_ptr(),
                   end - first, pixels, N, spec.h0 * spec.w0, plan.S,
                   tables.L)
    return out
