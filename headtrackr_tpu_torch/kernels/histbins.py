"""Wrapper of the ``hist_bins`` CUDA kernel (``csrc/histbins.cu``).

  hist_bins   replaces tools/kernel_experiments.py:257 mk_call(hist_k5), the
              4096-bin histogram of precomputed i32 bin ids (the JAX
              package's ops/histogram.py histogram_4096 / histogram_scan);
              the port's ``histogram_4096`` and ``camshift.Histogram``

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/histogram.py ``hist_bins_plain``), a CUDA tensor launches the kernel,
any other device raises.
"""

import torch

from ..ops.histogram import NBINS, hist_bins_plain
from .launch import launch, on_cuda, sm_count

__all__ = ["hist_bins", "split_bins"]

# resident blocks an SM holds (512 threads a block) and the fewest ids a
# block takes
_BLOCKS_PER_SM = 4
_MIN_BLOCK_IDS = 8192


def split_bins(n, p, sms):
    """Blocks per stream of a launch over n rows of p ids on a card of
    ``sms`` SMs: one wave of blocks split evenly over the streams, each of
    at least _MIN_BLOCK_IDS ids, at least one a stream.  Each block zeroes
    and flushes a 16 KB histogram, so fewer, longer blocks win once the card
    is full."""
    wave = _BLOCKS_PER_SM * sms
    return max(1, min(-(-p // _MIN_BLOCK_IDS), wave // max(n, 1)))


def hist_bins(bins):
    """(N, P) i32 bin ids -> (N, 4096) f32 exact counts, one histogram per
    row (stream); an id outside [0, 4096) counts nowhere."""
    if bins.dtype != torch.int32 or bins.dim() != 2:
        raise ValueError(f"bins must be (N, P) int32, got "
                         f"{tuple(bins.shape)} {bins.dtype}")
    if not on_cuda(bins):
        return hist_bins_plain(bins)
    N, P = bins.shape
    if P >= 2 ** 31:
        raise ValueError(f"rows of {P} ids: the kernel takes fewer than 2^31")
    out = torch.empty((N, NBINS), dtype=torch.float32, device=bins.device)
    if N == 0:
        return out
    counts = torch.empty((N, NBINS), dtype=torch.int32, device=bins.device)
    blocks = split_bins(N, P, sm_count(bins.device))
    with torch.cuda.device(bins.device):
        launch("hist_bins", "hist_bins_launch", bins.data_ptr(),
               counts.data_ptr(), out.data_ptr(), N, P, blocks)
    return out
