"""Wrapper of the ``pdf_bins`` CUDA kernel (``csrc/pdfbins.cu``).

  pdf_bins    replaces headtrackr_tpu/kernels/histpdf.py:123 pdf_pallas on
              precomputed i32 bin ids (the reference's own K2 entry point):
              the 4096-bin weight lookup with its range check, one pass;
              the port's ``kernels.pdf_pallas`` and ``handoff_band_audit``
              on bins

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/histogram.py ``pdf_bins_plain``), a CUDA tensor launches the kernel,
any other device raises.  C CTAs a row (``pdf_split``), each staging the
row's 16 KB table in shared memory and looking up a share of the row's ids,
split as ``hist_bins`` splits a row (kernels/histbins.py ``id_shares``).  A
launch takes at most 65,535 rows; the wrapper splits larger batches
(kernels/histbins.py ``row_chunks``).
"""

import torch

from ..ops.histogram import NBINS, pdf_bins_plain
from .histbins import row_chunks
from .launch import launch, on_cuda, sm_count

__all__ = ["pdf_bins", "pdf_split"]

# the CTAs a launch gives an SM: four waves of the 8 CTAs of 256 threads
# and a 16 KB table an SM holds at once (its 2,048 threads); the fewest ids
# a CTA takes (two 16-byte vectors a thread).  On an NVIDIA H100 80GB HBM3
# at 700 W, 256 rows of 76,800 ids took 0.0562 ms at 16 CTAs a row (four
# waves) against 0.0575 at 4 (one wave) and 0.0581 at 1; one such row
# 0.0023 ms at 38 or 75 CTAs, 0.0033 at 8 (tools/torch_pdfbins_variants.py,
# PERF.md).
_CTAS_PER_SM = 32
_MIN_CTA_IDS = 2048


def pdf_split(n, p, sms):
    """CTAs a row of a launch over n rows of p ids on a card of ``sms``
    SMs: _CTAS_PER_SM CTAs an SM split evenly over the rows, no more than
    one a _MIN_CTA_IDS ids, at least one."""
    return max(1, min(-(-p // _MIN_CTA_IDS), _CTAS_PER_SM * sms // max(n, 1)))


def pdf_bins(bins, weights):
    """(N, P) i32 bin ids and (N, 4096) f32 weights -> (N, P) f32
    weights[n, bins[n, i]], +0.0 for an id outside [0, 4096) (an exact
    lookup).  On the card the table must be 16-byte aligned (its float4
    loads), and the output's address equals the ids' modulo 16 bytes: ids
    that are a view off the 16-byte boundary give an output at the same
    offset in its buffer."""
    if bins.dtype != torch.int32 or bins.dim() != 2:
        raise ValueError(f"bins must be (N, P) int32, got "
                         f"{tuple(bins.shape)} {bins.dtype}")
    N, P = bins.shape
    if weights.dtype != torch.float32 or tuple(weights.shape) != (N, NBINS):
        raise ValueError(f"weights must be ({N}, {NBINS}) float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    if not on_cuda(bins, weights):
        return pdf_bins_plain(bins, weights)
    if P >= 2 ** 31:
        raise ValueError(f"rows of {P} ids: the kernel takes fewer than 2^31")
    if weights.data_ptr() % 16:
        raise ValueError("weights must be 16-byte aligned (float4 table loads)")
    off = bins.data_ptr() % 16 // 4
    out = torch.empty(N * P + off, dtype=torch.float32,
                      device=bins.device)[off:].view(N, P)
    if out.numel():
        with torch.cuda.device(bins.device):
            for r0, r1 in row_chunks(N):
                c = pdf_split(r1 - r0, P, sm_count(bins.device))
                launch("pdf_bins", "pdf_bins_launch", bins[r0:r1].data_ptr(),
                       weights[r0:r1].data_ptr(), out[r0:r1].data_ptr(),
                       r1 - r0, P, c)
    return out
