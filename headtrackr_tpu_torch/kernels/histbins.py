"""Wrapper of the ``hist_bins`` CUDA kernel (``csrc/histbins.cu``).

  hist_bins   replaces tools/kernel_experiments.py:257 mk_call(hist_k5), the
              4096-bin histogram of precomputed i32 bin ids (the JAX
              package's ops/histogram.py histogram_4096 / histogram_scan);
              the port's ``histogram_4096`` and ``camshift.Histogram``

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/histogram.py ``hist_bins_plain``), a CUDA tensor launches the kernel,
any other device raises.  The kernel is hist4096's cluster histogram with
an i32 loader: one cluster of C CTAs a row (``split_bins``), each CTA
counting a share of the row's ids (``id_shares``) and reducing a slice of
the bins over its peers.  A launch takes at most ``MAX_ROWS`` rows (the
grid's y limit); the wrapper splits larger batches (``row_chunks``).
"""

import torch

from ..ops.histogram import NBINS, hist_bins_plain
from .launch import launch, on_cuda, sm_count

__all__ = ["hist_bins", "split_bins", "id_shares", "row_chunks", "MAX_ROWS"]

MAX_ROWS = 65535  # rows a launch takes: the grid's y dimension
# the CTAs a launch puts on an SM (one wave of them), the fewest ids a
# counting CTA takes, the largest cluster (as kernels/histpdf.py).  On an
# NVIDIA H100 80GB HBM3 at 700 W C = 2 won at 256 rows of 76,800 ids
# (random and the bench pool's), 16 at one such row and 4 at one row of
# 12,288 ids (tools/torch_histbins_variants.py, PERF.md).
_CTAS_PER_SM = 4
_MIN_CTA_IDS = 3072
_MAX_CLUSTER = 16


def split_bins(n, p, sms):
    """CTAs a row (a power of two <= 16) of a launch over n rows of p ids
    on a card of ``sms`` SMs: one wave of _CTAS_PER_SM CTAs an SM split
    evenly over the rows, no more than one a _MIN_CTA_IDS ids, at least
    one."""
    c = min(_MAX_CLUSTER, -(-p // _MIN_CTA_IDS),
            _CTAS_PER_SM * sms // max(n, 1))
    return 1 << (max(1, c).bit_length() - 1)


def id_shares(c, p, head=0):
    """The ids of a row of p ids that each CTA of a cluster of c counts
    (the kernel's split), as a list of [lo, hi) ranges a CTA: the row's
    whole 16-byte vectors after its ``head`` unaligned ids (0-3, from the
    row's address) split evenly over the first min(c, vectors) CTAs (at
    least one); CTA 0 also takes the head and the ids after the last whole
    vector; the other CTAs count none."""
    head = min(head, p)
    nvec = (p - head) // 4
    active = max(1, min(c, nvec))
    shares = []
    for k in range(c):
        if k >= active:
            shares.append([])
            continue
        v0, v1 = k * nvec // active, (k + 1) * nvec // active
        r = [(head + 4 * v0, head + 4 * v1)]
        if k == 0:
            r += [(0, head), (head + 4 * nvec, p)]
        shares.append([(lo, hi) for lo, hi in r if hi > lo])
    return shares


def row_chunks(n, most=None):
    """[r0, r1) of the launches over n rows, each at most ``MAX_ROWS`` (and
    at most ``most``, where given).  Every wrapper whose kernel puts the
    stream on the grid's y dimension splits its batch by it."""
    step = MAX_ROWS if most is None else max(1, min(most, MAX_ROWS))
    return [(r0, min(r0 + step, n)) for r0 in range(0, n, step)]


def hist_bins(bins):
    """(N, P) i32 bin ids -> (N, 4096) f32 exact counts, one histogram per
    row (stream); an id outside [0, 4096) counts nowhere."""
    if bins.dtype != torch.int32 or bins.dim() != 2:
        raise ValueError(f"bins must be (N, P) int32, got "
                         f"{tuple(bins.shape)} {bins.dtype}")
    cuda = on_cuda(bins)
    N, P = bins.shape
    if cuda and P >= 2 ** 31:
        raise ValueError(f"rows of {P} ids: the kernel takes fewer than 2^31")
    out = torch.empty((N, NBINS), dtype=torch.float32, device=bins.device)
    for r0, r1 in row_chunks(N):
        if not cuda:
            out[r0:r1] = hist_bins_plain(bins[r0:r1])
            continue
        c = split_bins(r1 - r0, P, sm_count(bins.device))
        with torch.cuda.device(bins.device):
            launch("hist_bins", "hist_bins_launch", bins[r0:r1].data_ptr(),
                   out[r0:r1].data_ptr(), r1 - r0, P, c)
    return out
