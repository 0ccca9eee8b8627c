"""Wrapper of the ``meanshift`` CUDA kernels (``csrc/meanshift.cu``).

  mean_shift   replaces headtrackr_tpu/models/camshift.py _mean_shift_core
               (with _marginal_planes, _select_lines,
               _first_moments_marginal and _second_moments) and, on the
               serving path, tools/kernel_experiments.py::ta_call (k8),
               whose port ``take_along`` selected the prefix-sum lines

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/meanshift.py), a CUDA tensor launches a kernel, one launch a call for
every stream; any other device raises, and so does a failed build or
launch.  The twin and the kernels sum in the same order, so their results
are equal to the bit on every device.

Which kernel runs is ``route``'s choice, from the streams, the pdf's shape
and the card (``smem_bytes`` mirrors the source's layouts): one CTA a
stream with the prefix-sum planes in its shared memory, or a cluster of C
CTAs a stream with the planes split over theirs in strips of whole
32-element segments (``strips``), whichever runs the streams in the fewest
waves and then gives its busiest CTA the fewest prefix-sum values, a
cluster only while it takes at most 7 waves; else the global-scratch
kernel, which runs every stream at once.  On an H100 that is one CTA at
the 96x128 band and 256 streams, a cluster of 2 at 128x192 and 256
streams, 16 over the 240x320 frame at one stream and 8 at 32 to 231, the
scratch kernel at 256; 16 over 480x640 up to 56 streams (PERF.md,
tools/torch_meanshift_variants.py).  No route falls back to another: a
refused launch raises.
"""

import collections
import functools

import torch

from ..ops.meanshift import MOMENTS, mean_shift_plain
from .launch import launch, on_cuda

__all__ = ["mean_shift", "launch_kernel", "route", "strips", "smem_bytes",
           "scratch_floats", "Card", "H100", "MAX_SIDE", "CLUSTER_SIZES",
           "SCRATCH", "ONE_CTA"]

MAX_SIDE = 1024  # the kernels' limit on the pdf's rows and columns
SCRATCH, ONE_CTA = 0, 1  # meanshift_launch's c of the two one-CTA kernels
CLUSTER_SIZES = (2, 4, 8, 16)  # the cluster kernel's c
_SEG = 32  # a reduction segment, and a strip's unit
# CTAs of 256 threads an SM can hold by registers: the kernels take more
# than 64 a thread (96-122, by nvcc -Xptxas -v on sm_90a)
_CTAS_PER_SM = 2
# The cluster kernel's time grows with its waves, a stream's latency each;
# the scratch kernel runs all its streams in one.  On an H100 the cluster
# kernel won at 6 waves (192 streams of 240x320: 0.1319 ms against 0.1431)
# and lost at 8 (256 streams: 0.1717 against 0.1598), and over 480x640 won
# at 8 and lost at 16 (tools/torch_meanshift_variants.py, PERF.md).
_MAX_CLUSTER_WAVES = 7


# What ``route`` needs of a card: SMs, the shared memory a CTA may take, an
# SM's, and what the runtime keeps of it for each CTA (bytes).
Card = collections.namedtuple("Card", "sms smem_cta smem_sm reserved")
H100 = Card(132, 232448, 233472, 1024)  # an H100 SXM (80 GB)


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


def _r16(nbytes):
    return (nbytes + 15) & ~15


def _segs(length):
    return -(-length // _SEG)


def strips(length, c):
    """[lo, hi) of a pdf side's elements (rows or columns) that each CTA of
    a cluster of c holds (the source's strip_lo): the side's
    ceil(length / 32) segments split evenly in order, CTA k taking segments
    [k S // c, (k + 1) S // c), clipped to the length."""
    s = _segs(length)
    return [(min(_SEG * (k * s // c), length),
             min(_SEG * ((k + 1) * s // c), length)) for k in range(c)]


def _part_bytes(rows, bw):
    """The second moments' per-segment sums of ``rows`` rows (3 f64 a
    32-element segment of the padded width)."""
    return 3 * 8 * rows * max(_pow2(bw) // _SEG, 1)


def smem_bytes(bh, bw, c):
    """Bytes of dynamic shared memory a CTA of kernel c takes at bh x bw
    (the source's Layout and ClusterLayout; c as ``launch_kernel``'s)."""
    ph = _pow2(bh)
    rs = bw + 4 if bw % 4 == 0 else bw | 1  # R's row stride (floats)
    head = 16 + 16 * 4  # the mbarrier, the broadcast words
    if c in (SCRATCH, ONE_CTA):  # C and R of row stride rs
        planes = (_r16(max(bh * rs * 4, _part_bytes(bh, bw)))
                  + _r16(bh * rs * 4)) if c == ONE_CTA else 0
        return head + 3 * 32 * 8 + _r16(3 * ph * 8) + planes
    rows = _SEG * -(-_segs(bh) // c)  # the most rows, columns a CTA holds
    cs = _SEG * -(-_segs(bw) // c) + 4  # the column strip's row stride
    tables = 2 * 3 * 32 * 4 + 3 * 32 * 8
    return (head + tables + _r16(3 * rows * 8)
            + _r16(max(bh * cs * 4, _part_bytes(rows, bw)))
            + _r16(rows * rs * 4))


def scratch_floats(bh, bw):
    """Floats of global scratch a stream of the SCRATCH kernel takes: C,
    the transposed R and the second moments' per-segment sums."""
    return 2 * bh * bw + _part_bytes(bh, bw) // 4


def _busiest(bh, bw, c):
    """The most prefix-sum values a CTA of kernel c sums: its rows' and its
    columns' (both planes, in one CTA)."""
    if c == ONE_CTA:
        return 2 * bh * bw
    return max((r1 - r0) * bw + (x1 - x0) * bh for (r0, r1), (x0, x1)
               in zip(strips(bh, c), strips(bw, c)))


@functools.lru_cache(maxsize=None)
def route(n, bh, bw, card):
    """The kernel for n streams of bh x bw pdfs on ``card`` (a Card), as
    ``launch_kernel``'s c: of ONE_CTA and the cluster sizes whose CTAs fit
    the card's shared memory (a cluster only within _MAX_CLUSTER_WAVES
    waves), the one that runs the n streams in the fewest waves (a wave:
    as many streams as the SMs hold at once, by shared memory and at most
    _CTAS_PER_SM CTAs an SM), then the one whose busiest CTA sums the
    fewest values (a stream's latency), then the smaller; else SCRATCH.
    A pure function, cached: the wrapper asks it on every launch."""
    best = None
    for c in (ONE_CTA,) + CLUSTER_SIZES:
        need = smem_bytes(bh, bw, c)
        if need > card.smem_cta:
            continue
        per_sm = min(_CTAS_PER_SM, card.smem_sm // (need + card.reserved))
        per_wave = card.sms * per_sm // c
        waves = -(-n // per_wave) if per_wave else None
        if waves and (c == ONE_CTA or waves <= _MAX_CLUSTER_WAVES):
            key = (waves, _busiest(bh, bw, c), c)
            best = min(best or key, key)
    return SCRATCH if best is None else best[2]


@functools.lru_cache(maxsize=None)
def card(device):
    """The Card of a CUDA device (its shared memory read by the kernels'
    library)."""
    import ctypes
    from .build import load_library
    from .launch import sm_count
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = load_library().fn("meanshift_smem_limits")(
            ctypes.addressof(out))
    if err:
        raise RuntimeError(f"meanshift_smem_limits failed: cudaError {err}")
    return Card(sm_count(device), *out)


def mean_shift(pdf, window, frame_shape=None):
    """<= 10 mean-shift iterations for every stream, then the second and
    central moments: ``ops.meanshift.mean_shift_plain``'s contract, with
    the band placed from each window.

    pdf (N, bh, bw) f32: with ``frame_shape`` (H, W), over the band that
    ``models/camshift.py`` ``band_rect`` places around each stream's window
    in an (H, W) frame (the kernel places it itself, ``csrc/band.cuh``
    ``place_band``; the twin through ``band_rect``); without it, over the
    whole frame.  window (N, 4) i32; bh, bw <= MAX_SIDE.  Returns (window'
    (N, 4) i32, moments {name: (N,) f32}, zero_mass (N,) bool, escaped (N,)
    bool)."""
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
    if frame_shape is not None and not (bh <= frame_shape[0]
                                        and bw <= frame_shape[1]):
        raise ValueError(f"the {bh} x {bw} band must fit the frame "
                         f"{tuple(frame_shape)}")
    pdf, window = pdf.contiguous(), window.contiguous()
    if not on_cuda(pdf, window):
        if frame_shape is None:
            return mean_shift_plain(pdf, window)
        from ..models.camshift import band_rect
        ry, rx, _, _ = band_rect(window, (bh, bw), frame_shape)
        return mean_shift_plain(pdf, window, ry, rx, frame_shape)
    c = route(N, bh, bw, card(pdf.device))
    return launch_kernel(c, pdf, window, frame_shape)


def launch_kernel(c, pdf, window, frame_shape=None):
    """``mean_shift`` on contiguous CUDA tensors through kernel c, the
    C launcher's choice (ONE_CTA, a cluster size of CLUSTER_SIZES, or
    SCRATCH) in place of ``route``'s: the card tests and
    tools/torch_meanshift_variants.py force each.  Raises where the kernel
    does not fit the shape."""
    N, bh, bw = pdf.shape
    H, W = frame_shape if frame_shape is not None else (bh, bw)
    dev = pdf.device
    win = torch.empty((N, 4), dtype=torch.int32, device=dev)
    mom = torch.empty((N, len(MOMENTS)), dtype=torch.float32, device=dev)
    flags = torch.empty((N, 2), dtype=torch.bool, device=dev)
    if N:
        with torch.cuda.device(dev):
            scratch = (torch.empty((N * scratch_floats(bh, bw),),
                                   dtype=torch.float32, device=dev)
                       if c == SCRATCH else None)
            launch("meanshift", "meanshift_launch", pdf.data_ptr(),
                   window.data_ptr(), win.data_ptr(), mom.data_ptr(),
                   flags.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), N, bh,
                   bw, int(H), int(W), c)
    return (win, dict(zip(MOMENTS, mom.unbind(1))), flags[:, 0],
            flags[:, 1])
