"""Histogram and backprojection ops for the camshift tracker, batched over streams.

Reference math:
  - 4096-bin RGB histogram, bin = 256*(r>>4) + 16*(g>>4) + (b>>4)  (src/camshift.js:62-66)
  - ratio weights  min(model/cur, 1), 0 where cur == 0              (src/camshift.js:314-330)
  - backprojection pdf[p] = weights[bin(p)]                          (src/camshift.js:332-353)

``hist4096_plain``, ``backproject_plain``, ``backproject_ratio_plain`` and
``histpdf_band_plain`` are the plain PyTorch twins of the CUDA kernels in
``kernels/histpdf.py``, and
``hist_mma_plain`` that of ``kernels/histmma.py``, ``hist_bins_plain``
that of ``kernels/histbins.py`` and ``pdf_bins_plain`` that of
``kernels/pdfbins.py``: the same function, used for CPU tensors
and as the kernels' reference on the card.  ``histogram_rects``,
``histogram_full``, ``histogram_4096``, ``histogram_rect`` and
``histogram_scan`` go through the kernel wrappers, so a CUDA tensor always
takes a kernel.

Rects are (N, 4) i32 [x, y, w, h].  A *band* is a (bh, bw) rect of the same
size for every stream, placed at each rect's [x, y] clipped into the frame
(``band_origins``); ``bh <= H`` and ``bw <= W``.
"""

import math

import torch

__all__ = ["NBINS", "rgb_bins", "full_rects", "band_origins",
           "band_bins", "hist4096_plain", "hist_mma_plain", "hist_bins_plain",
           "pdf_bins_plain", "backproject_plain", "backproject_ratio_plain",
           "histpdf_band_plain", "HIST_KERNELS",
           "check_hist_kernel", "histogram_rects", "histogram_full",
           "histogram_4096", "histogram_rect", "histogram_scan",
           "backprojection_weights"]

NBINS = 4096
_MMA_CHUNK = 16  # streams a step of hist_mma_plain's one-hot product takes

# TrackerConfig.histKernel's values, each naming a full-frame histogram
# kernel: None (the reference's default, the int8 one-hot product) ->
# hist_mma; "pallas" (the reference's Mosaic kernel hist_pallas) ->
# hist4096.  Both give the same exact counts.
HIST_KERNELS = (None, "pallas")


def check_hist_kernel(kernel):
    """Raise on a histKernel value that names no kernel; return it."""
    if kernel not in HIST_KERNELS:
        raise ValueError(f"histKernel must be None or 'pallas', got "
                         f"{kernel!r}")
    return kernel


def rgb_bins(rgb):
    """(..., H, W, 3) u8 -> (..., H, W) i32 bin indices (u8 upcast first)."""
    c = rgb.to(torch.int32) >> 4
    return 256 * c[..., 0] + 16 * c[..., 1] + c[..., 2]


def full_rects(n, frame_shape, device):
    """(n, 4) i32 rects covering the whole (H, W) frame."""
    H, W = frame_shape
    r = torch.zeros((n, 4), dtype=torch.int32, device=device)
    r[:, 2] = W  # fills on the device: no host-to-device copy per call
    r[:, 3] = H
    return r


def band_origins(rects, band, frame_shape):
    """(N, 4) rects -> (x0, y0) (N,) i64: each rect's [x, y] clipped so the
    (bh, bw) band lies inside the (H, W) frame."""
    (bh, bw), (H, W) = band, frame_shape
    r = rects.to(torch.int64)
    return r[:, 0].clamp(0, W - bw), r[:, 1].clamp(0, H - bh)


def _inside(rects, frame_shape, device):
    """(N, H, W) bool: the pixels inside each [x, y, w, h] rect."""
    H, W = frame_shape
    N = rects.shape[0]
    rows = torch.arange(H, device=device).view(1, H, 1)
    cols = torch.arange(W, device=device).view(1, 1, W)
    r = rects.to(torch.int64)
    x, y = r[:, 0].view(N, 1, 1), r[:, 1].view(N, 1, 1)
    w, h = r[:, 2].view(N, 1, 1), r[:, 3].view(N, 1, 1)
    return (rows >= y) & (rows < y + h) & (cols >= x) & (cols < x + w)


def hist4096_plain(frames, rects):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) i32 exact counts
    of the pixels inside each stream's rect (clamped to the frame)."""
    N, H, W, _ = frames.shape
    inside = _inside(rects, (H, W), frames.device)
    flat = rgb_bins(frames).to(torch.int64) + NBINS * torch.arange(
        N, device=frames.device).view(N, 1, 1)
    counts = torch.bincount(flat[inside], minlength=N * NBINS)
    return counts.view(N, NBINS).to(torch.int32)


def hist_mma_plain(frames, rects):
    """``hist4096_plain``'s function by ``hist_mma``'s (and the reference's
    ``histogram_scan``'s) formulation: per stream the product
    OneHot(hi)^T @ OneHot(lo) (64, 64) of bin = 64 hi + lo, where a pixel
    outside the rect takes hi = 64, which matches no row.  (N, 4096) f32;
    the 0/1 products sum exactly in f32 below 2^24 pixels.  _MMA_CHUNK
    streams at a time bound the one-hots' memory."""
    N, H, W, _ = frames.shape
    dev = frames.device
    bins = rgb_bins(frames)
    hi = torch.where(_inside(rects, (H, W), dev), bins >> 6, 64).view(N, -1)
    lo = (bins & 63).view(N, -1)
    iota = torch.arange(64, device=dev)
    c = _MMA_CHUNK
    out = [torch.bmm((hi[s:s + c, :, None] == iota).float().transpose(1, 2),
                     (lo[s:s + c, :, None] == iota).float())
           for s in range(0, N, c)]
    if not out:
        return torch.zeros((0, NBINS), dtype=torch.float32, device=dev)
    return torch.cat(out).view(N, NBINS)


def hist_bins_plain(bins):
    """(N, P) i32 bin ids -> (N, 4096) f32 exact counts, one histogram per
    row; an id outside [0, 4096) counts nowhere.  Integer counts (one
    bincount over per-row offset ids), converted to f32 at the end."""
    N = bins.shape[0]
    b = bins.to(torch.int64)
    ok = (b >= 0) & (b < NBINS)
    flat = b + NBINS * torch.arange(N, device=bins.device).view(N, 1)
    counts = torch.bincount(flat[ok], minlength=N * NBINS)
    return counts.view(N, NBINS).to(torch.float32)


def pdf_bins_plain(bins, weights):
    """(N, ...) i32 bin ids and (N, 4096) f32 weights, or (...) ids and one
    (4096,) table -> f32 weights[n, bin] of the bins' shape, +0.0 for an id
    outside [0, 4096): a gather at the clamped ids, then a select."""
    w = weights.reshape(-1, NBINS)
    ids = bins.reshape(w.shape[0], bins.numel() // max(w.shape[0], 1))
    ids = ids.to(torch.int64)
    got = torch.gather(w, 1, ids.clamp(0, NBINS - 1))
    return torch.where((ids >= 0) & (ids < NBINS), got, 0.0).view(bins.shape)


def band_bins(frames, rects, band):
    """(N, bh, bw) i64 bins of each stream's band."""
    N, H, W, _ = frames.shape
    bh, bw = band
    x0, y0 = band_origins(rects, band, (H, W))
    dev = frames.device
    rows = (y0.view(N, 1) + torch.arange(bh, device=dev)).view(N, bh, 1)
    cols = (x0.view(N, 1) + torch.arange(bw, device=dev)).view(N, 1, bw)
    bins = rgb_bins(frames).to(torch.int64)
    bins = torch.gather(bins, 1, rows.expand(N, bh, W))
    return torch.gather(bins, 2, cols.expand(N, bh, bw))


def backproject_plain(frames, weights, rects=None, band=None):
    """(N, H, W, 3) u8 + (N, 4096) f32 -> pdf = weights[bin]: (N, H, W) over
    the frame, or (N, bh, bw) over each stream's band when ``rects`` and
    ``band`` are given."""
    N = frames.shape[0]
    if rects is None:
        bins = rgb_bins(frames).to(torch.int64)
    else:
        bins = band_bins(frames, rects, band)
    return torch.gather(weights, 1, bins.view(N, -1)).view(bins.shape)


def backproject_ratio_plain(frames, model, cur, rects=None, band=None):
    """``backproject_plain`` of the ratio weights of ``model`` against
    ``cur`` (``backprojection_weights``), looked up in the same order: the
    twin of ``kernels/histpdf.py`` ``backproject_ratio``, which forms each
    weight as it stages its table."""
    return backproject_plain(frames, backprojection_weights(model, cur),
                             rects, band)


def histpdf_band_plain(frames, rects, model=None, band=None):
    """Hist-only (``model`` None): (N, 4096) f32 exact counts of each rect,
    clamped to the frame.  Otherwise (cur, pdf): the counts of each stream's
    (bh, bw) band, and pdf (N, bh, bw) = min(model/cur, 1)[bin]."""
    if model is None:
        return hist4096_plain(frames, rects).to(torch.float32)
    N, H, W, _ = frames.shape
    bh, bw = band
    x0, y0 = band_origins(rects, band, (H, W))
    brects = torch.stack([x0, y0, torch.full_like(x0, bw),
                          torch.full_like(x0, bh)], 1)
    cur = hist4096_plain(frames, brects).to(torch.float32)
    pdf = backproject_plain(frames, backprojection_weights(model, cur),
                            brects, band)
    return cur, pdf


def histogram_rects(frames, rects):
    """Model histogram of each stream's rect: (N, 4096) f32 counts
    (Histogram(getImageData(rect)), src/camshift.js:206-208); the hist-only
    mode of ``histpdf_band``, one block per stream on the card."""
    from ..kernels.histpdf import histpdf_band
    return histpdf_band(frames, rects)


def histogram_full(frames, kernel=None):
    """Current full-frame histogram: (N, 4096) f32 counts, by the kernel
    that ``kernel`` (TrackerConfig.histKernel) names in HIST_KERNELS, over
    the whole frame (no rects: nothing runs on the host or the card before
    the kernel)."""
    from ..kernels.histmma import hist_mma
    from ..kernels.histpdf import hist4096
    fn = hist_mma if check_hist_kernel(kernel) is None else hist4096
    return fn(frames, None)


def histogram_4096(bins, mask=None):
    """(..., H, W) i32 bin ids -> (..., 4096) f32 exact counts, one
    histogram per leading index (a stream); ids outside [0, 4096) count
    nowhere.  ``mask`` (bool, broadcast to ``bins``): False pixels count
    nowhere.  The ``hist_bins`` kernel on the card."""
    from ..kernels.histbins import hist_bins
    if mask is not None:
        bins = torch.where(mask, bins, -1)
    lead, (H, W) = bins.shape[:-2], bins.shape[-2:]
    rows = bins.reshape(math.prod(lead), H * W).contiguous()
    return hist_bins(rows).view(*lead, NBINS)


def histogram_rect(bins, x, y, w, h, block=None):
    """The reference's ``histogram_rect``: (..., H, W) i32 bin ids -> (...,
    4096) f32 exact counts of the rect [x, x + w) x [y, y + h) of each
    leading index; x, y, w, h are ints or tensors of the leading shape.  A
    mask plus ``histogram_4096``.  ``block`` is the reference's TPU tiling
    knob: accepted, changes nothing."""
    H, W = bins.shape[-2:]
    dev = bins.device

    def corner(v):
        t = torch.as_tensor(v, device=dev).to(torch.int64)
        return t.view(*t.shape, 1, 1)

    x, y, w, h = map(corner, (x, y, w, h))
    rows = torch.arange(H, device=dev).view(H, 1)
    cols = torch.arange(W, device=dev).view(1, W)
    inside = (rows >= y) & (rows < y + h) & (cols >= x) & (cols < x + w)
    return histogram_4096(bins, inside)


def histogram_scan(bins, block=None):
    """``histogram_4096`` without a mask.  ``block`` is the reference's TPU
    tiling knob: accepted, changes nothing."""
    return histogram_4096(bins)


def backprojection_weights(model_hist, cur_hist):
    """min(model/cur, 1) with 0 where cur == 0 (IEEE f32 division)."""
    nz = cur_hist != 0
    safe = torch.where(nz, cur_hist, torch.ones_like(cur_hist))
    return torch.where(nz, torch.clamp(model_hist / safe, max=1.0),
                       torch.zeros_like(cur_hist))
