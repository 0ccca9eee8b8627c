"""Histogram and backprojection ops for the camshift tracker, batched over streams.

Reference math:
  - 4096-bin RGB histogram, bin = 256*(r>>4) + 16*(g>>4) + (b>>4)  (src/camshift.js:62-66)
  - ratio weights  min(model/cur, 1), 0 where cur == 0              (src/camshift.js:314-330)
  - backprojection pdf[p] = weights[bin(p)]                          (src/camshift.js:332-353)

``hist4096_plain`` and ``backproject_plain`` are the plain PyTorch twins of the
CUDA kernels in ``kernels/histpdf.py``: the same function, used for CPU
tensors and as the kernels' reference on the card.  ``histogram_rect`` and
``histogram_full`` go through the kernel wrapper, so a CUDA tensor always
takes the kernel.
"""

import torch

__all__ = ["NBINS", "rgb_bins", "full_rects", "hist4096_plain",
           "backproject_plain", "histogram_rect", "histogram_full",
           "backprojection_weights"]

NBINS = 4096


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


def hist4096_plain(frames, rects):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) i32 exact counts
    of the pixels inside each stream's rect (clamped to the frame)."""
    N, H, W, _ = frames.shape
    bins = rgb_bins(frames)
    rows = torch.arange(H, device=frames.device).view(1, H, 1)
    cols = torch.arange(W, device=frames.device).view(1, 1, W)
    r = rects.to(torch.int64)
    x, y = r[:, 0].view(N, 1, 1), r[:, 1].view(N, 1, 1)
    w, h = r[:, 2].view(N, 1, 1), r[:, 3].view(N, 1, 1)
    inside = (rows >= y) & (rows < y + h) & (cols >= x) & (cols < x + w)
    flat = bins.to(torch.int64) + NBINS * torch.arange(
        N, device=frames.device).view(N, 1, 1)
    counts = torch.bincount(flat[inside], minlength=N * NBINS)
    return counts.view(N, NBINS).to(torch.int32)


def backproject_plain(frames, weights):
    """(N, H, W, 3) u8 + (N, 4096) f32 -> (N, H, W) f32, pdf = weights[bin]."""
    N, H, W, _ = frames.shape
    bins = rgb_bins(frames).view(N, H * W).to(torch.int64)
    return torch.gather(weights, 1, bins).view(N, H, W)


def histogram_rect(frames, rects):
    """Model histogram of each stream's rect: (N, 4096) f32 counts
    (Histogram(getImageData(rect)), src/camshift.js:206-208)."""
    from ..kernels.histpdf import hist4096
    return hist4096(frames, rects)


def histogram_full(frames):
    """Current full-frame histogram: (N, 4096) f32 counts."""
    N, H, W, _ = frames.shape
    return histogram_rect(frames, full_rects(N, (H, W), frames.device))


def backprojection_weights(model_hist, cur_hist):
    """min(model/cur, 1) with 0 where cur == 0 (IEEE f32 division)."""
    nz = cur_hist != 0
    safe = torch.where(nz, cur_hist, torch.ones_like(cur_hist))
    return torch.where(nz, torch.clamp(model_hist / safe, max=1.0),
                       torch.zeros_like(cur_hist))
