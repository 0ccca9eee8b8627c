"""Wrappers of the camshift CUDA kernels (``csrc/histpdf.cu``).

  hist4096      replaces headtrackr_tpu/kernels/histpdf.py::hist_pallas
  backproject   replaces headtrackr_tpu/kernels/histpdf.py::pdf_pallas
                (over the frame, or over a per-stream band: backproject_rect)
  histpdf_band  replaces tools/kernel_experiments.py hp_call (k4) and
                hp7_call (k7); in hist-only mode hist_call (k3)

Dispatch: a CPU tensor takes the kernel's plain twin (ops/histogram.py); a
CUDA tensor launches the kernel, built on first use (kernels/build.py);
any other device raises.  There is no fallback: a failed build or launch
raises.  ``launches`` (kernels/launch.py) counts the device launches of each
kernel, so a run can show that its main path went through the kernels.
"""

import torch

from ..ops.histogram import (NBINS, backproject_plain, hist4096_plain,
                             histpdf_band_plain)
from .launch import launch as _launch
from .launch import on_cuda as _on_cuda

__all__ = ["hist4096", "backproject", "histpdf_band"]


def _check_frames(frames):
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")


def _check_rects(rects, n):
    if rects.dtype != torch.int32 or tuple(rects.shape) != (n, 4):
        raise ValueError(f"rects must be ({n}, 4) int32, got "
                         f"{tuple(rects.shape)} {rects.dtype}")


def _check_table(name, t, n):
    if t.dtype != torch.float32 or tuple(t.shape) != (n, NBINS):
        raise ValueError(f"{name} must be ({n}, {NBINS}) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check_band(band, H, W):
    bh, bw = (int(v) for v in band)
    if not (1 <= bh <= H and 1 <= bw <= W):
        raise ValueError(f"band {band} must fit the ({H}, {W}) frame")
    return bh, bw


def hist4096(frames, rects):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) f32 exact
    counts of each stream's rect (clamped to the frame).  Its grid covers
    the frame: meant for full-frame rects (small ones: ``histpdf_band``)."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    _check_rects(rects, N)
    if not _on_cuda(frames, rects):
        return hist4096_plain(frames, rects).to(torch.float32)
    out = torch.zeros((N, NBINS), dtype=torch.int32, device=frames.device)
    if N:
        with torch.cuda.device(frames.device):
            _launch("hist4096", "hist4096_launch", frames.data_ptr(),
                    rects.data_ptr(), out.data_ptr(), N, H, W)
    return out.to(torch.float32)


def backproject(frames, weights, rects=None, band=None):
    """(N, H, W, 3) u8 + (N, 4096) f32 -> pdf = weights[bin]: (N, H, W)
    over the frame, or with ``rects`` (N, 4) i32 and ``band`` (bh, bw),
    (N, bh, bw) over the band at each rect's [x, y] (clipped into the
    frame)."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    _check_table("weights", weights, N)
    if rects is not None:
        _check_rects(rects, N)
        bh, bw = _check_band(band, H, W)
    tensors = (frames, weights) if rects is None else (frames, weights, rects)
    if not _on_cuda(*tensors):
        return backproject_plain(frames, weights, rects, band)
    if weights.data_ptr() % 16:
        raise ValueError("weights must be 16-byte aligned (float4 table load)")
    shape = (N, H, W) if rects is None else (N, bh, bw)
    out = torch.empty(shape, dtype=torch.float32, device=frames.device)
    if N:
        with torch.cuda.device(frames.device):
            if rects is None:
                _launch("backproject", "backproject_launch", frames.data_ptr(),
                        weights.data_ptr(), out.data_ptr(), N, H, W)
            else:
                _launch("backproject_rect", "backproject_rect_launch",
                        frames.data_ptr(), weights.data_ptr(), rects.data_ptr(),
                        out.data_ptr(), N, H, W, bh, bw)
    return out


def histpdf_band(frames, rects, model=None, band=None):
    """One block per stream: the histogram of a rect and, given the model,
    the ratio weights and the pdf over it.

    Hist-only (``model`` None): (N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h]
    -> (N, 4096) f32 exact counts of each rect clamped to the frame (the
    handoff model histogram of a detection box).

    Pdf mode: also ``model`` (N, 4096) f32 and ``band`` (bh, bw); each
    rect's [x, y] places the band (clipped into the frame).  Returns
    (cur (N, 4096) f32 counts of the band, pdf (N, bh, bw) f32 =
    min(model/cur, 1)[bin]) -- one band-local camshift tick's pixel work."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    _check_rects(rects, N)
    if model is None:
        if not _on_cuda(frames, rects):
            return histpdf_band_plain(frames, rects)
        cur = torch.empty((N, NBINS), dtype=torch.float32, device=frames.device)
        if N:
            with torch.cuda.device(frames.device):
                _launch("histpdf_band_hist", "histpdf_band_launch",
                        frames.data_ptr(), rects.data_ptr(), None,
                        cur.data_ptr(), None, N, H, W, 0, 0)
        return cur
    _check_table("model", model, N)
    bh, bw = _check_band(band, H, W)
    if not _on_cuda(frames, rects, model):
        return histpdf_band_plain(frames, rects, model, (bh, bw))
    cur = torch.empty((N, NBINS), dtype=torch.float32, device=frames.device)
    pdf = torch.empty((N, bh, bw), dtype=torch.float32, device=frames.device)
    if N:
        with torch.cuda.device(frames.device):
            _launch("histpdf_band", "histpdf_band_launch", frames.data_ptr(),
                    rects.data_ptr(), model.data_ptr(), cur.data_ptr(),
                    pdf.data_ptr(), N, H, W, bh, bw)
    return cur, pdf
