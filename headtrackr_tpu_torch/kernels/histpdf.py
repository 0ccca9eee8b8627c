"""Wrappers of the camshift CUDA kernels (``csrc/histpdf.cu``).

  hist4096      replaces headtrackr_tpu/kernels/histpdf.py::hist_pallas
  backproject   replaces headtrackr_tpu/kernels/histpdf.py::pdf_pallas
                (over the frame, or over a per-stream band: backproject_rect)
  backproject_ratio
                the same kernels forming the table from the model and the
                current counts (headtrackr_tpu/ops/histogram.py:141
                backprojection_weights) as they stage it: the camshift
                step's weights and pdf, no weights tensor
  histpdf_band  replaces tools/kernel_experiments.py hp_call (k4) and
                hp7_call (k7); in hist-only mode hist_call (k3)
  hist_pallas   the reference's name and contract for K1, on bin ids: the
                ``hist_bins`` kernel (kernels/histbins.py)
  pdf_pallas    the reference's name and contract for K2, on bin ids: the
                ``pdf_bins`` kernel (kernels/pdfbins.py)

Dispatch: a CPU tensor takes the kernel's plain twin (ops/histogram.py); a
CUDA tensor launches the kernel, built on first use (kernels/build.py);
any other device raises.  There is no fallback: a failed build or launch
raises.  ``launches`` (kernels/launch.py) counts the device launches of each
kernel, so a run can show that its main path went through the kernels.

``hist4096`` and ``histpdf_band`` run one thread-block cluster of C CTAs a
stream (``cluster_split``), each CTA counting a share of the rect's rows
(``cluster_rows``) and reducing a slice of the bins over its peers.

The frame readers (``hist4096``, ``backproject`` and
``backproject_ratio``, ``histpdf_band``'s pdf mode, and
kernels/histmma.py's ``hist_mma``) read their frames in place under
``launch.frames_at(frames, source)`` (``launch.frames_of``): on the card the
kernel loads the frames' address from source's word (the serving
program's parameter block, which tick_select sets to tick k's frames), on
the CPU the twin reads source.

The band kernels (``backproject`` with a band, ``histpdf_band``'s pdf
mode) take each stream's search window and place its band themselves
(``csrc/band.cuh`` ``place_band``, one placement a CTA); their twins place
it with ``models/camshift.py`` ``band_rect``, the same rule in the same
i32 arithmetic, so no placement runs on the host or as PyTorch operations
on the card.

Each kernel here puts the stream on the grid's y dimension, so a launch
takes at most 65,535 streams: the wrappers split a larger batch into
launches of at most that many (kernels/histbins.py ``row_chunks``), each
sized as if its streams were the batch.  The split follows N alone, so a
CUDA graph captures as many launches as an eager call makes.
"""

import torch

from ..ops.histogram import (NBINS, backproject_plain,
                             backproject_ratio_plain, full_rects,
                             hist4096_plain, histpdf_band_plain)
from .histbins import hist_bins, row_chunks
from .launch import frames_of as _frames_of
from .launch import launch as _launch
from .launch import on_cuda as _on_cuda
from .launch import row_ptr as _row_ptr
from .launch import sm_count as _sm_count
from .pdfbins import pdf_bins

__all__ = ["hist4096", "backproject", "backproject_ratio", "histpdf_band",
           "hist_pallas", "pdf_pallas", "cluster_split", "cluster_rows"]

# the cluster histogram's CTAs a launch puts on an SM (one wave of them),
# the pixels a counting CTA takes at least (csrc/histpdf.cu kMinCtaPx), the
# largest cluster.  Each CTA pays a fixed cost (zeroing its 16 KB histogram,
# reading its slice from every peer), so fewer, longer CTAs win once the
# card is full: on an H100 at 256 streams C = 2 beat 1, 4, 8 and 16 on the
# bench pool, random bins, the 96x128 band and boxes, and came within 8%
# of C = 8 over the frame (tools/torch_histpdf_variants.py, PERF.md).
_CTAS_PER_SM = 4
_MIN_CTA_PX = 3072
_MAX_CLUSTER = 16


def cluster_split(n, rows, cols, sms):
    """CTAs a stream (a power of two <= 16) of a cluster launch over n
    streams whose rects are at most rows x cols on a card of ``sms`` SMs:
    one wave of _CTAS_PER_SM CTAs an SM split evenly over the streams, no
    more than one a row or one a _MIN_CTA_PX pixels (the kernel narrows
    that again to each rect's own size, ``cluster_rows``)."""
    c = min(_MAX_CLUSTER, rows, -(-rows * cols // _MIN_CTA_PX),
            _CTAS_PER_SM * sms // max(n, 1))
    return 1 << (max(1, c).bit_length() - 1)


def cluster_rows(c, rows, cols):
    """[r0, r1) of a rows x cols rect that each CTA of a cluster of c counts
    (the kernel's cta_share): the rows split evenly over the first
    min(c, ceil(rows cols / _MIN_CTA_PX), rows) CTAs (at least one); the
    others count none."""
    active = max(1, min(c, -(-rows * cols // _MIN_CTA_PX), rows))
    return [(k * rows // active, (k + 1) * rows // active) if k < active
            else (rows, rows) for k in range(c)]


def _check_frames(frames):
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")


def _check_rects(rects, n, name="rects"):
    if rects.dtype != torch.int32 or tuple(rects.shape) != (n, 4):
        raise ValueError(f"{name} must be ({n}, 4) int32, got "
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


def _placed(windows, band, H, W):
    """The twins' (N, 4) i32 band rects for the search windows:
    ``models/camshift.py`` ``band_rect``'s placement (the kernels' own
    rule)."""
    from ..models.camshift import band_rect, band_rects
    return band_rects(*band_rect(windows, band, (H, W)))


def hist4096(frames, rects=None):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) f32 exact
    counts of each stream's rect (clamped to the frame); ``rects`` None:
    of the whole frame (the kernel reads no rect).  One cluster a stream
    sized by the frame: meant for the whole frame (a box counts on one or
    two of its CTAs; ``histpdf_band``'s hist-only mode sizes its clusters
    the same way).  Reads its frames in place under ``launch.frames_at``."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    if rects is not None:
        _check_rects(rects, N)
    card = _on_cuda(frames, *(() if rects is None else (rects,)))
    frames, at = _frames_of(frames, card)
    if not card:
        if rects is None:
            rects = full_rects(N, (H, W), frames.device)
        return hist4096_plain(frames, rects).to(torch.float32)
    return _counts("hist4096", frames, rects, at)


def _counts(key, frames, rects, at=0):
    """The rects' counts (None: the whole frame) by the cluster kernel (C
    from the frame), its launch counted under ``key``; ``at``: the address
    word of frames read in place (``launch.frames_of``), 0 for none."""
    N, H, W, _ = frames.shape
    out = torch.empty((N, NBINS), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        for r0, r1 in row_chunks(N):
            # in place, streams r0.. lie r0 frames past the word's address
            c = cluster_split(r1 - r0, H, W, _sm_count(frames.device))
            _launch(key, "hist4096_launch", _row_ptr(frames, r0),
                    0 if rects is None else _row_ptr(rects, r0),
                    _row_ptr(out, r0), r1 - r0, H, W, c, at,
                    r0 * H * W * 3)
    return out


def backproject(frames, weights, windows=None, band=None):
    """(N, H, W, 3) u8 + (N, 4096) f32 -> pdf = weights[bin]: (N, H, W)
    over the frame, or with ``windows`` (N, 4) i32 [x, y, w, h] search
    windows and ``band`` (bh, bw), (N, bh, bw) over the band placed around
    each window (``models/camshift.py`` ``band_rect``'s rule; the kernel,
    ``backproject_rect``, places it itself).  Reads its frames in place
    under ``launch.frames_at``."""
    return _lookup(frames, weights, None, windows, band)


def backproject_ratio(frames, model, cur, windows=None, band=None):
    """``backproject`` of the ratio weights min(model / cur, 1), 0 where
    cur == 0 (``ops/histogram.py`` ``backprojection_weights``), which the
    kernel forms from the (N, 4096) f32 model histogram and current counts
    as it stages its table (IEEE division, F6; each weight bit-equal to the
    twin's on the card): one launch, no weights tensor.  Counted as
    ``backproject_ratio`` over the frame, ``backproject_rect_ratio`` over
    the band."""
    _check_table("cur", cur, frames.shape[0])
    return _lookup(frames, model, cur, windows, band)


def _lookup(frames, table, cur, windows, band):
    """``backproject`` (cur None: ``table`` the weights) and
    ``backproject_ratio`` (``table`` the model)."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    _check_table("model" if cur is not None else "weights", table, N)
    if windows is not None:
        _check_rects(windows, N, "windows")
        bh, bw = _check_band(band, H, W)
    tensors = [t for t in (frames, table, cur, windows) if t is not None]
    card = _on_cuda(*tensors)
    frames, at = _frames_of(frames, card)
    if not card:
        rects = (None if windows is None
                 else _placed(windows, (bh, bw), H, W))
        b = None if windows is None else (bh, bw)
        if cur is None:
            return backproject_plain(frames, table, rects, b)
        return backproject_ratio_plain(frames, table, cur, rects, b)
    if any(t.data_ptr() % 16 for t in (table, cur) if t is not None):
        raise ValueError("the table and the counts must be 16-byte aligned "
                         "(float4 table loads)")
    shape = (N, H, W) if windows is None else (N, bh, bw)
    out = torch.empty(shape, dtype=torch.float32, device=frames.device)
    key = "backproject" if windows is None else "backproject_rect"
    key += "" if cur is None else "_ratio"
    with torch.cuda.device(frames.device):
        for r0, r1 in row_chunks(N):
            ptrs = (_row_ptr(frames, r0), _row_ptr(table, r0))
            if windows is not None:
                ptrs += (_row_ptr(windows, r0),)
            dims = (H, W) if windows is None else (H, W, bh, bw)
            # in place, streams r0.. lie r0 frames past the word's address
            _launch(key, "backproject_launch" if windows is None
                    else "backproject_rect_launch", *ptrs,
                    _row_ptr(out, r0), r1 - r0, *dims,
                    0 if cur is None else _row_ptr(cur, r0), at,
                    r0 * H * W * 3)
    return out


def histpdf_band(frames, boxes, model=None, band=None):
    """One cluster per stream: the histogram of a rect and, given the model,
    the ratio weights and the pdf over a band.

    Hist-only (``model`` None): (N, H, W, 3) u8 + ``boxes`` (N, 4) i32
    [x, y, w, h] rects -> (N, 4096) f32 exact counts of each rect clamped
    to the frame (the handoff model histogram of a detection box):
    ``hist4096``'s kernel, counted as ``histpdf_band_hist``.

    Pdf mode: ``boxes`` are the streams' (N, 4) i32 [x, y, w, h] search
    windows, ``model`` (N, 4096) f32 (16-byte aligned) and ``band`` (bh,
    bw); the band lies where ``models/camshift.py`` ``band_rect`` places
    it around each window (each CTA of the kernel places it itself).
    Returns (cur (N, 4096) f32 counts of the band, pdf (N, bh, bw) f32 =
    min(model/cur, 1)[bin]) -- one band-local camshift tick's pixel work,
    C from the band's size (``cluster_split``).  Under
    ``launch.frames_at(frames, source)`` the pdf mode reads its frames at
    ``source`` (the serving program's all-CS and bucket bodies read tick
    k's frames where they lie): on the card the kernel loads their address
    from source's word, on the CPU the twin reads source."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    _check_rects(boxes, N)
    if model is None:
        if not _on_cuda(frames, boxes):
            return histpdf_band_plain(frames, boxes)
        return _counts("histpdf_band_hist", frames, boxes)
    _check_table("model", model, N)
    bh, bw = _check_band(band, H, W)
    card = _on_cuda(frames, boxes, model)
    frames, at = _frames_of(frames, card)
    if not card:
        return histpdf_band_plain(frames, _placed(boxes, (bh, bw), H, W),
                                  model, (bh, bw))
    if model.data_ptr() % 16:
        raise ValueError("model must be 16-byte aligned (float4 loads)")
    cur = torch.empty((N, NBINS), dtype=torch.float32, device=frames.device)
    pdf = torch.empty((N, bh, bw), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        for r0, r1 in row_chunks(N):
            # in place, streams r0.. lie r0 frames past the word's address
            c = cluster_split(r1 - r0, bh, bw, _sm_count(frames.device))
            _launch("histpdf_band", "histpdf_band_launch",
                    _row_ptr(frames, r0), _row_ptr(boxes, r0),
                    _row_ptr(model, r0), _row_ptr(cur, r0),
                    _row_ptr(pdf, r0), r1 - r0, H, W, bh, bw, c, at,
                    r0 * H * W * 3)
    return cur, pdf


def _check_bins(bins):
    if bins.dtype != torch.int32 or bins.dim() not in (2, 3):
        raise ValueError(f"bins must be (H, W) or (N, H, W) int32, got "
                         f"{tuple(bins.shape)} {bins.dtype}")


def hist_pallas(bins, block=None):
    """The reference's ``hist_pallas`` (headtrackr_tpu/kernels/histpdf.py):
    (H, W) or (N, H, W) i32 bin ids -> (4096,) or (N, 4096) f32 exact
    counts; an id outside [0, 4096) counts nowhere.  The ``hist_bins``
    kernel over each stream's ids.  ``block`` is the reference's TPU tiling
    knob: accepted, changes nothing."""
    _check_bins(bins)
    rows = bins.reshape(-1 if bins.dim() == 3 else 1,
                        bins.shape[-2] * bins.shape[-1])
    out = hist_bins(rows.contiguous())
    return out if bins.dim() == 3 else out[0]


def pdf_pallas(bins, weights, block=None):
    """The reference's ``pdf_pallas``: (H, W) or (N, H, W) i32 bin ids and
    (4096,) or (N, 4096) f32 weights -> the f32 lookup weights[bin] of the
    bins' shape; an id outside [0, 4096) looks up +0.0, as the reference's
    one-hot gives.  One ``pdf_bins`` launch: each stream's table looked up
    with the range check in the same pass.  ``block`` is the reference's
    TPU tiling knob: accepted, changes nothing."""
    _check_bins(bins)
    lead = bins.shape[:-2]
    if weights.dtype != torch.float32 or tuple(weights.shape) != (
            *lead, NBINS):
        raise ValueError(f"weights must be {(*lead, NBINS)} float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    n = bins.shape[0] if lead else 1
    return pdf_bins(bins.reshape(n, bins.shape[-2] * bins.shape[-1])
                    .contiguous(),
                    weights.reshape(n, NBINS).contiguous()).view(bins.shape)
