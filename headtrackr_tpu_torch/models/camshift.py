"""Camshift tracker over a batch of streams: histogram, backprojection, mean shift.

Behavior spec: src/camshift.js (see headtrackr_tpu/oracle/camshift.py); the
counterpart of headtrackr_tpu/models/camshift.py with the stream axis written
out.  Per frame: the current full-frame 4096-bin histogram (CUDA kernel
``hist4096`` on the card), ratio weights, the backprojection (CUDA kernel
``backproject``), <= 10 mean-shift iterations with the fixed-point freeze,
then size and orientation from the central moments.

* First moments come from 1-D marginal prefix sums (cumsum, a fixed-order
  scan; no float atomics), window-relative like the reference package.
* The JS NaN-mediated loss (zero backprojection mass => 0-size box,
  src/camshift.js:109,240-241) is explicit zero-mass logic.
* JS ``(v) >> 0`` (truncate toward zero, NaN -> 0) is ``_js_shift``, with
  the ``isfinite`` guard: a NaN cast to int is backend-dependent.
"""

import math
from typing import NamedTuple

import torch

from ..kernels.histpdf import backproject
from ..ops.histogram import (NBINS, backprojection_weights, histogram_full,
                             histogram_rect)

__all__ = ["CamshiftState", "init_state", "init_tracker", "track",
           "mean_shift", "MEANSHIFT_ITERS"]

MEANSHIFT_ITERS = 10  # src/camshift.js:277

_F32 = torch.float32
_I32 = torch.int32


class CamshiftState(NamedTuple):
    model_hist: torch.Tensor    # (N, 4096) f32
    window: torch.Tensor        # (N, 4) i32: x, y, width, height (JS ints)
    track_x: torch.Tensor       # (N,) i32 center x (JS Math.floor result)
    track_y: torch.Tensor       # (N,) i32
    track_w: torch.Tensor       # (N,) i32 (JS << 2 result)
    track_h: torch.Tensor       # (N,) i32
    track_angle: torch.Tensor   # (N,) f32 radians


def init_state(n, device):
    z = torch.zeros((n,), dtype=_I32, device=device)
    return CamshiftState(
        model_hist=torch.zeros((n, NBINS), dtype=_F32, device=device),
        window=torch.zeros((n, 4), dtype=_I32, device=device),
        track_x=z, track_y=z.clone(), track_w=z.clone(), track_h=z.clone(),
        track_angle=torch.zeros((n,), dtype=_F32, device=device))


def init_tracker(frames, rects):
    """VJ -> CS handoff (src/camshift.js:198-211): model histogram of each
    stream's crop.  rects: (N, 4) i32 [x, y, w, h], already floored by the
    caller (src/facetrackr.js:101-106)."""
    rects = rects.to(_I32).contiguous()
    z = torch.zeros((rects.shape[0],), dtype=_I32, device=rects.device)
    return CamshiftState(
        model_hist=histogram_rect(frames, rects), window=rects,
        track_x=z, track_y=z.clone(), track_w=z.clone(), track_h=z.clone(),
        track_angle=torch.zeros((rects.shape[0],), dtype=_F32,
                                device=rects.device))


def _js_shift(v):
    """JS ``v >> 0``: truncate toward zero; NaN/Inf -> 0."""
    ok = torch.isfinite(v)
    return torch.where(ok, torch.trunc(torch.where(ok, v, 0.0)),
                       0.0).to(_I32)


def _gather_rows(plane, idx):
    """plane (N, R, C), idx (N,) -> (N, C) rows plane[n, idx[n]]."""
    N, _, C = plane.shape
    return torch.gather(plane, 1, idx.view(N, 1, 1).expand(N, 1, C).long())[:, 0]


def _gather_cols(plane, idx):
    """plane (N, R, C), idx (N,) -> (N, R) columns plane[n, :, idx[n]]."""
    N, R, _ = plane.shape
    return torch.gather(plane, 2, idx.view(N, 1, 1).expand(N, R, 1).long())[..., 0]


def _second_moments(pdf, wadx, wady, wadw, wadh):
    """One masked full-frame pass for m11/m20/m02 of the final window (the JS
    computes second moments only at the stopping iteration,
    src/camshift.js:291,300)."""
    N, H, W = pdf.shape
    rows = torch.arange(H, device=pdf.device).view(1, H, 1)
    cols = torch.arange(W, device=pdf.device).view(1, 1, W)
    v = lambda t: t.view(N, 1, 1)  # noqa: E731
    inside = ((rows >= v(wady)) & (rows < v(wadh)) &
              (cols >= v(wadx)) & (cols < v(wadw)))
    w = torch.where(inside, pdf, 0.0)
    vx = (cols - v(wadx)).to(_F32)
    vy = (rows - v(wady)).to(_F32)
    m11 = (vx * vy * w).sum(dim=(1, 2))
    m20 = (vx * vx * w).sum(dim=(1, 2))
    m02 = (vy * vy * w).sum(dim=(1, 2))
    return m11, m20, m02


def mean_shift(pdf, window):
    """Full-frame mean shift (src/camshift.js:261-312) for every stream.

    pdf (N, H, W) f32, window (N, 4) i32.  Returns (window', moments dict at
    the stopping iteration, zero_mass flag (N,))."""
    N, H, W = pdf.shape
    dev = pdf.device
    # marginal prefix sums: col_cum[n, y, x] = sum_{y' < y} pdf[n, y', x]
    col_cum = torch.nn.functional.pad(torch.cumsum(pdf, dim=1), (0, 0, 1, 0))
    row_cum = torch.nn.functional.pad(torch.cumsum(pdf, dim=2), (1, 0))
    xs = torch.arange(W, device=dev).view(1, W)
    ys = torch.arange(H, device=dev).view(1, H)

    win = window.clone()
    prevx, prevy = win[:, 0].clone(), win[:, 1].clone()
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    zf = torch.zeros((N,), dtype=_F32, device=dev)
    m00, m10, m01 = zf, zf.clone(), zf.clone()
    zi = torch.zeros((N,), dtype=_I32, device=dev)
    wad = (zi, zi, zi, zi)
    for _ in range(MEANSHIFT_ITERS):
        wadx = torch.clamp(win[:, 0], min=0)
        wady = torch.clamp(win[:, 1], min=0)
        wadw = torch.clamp(wadx + win[:, 2], max=W)
        wadh = torch.clamp(wady + win[:, 3], max=H)
        bx0, by0 = torch.clamp(wadx, 0, W), torch.clamp(wady, 0, H)
        bx1, by1 = torch.clamp(wadw, 0, W), torch.clamp(wadh, 0, H)
        empty = (bx1 <= bx0) | (by1 <= by0)
        colmass = _gather_rows(col_cum, by1) - _gather_rows(col_cum, by0)
        rowmass = _gather_cols(row_cum, bx1) - _gather_cols(row_cum, bx0)
        in_x = ((xs >= bx0[:, None]) & (xs < bx1[:, None])).to(_F32)
        in_y = ((ys >= by0[:, None]) & (ys < by1[:, None])).to(_F32)
        n00 = (colmass * in_x).sum(dim=1)
        n10 = ((xs - bx0[:, None]).to(_F32) * colmass * in_x).sum(dim=1)
        n01 = ((ys - by0[:, None]).to(_F32) * rowmass * in_y).sum(dim=1)
        n00 = torch.where(empty, 0.0, n00)
        n10 = torch.where(empty, 0.0, n10)
        n01 = torch.where(empty, 0.0, n01)
        nonzero = n00 > 0
        safe = torch.clamp(n00, min=1e-30)
        xc = torch.where(nonzero, n10 / safe, math.nan)
        yc = torch.where(nonzero, n01 / safe, math.nan)
        newx = win[:, 0] + _js_shift(xc - win[:, 2].to(_F32) / 2)
        newy = win[:, 1] + _js_shift(yc - win[:, 3].to(_F32) / 2)
        fixed = (newx == prevx) & (newy == prevy)
        # freeze after done: keep the previous window, moments and bounds
        keep = lambda old, new: torch.where(done, old, new)  # noqa: E731
        m00, m10, m01 = keep(m00, n00), keep(m10, n10), keep(m01, n01)
        wad = tuple(keep(o, n) for o, n in zip(wad, (bx0, by0, bx1, by1)))
        win = torch.stack([keep(win[:, 0], newx), keep(win[:, 1], newy),
                           win[:, 2], win[:, 3]], dim=1)
        prevx, prevy = keep(prevx, newx), keep(prevy, newy)
        done = done | fixed

    win = torch.stack([torch.clamp(win[:, 0], 0, W), torch.clamp(win[:, 1], 0, H),
                       win[:, 2], win[:, 3]], dim=1)
    m11, m20, m02 = _second_moments(pdf, *wad)
    nonzero = m00 > 0
    inv = torch.where(nonzero, 1.0 / torch.clamp(m00, min=1e-30), math.inf)
    xc = m10 * inv
    yc = m01 * inv
    mom = dict(m00=m00, m10=m10, m01=m01, m11=m11, m20=m20, m02=m02,
               invM00=inv, xc=xc, yc=yc,
               mu20=m20 - m10 * xc, mu02=m02 - m01 * yc,
               mu11=m11 - m01 * xc)  # JS quirk: m01 * xc (src/camshift.js:118)
    return win, mom, ~nonzero


def _sqrt_shl2(v, bad):
    """JS ``Math.sqrt(v) << 2``: trunc(sqrt(v)) * 4; NaN (v<0 or zero-mass) -> 0."""
    ok = (~bad) & (v >= 0) & torch.isfinite(v)
    r = torch.sqrt(torch.clamp(v, min=0.0))
    return torch.where(ok, torch.trunc(r) * 4, 0.0).to(_I32)


def _finish(state, win, m, zero_mass, calc_angles, H, W):
    """Size/orientation from central moments + output box + 1.1x window
    growth (src/camshift.js:230-258)."""
    a = m["mu20"] * m["invM00"]
    c = m["mu02"] * m["invM00"]
    if calc_angles:
        b = m["mu11"] * m["invM00"]
        d = a + c
        e = torch.sqrt((4 * b * b) + ((a - c) * (a - c)))
        tw = _sqrt_shl2((d - e) * 0.5, zero_mass)
        th = _sqrt_shl2((d + e) * 0.5, zero_mass)
        ang = torch.atan2(2 * b, a - c + e)
        ang = torch.where(ang < 0, ang + math.pi, ang)
        ang = torch.where(zero_mass, math.nan, ang)
    else:
        tw = _sqrt_shl2(a, zero_mass)
        th = _sqrt_shl2(c, zero_mass)
        ang = torch.full_like(a, math.pi / 2)

    fw = win[:, 2].to(_F32)
    fh = win[:, 3].to(_F32)
    tx = torch.floor(torch.clamp(win[:, 0].to(_F32) + fw / 2, 0, W)).to(_I32)
    ty = torch.floor(torch.clamp(win[:, 1].to(_F32) + fh / 2, 0, H)).to(_I32)
    new_w = torch.floor(1.1 * tw.to(_F32)).to(_I32)
    new_h = torch.floor(1.1 * th.to(_F32)).to(_I32)
    win = torch.stack([win[:, 0], win[:, 1], new_w, new_h], dim=1)
    return state._replace(window=win, track_x=tx, track_y=ty,
                          track_w=tw, track_h=th, track_angle=ang.to(_F32))


def track(state, frames, calc_angles=True):
    """One camshift frame step for every stream (src/camshift.js:213-259).

    frames (N, H, W, 3) u8.  Returns (new state, full-frame pdf (N, H, W))."""
    H, W = frames.shape[1], frames.shape[2]
    cur = histogram_full(frames)
    weights = backprojection_weights(state.model_hist, cur)
    pdf = backproject(frames, weights)
    win, m, zero_mass = mean_shift(pdf, state.window)
    return _finish(state, win, m, zero_mass, calc_angles, H, W), pdf
