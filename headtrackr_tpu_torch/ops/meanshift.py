"""The plain PyTorch twin of the ``meanshift`` CUDA kernel
(kernels/meanshift.py, csrc/meanshift.cu): the same function, in the same
floating-point order, used for CPU tensors and as the kernel's reference on
the card.

The order is written out, so that the twin gives the same bits on the CPU
and on the card, and the kernel gives the twin's bits:

  * Prefix sums are f64 running sums in index order, each stored rounded
    to f32: one elementwise f64 add a row (column sums) or a column (row
    sums), ``acc[y] = acc[y - 1] + pdf[y]`` from ``acc[-1] = 0``, and
    ``C[y] = f32(acc[y])``.  That is what the CPU's ``torch.cumsum`` of
    f32 does (1 then four 2**-25 sum to 1 + 2**-23, where an f32 running
    sum stays at 1), but ``torch.cumsum`` on the card accumulates in f32
    in a parallel order, so the twin writes the loop out.
  * Every reduction is ``tree_sum``: zero-padded to a power of two, then
    adjacent pairs added level by level.  Not ``torch.sum``, whose order
    differs between the devices.  The first moments sum their f32 terms in
    f32.  The second moments sum their f32 terms in f64, each row over x,
    then the row sums over y, and round once: they feed the central
    moments' differences of near-equal terms (mu11 = m11 - m01 * xc), where
    an f32 sum's rounding moved the angle by 1e-5 on the band tests.
  * Every product, difference and quotient is its own f32 operation (no
    fused multiply-add; IEEE division, F6).
"""

import math

import torch
import torch.nn.functional as F

__all__ = ["mean_shift_plain", "prefix_planes", "tree_sum", "MOMENTS",
           "MEANSHIFT_ITERS"]

MEANSHIFT_ITERS = 10  # src/camshift.js:277
# the moments dict's keys, in the kernel's output order
MOMENTS = ("m00", "m10", "m01", "m11", "m20", "m02", "invM00", "xc", "yc",
           "mu20", "mu02", "mu11")

_F32 = torch.float32
_I32 = torch.int32
_TINY = 1e-30  # the divisor's floor (the reference's jnp.maximum(m00, 1e-30))


def tree_sum(v):
    """Sum over the last axis in a fixed order: zero-pad its length to the
    next power of two, then add adjacent pairs, ``v[2i] + v[2i+1]``, level
    by level down to one value."""
    n = v.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        v = F.pad(v, (0, p - n))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def prefix_planes(pdf):
    """(col_cum (N, bh+1, bw), row_cum (N, bh, bw+1)) of a (N, bh, bw) pdf:
    col_cum[n, y, x] = sum of pdf[n, :y, x], row_cum[n, y, x] = sum of
    pdf[n, y, :x], each an f64 running sum in index order rounded to
    f32."""
    N, bh, bw = pdf.shape
    acc = torch.zeros((N, bw), dtype=torch.float64, device=pdf.device)
    cols = [acc.to(_F32)]
    for y in range(bh):
        acc = acc + pdf[:, y]
        cols.append(acc.to(_F32))
    acc = torch.zeros((N, bh), dtype=torch.float64, device=pdf.device)
    rows = [acc.to(_F32)]
    for x in range(bw):
        acc = acc + pdf[:, :, x]
        rows.append(acc.to(_F32))
    return torch.stack(cols, 1), torch.stack(rows, 2)


def _js_shift(v):
    """JS ``v >> 0``: truncate toward zero; NaN/Inf -> 0 (F3)."""
    ok = torch.isfinite(v)
    return torch.where(ok, torch.trunc(torch.where(ok, v, 0.0)),
                       0.0).to(_I32)


def _second_moments(pdf, wadx, wady, wadw, wadh):
    """m11/m20/m02 over the frozen window [wadx, wadw) x [wady, wadh) (band
    coordinates; the JS takes second moments only at the stopping
    iteration, src/camshift.js:291,300): each row's f32 terms summed over x
    in f64, then the rows over y in f64, both by ``tree_sum``, rounded to
    f32 once."""
    N, bh, bw = pdf.shape
    rows = torch.arange(bh, device=pdf.device).view(1, bh, 1)
    cols = torch.arange(bw, device=pdf.device).view(1, 1, bw)
    v = lambda t: t.view(N, 1, 1)  # noqa: E731
    inside = ((rows >= v(wady)) & (rows < v(wadh)) &
              (cols >= v(wadx)) & (cols < v(wadw)))
    vx = (cols - v(wadx)).to(_F32)
    vy = (rows - v(wady)).to(_F32)

    def total(weight):  # f32 terms, summed in f64, rounded once
        terms = torch.where(inside, weight * pdf, 0.0).to(torch.float64)
        return tree_sum(tree_sum(terms)).to(_F32)

    return total(vx * vy), total(vx * vx), total(vy * vy)


def mean_shift_plain(pdf, window, ry=None, rx=None, frame_shape=None):
    """<= 10 mean-shift iterations (src/camshift.js:261-312) for every
    stream: ``models/camshift.mean_shift``'s contract, which is the JAX
    package's ``_mean_shift_core`` with the stream axis written out.

    pdf (N, bh, bw) f32 covers frame rows [ry, ry+bh) x cols [rx, rx+bw)
    (ry, rx (N,) i32; the full frame when they are None), window (N, 4) i32
    [x, y, w, h], frame_shape (H, W) (default: the pdf's).  Window
    arithmetic stays in frame coordinates; the moments are taken in band
    coordinates, relative to the window's clipped origin.

    Per iteration, while the stream is not done: the window clamped to
    the frame, moved into the band and clipped to [0, bw] x [0, bh] (an
    escape when it had to be clipped); an empty window has zero moments;
    m00 = tree_sum(colmass over the window's columns), m10 = tree_sum((x -
    x0) * colmass), m01 = tree_sum((y - y0) * rowmass), with colmass and
    rowmass differences of the prefix sums at the window's edges; the
    centroid by IEEE division (NaN at zero mass, which ``_js_shift`` turns
    into no move, F3); done when the window did not move.  After the loop:
    x clamped to [0, W], y to [0, H]; second moments over the stopping
    iteration's window.

    Returns (window' (N, 4) i32, moments {MOMENTS: (N,) f32}, zero_mass
    (N,) bool, escaped (N,) bool), with the JS quirk mu11 = m11 - m01 * xc
    (src/camshift.js:118)."""
    N, bh, bw = pdf.shape
    H, W = frame_shape if frame_shape is not None else (bh, bw)
    dev = pdf.device
    banded = ry is not None  # the full frame needs no offsets or escape test
    col_cum, row_cum = prefix_planes(pdf)
    xs = torch.arange(bw, device=dev).view(1, bw)
    ys = torch.arange(bh, device=dev).view(1, bh)
    # bounds made on the device by fill_ (a host-to-device copy would
    # synchronize, and a CUDA graph cannot capture it)
    frame_hi = torch.full((2,), W, dtype=_I32, device=dev)
    frame_hi[1:].fill_(H)
    band_hi = torch.full((4,), bw, dtype=_I32, device=dev)
    band_hi[1::2].fill_(bh)
    if banded:
        origin = torch.stack([rx, ry, rx, ry], 1)

    win = window.clone()
    prevx, prevy = win[:, 0].clone(), win[:, 1].clone()
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    esc = torch.zeros((N,), dtype=torch.bool, device=dev)
    zf = torch.zeros((N,), dtype=_F32, device=dev)
    m00, m10, m01 = zf, zf.clone(), zf.clone()
    wad = torch.zeros((N, 4), dtype=_I32, device=dev)  # frozen bounds
    for _ in range(MEANSHIFT_ITERS):
        lo = torch.clamp(win[:, :2], min=0)
        bounds = torch.cat([lo, torch.minimum(lo + win[:, 2:], frame_hi)], 1)
        if banded:
            bounds = bounds - origin
            esc = esc | (~done & ((bounds[:, :2] < 0) |
                                  (bounds[:, 2:] > band_hi[2:])).any(1))
        bounds = torch.minimum(torch.clamp(bounds, min=0), band_hi)
        bx0, by0, bx1, by1 = bounds.unbind(1)
        empty = (bx1 <= bx0) | (by1 <= by0)
        ys2 = bounds[:, 1::2].long().view(N, 2, 1)
        xs2 = bounds[:, 0::2].long().view(N, 1, 2)
        rows2 = torch.take_along_dim(col_cum, ys2, 1)   # (N, 2, bw)
        cols2 = torch.take_along_dim(row_cum, xs2, 2)   # (N, bh, 2)
        colmass = rows2[:, 1] - rows2[:, 0]
        rowmass = cols2[..., 1] - cols2[..., 0]
        in_x = (xs >= bx0[:, None]) & (xs < bx1[:, None])
        in_y = (ys >= by0[:, None]) & (ys < by1[:, None])
        vx = (xs - bx0[:, None]).to(_F32)
        vy = (ys - by0[:, None]).to(_F32)
        n00 = tree_sum(torch.where(in_x, colmass, 0.0))
        n10 = tree_sum(torch.where(in_x, vx * colmass, 0.0))
        n01 = tree_sum(torch.where(in_y, vy * rowmass, 0.0))
        n00 = torch.where(empty, 0.0, n00)
        n10 = torch.where(empty, 0.0, n10)
        n01 = torch.where(empty, 0.0, n01)
        nonzero = n00 > 0
        safe = torch.clamp(n00, min=_TINY)
        xc = torch.where(nonzero, n10 / safe, math.nan)
        yc = torch.where(nonzero, n01 / safe, math.nan)
        newx = win[:, 0] + _js_shift(xc - win[:, 2].to(_F32) / 2)
        newy = win[:, 1] + _js_shift(yc - win[:, 3].to(_F32) / 2)
        fixed = (newx == prevx) & (newy == prevy)
        # freeze after done: keep the previous window, moments and bounds
        keep = lambda old, new: torch.where(done, old, new)  # noqa: E731
        m00, m10, m01 = keep(m00, n00), keep(m10, n10), keep(m01, n01)
        wad = torch.where(done[:, None], wad, bounds)
        win = torch.stack([keep(win[:, 0], newx), keep(win[:, 1], newy),
                           win[:, 2], win[:, 3]], dim=1)
        prevx, prevy = keep(prevx, newx), keep(prevy, newy)
        done = done | fixed

    win = torch.stack([torch.clamp(win[:, 0], 0, W),
                       torch.clamp(win[:, 1], 0, H), win[:, 2], win[:, 3]],
                      dim=1)
    m11, m20, m02 = _second_moments(pdf, *wad.unbind(1))
    nonzero = m00 > 0
    inv = torch.where(nonzero, 1.0 / torch.clamp(m00, min=_TINY), math.inf)
    xc = m10 * inv
    yc = m01 * inv
    mom = dict(m00=m00, m10=m10, m01=m01, m11=m11, m20=m20, m02=m02,
               invM00=inv, xc=xc, yc=yc,
               mu20=m20 - m10 * xc, mu02=m02 - m01 * yc,
               mu11=m11 - m01 * xc)  # JS quirk: m01 * xc (src/camshift.js:118)
    return win, mom, ~nonzero, esc
