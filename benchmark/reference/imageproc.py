"""Pixel-level primitives: grayscale, whitebalance, defined bilinear resampler, pyramid.

Reference behavior being specified:
  - grayscale:     src/ccv.js:22-32
  - whitebalance:  src/whitebalance.js:5-29
  - pyramid:       src/ccv.js:113-147 (browser drawImage replaced by defined bilinear)

The benchmark's frozen copy of the port's NumPy oracle
(headtrackr_tpu_torch/oracle/imageproc.py): the yardstick that decides
``correct``, kept apart from the program so that no later change to the
program changes it.  It imports numpy alone.
"""

import numpy as np

__all__ = ["grayscale", "whitebalance", "draw_image", "build_pyramid", "pyramid_dims"]


def grayscale(rgb, mode="spec"):
    """RGB (H, W, 3) u8 -> grayscale (H, W) u8.

    mode="spec":  framework spec, integer-exact: (30 r + 59 g + 11 b + 50) // 100.
    mode="js64":  emulates src/ccv.js:29 — float64 0.3/0.59/0.11 then
                  Uint8ClampedArray round-half-even.
    """
    rgb = np.asarray(rgb)
    assert rgb.dtype == np.uint8 and rgb.ndim == 3 and rgb.shape[2] >= 3
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    if mode == "spec":
        return ((30 * r + 59 * g + 11 * b + 50) // 100).astype(np.uint8)
    elif mode == "js64":
        v = r * 0.3 + g * 0.59 + b * 0.11  # float64, like JS
        # Uint8ClampedArray: clamp then round half to even.
        return np.rint(np.clip(v, 0, 255)).astype(np.uint8)
    raise ValueError(mode)


def whitebalance(rgb):
    """Mean gray value (avgR + avgG + avgB) / 3 of an RGB u8 frame.

    src/whitebalance.js:17-28.
    """
    rgb = np.asarray(rgb, dtype=np.float64)
    return float((rgb[..., 0].mean() + rgb[..., 1].mean() + rgb[..., 2].mean()) / 3.0)


def draw_image(src, sx, sy, sw, sh, dw, dh, out_w, out_h):
    """Defined replacement for ctx.drawImage(src, sx, sy, sw, sh, 0, 0, dw, dh)
    onto a fresh (out_h, out_w) canvas.

    Bilinear with half-pixel centers, weights computed in float32, sample coords
    clamped to the source region, rounded half-to-even to u8.  Pixels outside the
    destination rect [0:dh, 0:dw] stay 0 (fresh canvas).
    """
    src = np.asarray(src)
    assert src.dtype == np.uint8 and src.ndim == 2
    out = np.zeros((out_h, out_w), np.uint8)
    if dw <= 0 or dh <= 0 or sw <= 0 or sh <= 0:
        return out
    sxf = np.float32(sx)
    syf = np.float32(sy)
    rx = np.float32(sw) / np.float32(dw)
    ry = np.float32(sh) / np.float32(dh)

    u = np.arange(dw, dtype=np.float32)
    v = np.arange(dh, dtype=np.float32)
    xs = sxf + (u + np.float32(0.5)) * rx - np.float32(0.5)
    ys = syf + (v + np.float32(0.5)) * ry - np.float32(0.5)
    xs = np.clip(xs, sx, sx + sw - 1)
    ys = np.clip(ys, sy, sy + sh - 1)

    x0 = np.floor(xs).astype(np.int32)
    y0 = np.floor(ys).astype(np.int32)
    x1 = np.minimum(x0 + 1, sx + sw - 1)
    y1 = np.minimum(y0 + 1, sy + sh - 1)
    fx = (xs - x0.astype(np.float32)).astype(np.float32)
    fy = (ys - y0.astype(np.float32)).astype(np.float32)

    s = src.astype(np.float32)
    top = s[np.ix_(y0, x0)] * (1 - fx)[None, :] + s[np.ix_(y0, x1)] * fx[None, :]
    bot = s[np.ix_(y1, x0)] * (1 - fx)[None, :] + s[np.ix_(y1, x1)] * fx[None, :]
    val = top * (1 - fy)[:, None] + bot * fy[:, None]
    out[:dh, :dw] = np.rint(np.clip(val, 0, 255)).astype(np.uint8)
    return out


def pyramid_dims(w0, h0, interval):
    """Dims of every pyramid plane, mirroring the canvas sizes in src/ccv.js:113-147.

    Returns a dict: level index i (0..scale_upto + 2*(interval+1) - 1) -> (w, h).
    Dims are clamped to >= 1 (the browser would throw on a 0-size canvas; deviation).
    """
    scale = 2.0 ** (1.0 / (interval + 1))
    next_ = interval + 1
    scale_upto = int(np.floor(np.log(24.0) / np.log(scale)))  # cascade is 24x24
    dims = {0: (w0, h0)}
    for i in range(1, interval + 1):
        dims[i] = (max(1, int(np.floor(w0 / scale ** i))),
                   max(1, int(np.floor(h0 / scale ** i))))
    for i in range(next_, scale_upto + next_ * 2):
        pw, ph = dims[i - next_]
        dims[i] = (max(1, pw // 2), max(1, ph // 2))
    return dims, scale, scale_upto, next_


def build_pyramid(gray, interval=5):
    """Build the detection pyramid exactly like src/ccv.js:113-147, with the defined
    resampler.  Returns dict keyed by ``i * 4 + q`` like the JS ``pyr`` array:
      q=0 for all levels; q in {1,2,3} only for i >= 2*(interval+1)
      (half-scale resamples shifted by (1,0), (0,1), (1,1) source pixels).
    """
    gray = np.asarray(gray)
    assert gray.dtype == np.uint8 and gray.ndim == 2
    h0, w0 = gray.shape
    dims, scale, scale_upto, next_ = pyramid_dims(w0, h0, interval)

    pyr = {0: gray}
    for i in range(1, interval + 1):
        w, h = dims[i]
        pyr[i * 4] = draw_image(gray, 0, 0, w0, h0, w, h, w, h)
    for i in range(next_, scale_upto + next_ * 2):
        src = pyr[(i - next_) * 4]
        sh_, sw_ = src.shape
        w, h = dims[i]
        pyr[i * 4] = draw_image(src, 0, 0, sw_, sh_, w, h, w, h)
    for i in range(next_ * 2, scale_upto + next_ * 2):
        src = pyr[(i - next_) * 4]
        sh_, sw_ = src.shape
        w, h = dims[i]
        # src/ccv.js:131-147 — shifted half-scale variants; note the shrunken
        # destination rects (w-2 / h-2) leaving zero-filled borders.
        pyr[i * 4 + 1] = draw_image(src, 1, 0, sw_ - 1, sh_, w - 2, h, w, h)
        pyr[i * 4 + 2] = draw_image(src, 0, 1, sw_, sh_ - 1, w, h - 2, w, h)
        pyr[i * 4 + 3] = draw_image(src, 1, 1, sw_ - 1, sh_ - 1, w - 2, h - 2, w, h)
    pyr[0] = gray
    return pyr, scale, scale_upto, next_
