"""Image primitives batched over streams: grayscale, whitebalance, the defined
bilinear resize, and the detection pyramid.

The same defined spec as the NumPy oracle (headtrackr_tpu/oracle/imageproc.py),
so the u8 planes are bit-exact: integer grayscale, float32 bilinear with
half-pixel centers computed as separate multiplies and adds (no fused
multiply-add, no ``lerp``), round half to even to u8.  The sampling grids are
computed in NumPy float32 exactly as the oracle computes them.
"""

import dataclasses
import functools
import math

import numpy as np
import torch

__all__ = ["grayscale", "whitebalance", "resize_bilinear", "build_pyramid",
           "PyramidSpec", "pyramid_spec"]


def grayscale(rgb):
    """(..., H, W, 3) u8 -> (..., H, W) u8.  Spec: (30 r + 59 g + 11 b + 50) // 100."""
    c = rgb.to(torch.int32)
    g = 30 * c[..., 0] + 59 * c[..., 1] + 11 * c[..., 2] + 50
    return torch.div(g, 100, rounding_mode="floor").to(torch.uint8)


def whitebalance(rgb):
    """(N, H, W, 3) u8 -> (N,) f32 mean gray value (avgR + avgG + avgB) / 3.
    src/whitebalance.js:17-28.  The channel sums are exact in f64 (as the
    JS numbers are), so a stream's value is the same in any batch and in
    any reduction order; it is rounded once to f32."""
    m = rgb.sum(dim=(-3, -2), dtype=torch.float64) / (
        rgb.shape[-3] * rgb.shape[-2])
    return ((m[..., 0] + m[..., 1] + m[..., 2]) / 3.0).to(torch.float32)


@functools.lru_cache(maxsize=256)
def _grid(sx, sy, sw, sh, dw, dh):
    """Sampling grid of the defined drawImage: indices and f32 weights."""
    rx = np.float32(sw) / np.float32(dw)
    ry = np.float32(sh) / np.float32(dh)
    u = np.arange(dw, dtype=np.float32)
    v = np.arange(dh, dtype=np.float32)
    xs = np.clip(np.float32(sx) + (u + np.float32(0.5)) * rx - np.float32(0.5),
                 sx, sx + sw - 1)
    ys = np.clip(np.float32(sy) + (v + np.float32(0.5)) * ry - np.float32(0.5),
                 sy, sy + sh - 1)
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    x1 = np.minimum(x0 + 1, sx + sw - 1)
    y1 = np.minimum(y0 + 1, sy + sh - 1)
    fx = (xs - x0.astype(np.float32)).astype(np.float32)
    fy = (ys - y0.astype(np.float32)).astype(np.float32)
    return x0, x1, y0, y1, fx, (1 - fx).astype(np.float32), fy, \
        (1 - fy).astype(np.float32)


@functools.lru_cache(maxsize=512)
def _grid_on(sx, sy, sw, sh, dw, dh, device):
    return tuple(torch.as_tensor(a).to(device)
                 for a in _grid(sx, sy, sw, sh, dw, dh))


def resize_bilinear(src, sx, sy, sw, sh, dw, dh, out_w, out_h):
    """Defined drawImage replacement, batched: src (N, H, W) u8 -> (N, out_h,
    out_w) u8 with [0:dh, 0:dw] filled and the rest zero.  Geometry args are
    Python ints."""
    N = src.shape[0]
    out = torch.zeros((N, out_h, out_w), dtype=torch.uint8, device=src.device)
    if dw <= 0 or dh <= 0 or sw <= 0 or sh <= 0:
        return out
    x0, x1, y0, y1, fx, gx, fy, gy = _grid_on(sx, sy, sw, sh, dw, dh,
                                              src.device)
    s = src.to(torch.float32)
    r0 = s.index_select(1, y0)
    r1 = s.index_select(1, y1)
    top = r0.index_select(2, x0) * gx + r0.index_select(2, x1) * fx
    bot = r1.index_select(2, x0) * gx + r1.index_select(2, x1) * fx
    val = top * gy[:, None] + bot * fy[:, None]
    out[:, :dh, :dw] = torch.round(torch.clamp(val, 0, 255)).to(torch.uint8)
    return out


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static pyramid geometry for a given input size (src/ccv.js:110-147)."""
    w0: int
    h0: int
    interval: int
    scale: float
    scale_upto: int
    next: int
    dims: tuple  # dims[i] = (i, (w, h)) for level i

    def plane_key(self, i, q=0):
        """The JS ``pyr`` index of level i's plane q (src/ccv.js:131-147)."""
        return i * 4 + q


@functools.lru_cache(maxsize=32)
def pyramid_spec(w0, h0, interval=5):
    scale = 2.0 ** (1.0 / (interval + 1))
    next_ = interval + 1
    scale_upto = int(math.floor(math.log(24.0) / math.log(scale)))
    dims = {0: (w0, h0)}
    for i in range(1, interval + 1):
        dims[i] = (max(1, int(math.floor(w0 / scale ** i))),
                   max(1, int(math.floor(h0 / scale ** i))))
    for i in range(next_, scale_upto + next_ * 2):
        pw, ph = dims[i - next_]
        dims[i] = (max(1, pw // 2), max(1, ph // 2))
    return PyramidSpec(w0, h0, interval, scale, scale_upto, next_,
                       tuple(sorted(dims.items())))


def build_pyramid(gray, interval=5):
    """gray: (N, H, W) u8 -> (dict plane_key -> (N, h, w) u8, PyramidSpec).

    Plane keys follow the JS ``pyr`` indexing: ``i*4 + q``; q in {1,2,3} are the
    shifted half-scale variants built for i >= 2*(interval+1) (src/ccv.js:131-147).
    """
    _, h0, w0 = gray.shape
    spec = pyramid_spec(w0, h0, interval)
    dims = dict(spec.dims)
    next_ = spec.next

    key = spec.plane_key
    pyr = {0: gray}
    for i in range(1, interval + 1):
        w, h = dims[i]
        pyr[key(i)] = resize_bilinear(gray, 0, 0, w0, h0, w, h, w, h)
    for i in range(next_, spec.scale_upto + next_ * 2):
        src = pyr[key(i - next_)]
        sh_, sw_ = src.shape[1:]
        w, h = dims[i]
        pyr[key(i)] = resize_bilinear(src, 0, 0, sw_, sh_, w, h, w, h)
    for i in range(next_ * 2, spec.scale_upto + next_ * 2):
        src = pyr[key(i - next_)]
        sh_, sw_ = src.shape[1:]
        w, h = dims[i]
        pyr[key(i, 1)] = resize_bilinear(src, 1, 0, sw_ - 1, sh_, w - 2, h, w, h)
        pyr[key(i, 2)] = resize_bilinear(src, 0, 1, sw_, sh_ - 1, w, h - 2, w, h)
        pyr[key(i, 3)] = resize_bilinear(src, 1, 1, sw_ - 1, sh_ - 1, w - 2, h - 2, w, h)
    return pyr, spec
