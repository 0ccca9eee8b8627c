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
           "PyramidSpec", "pyramid_spec", "pack_pyramid", "PyramidPlan",
           "pyramid_plan"]


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


def pack_pyramid(gray, interval, plane_keys, geom_levels):
    """(N, H, W) u8 -> (N, L) u8: the pyramid planes ``plane_keys`` and the
    pixel-interleaved quarter planes of the scale steps ``geom_levels``,
    flat, in the detector tables' layout (models/detector.py).  The plain
    twin of the ``pyramid`` kernel (kernels/pyramid.py)."""
    N = gray.shape[0]
    if not plane_keys:  # a frame too small for any window
        return torch.zeros((N, 0), dtype=torch.uint8, device=gray.device)
    pyr, spec = build_pyramid(gray, interval)
    nxt = spec.next
    parts = [pyr[k].reshape(N, -1) for k in plane_keys]
    for i in geom_levels:
        q = torch.stack([pyr[(i + 2 * nxt) * 4 + j] for j in range(4)], dim=1)
        _, _, H2, W2 = q.shape
        inter = q.view(N, 2, 2, H2, W2).permute(0, 3, 1, 4, 2)
        parts.append(inter.reshape(N, 4 * H2 * W2))
    return torch.cat(parts, dim=1).contiguous()


# PyramidPlan.jobs columns
(JOB_SRC, JOB_SRC_W, JOB_OUT_W, JOB_OUT_H, JOB_DW, JOB_DH, JOB_XT, JOB_YT,
 JOB_DST, JOB_OFF, JOB_ROW, JOB_COL, JOB_START, JOB_COLS) = range(14)


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    """``pack_pyramid`` as jobs for the ``pyramid`` kernel: one job an output
    plane copy, each a defined resize (or, src -2, a copy of the frame)
    written to the scratch of intermediate levels (dst 0) or to the packed
    buffer (dst 1), grouped in generations that read only the frame or the
    generation before (level i reads level i - next).

    jobs (J, JOB_COLS) i32: src offset in the scratch (-1: the frame, -2:
    the frame copied), source row stride, the output plane's width and
    height, the filled [0, dh) x [0, dw) region (the rest is 0), the rows
    of xtab and ytab where its grid starts, dst, the destination offset,
    its row stride and column step (2 in the interleaved quarter planes),
    and the job's first pixel among its generation's.  xi/xf (X, 2): a
    column's source columns (x0, x1) and weights (1 - fx, fx); yi/yf
    likewise for rows, all from ``_grid``.  gens: (first job, end job,
    pixels) a generation.  S: scratch bytes a stream, L: packed bytes.
    The packed layout: plane_off[k], the offset of plane key k (row-major),
    and inter_off[i], that of scale step i's interleaved quarter planes
    (2 H2 x 2 W2, I[2a + dy, 2b + dx] = quarter_{2 dy + dx}[a, b])."""
    jobs: np.ndarray
    xi: np.ndarray
    xf: np.ndarray
    yi: np.ndarray
    yf: np.ndarray
    gens: tuple
    S: int
    L: int
    plane_off: dict
    inter_off: dict


def pyramid_plan(spec, plane_keys, geom_levels):
    """The PyramidPlan of ``pack_pyramid`` for a PyramidSpec and the
    detector tables' plane layout."""
    dims = dict(spec.dims)
    nxt = spec.next
    w0, h0 = spec.w0, spec.h0
    dests = []  # (level, q, dst, offset, row, col)
    plane_off, inter_off = {}, {}
    off = 0
    for k in plane_keys:
        w, h = dims[k // 4]
        plane_off[k] = off
        dests.append((k // 4, 0, 1, off, w, 1))
        off += w * h
    for i in geom_levels:
        W2, H2 = dims[i + 2 * nxt]
        inter_off[i] = off
        for q in range(4):
            dy, dx = divmod(q, 2)
            dests.append((i + 2 * nxt, q, 1, off + dy * 2 * W2 + dx, 4 * W2,
                          2))
        off += 4 * H2 * W2
    L = off

    # the levels other jobs read, each computed once into the scratch
    scratch, S = {}, 0
    todo = sorted({lv - nxt for (lv, *_r) in dests if lv >= nxt})
    while todo:
        lv = todo.pop()
        if lv == 0 or lv in scratch:
            continue
        w, h = dims[lv]
        scratch[lv] = S
        S += w * h
        if lv >= nxt:
            todo.append(lv - nxt)
    dests += [(lv, 0, 0, o, dims[lv][0], 1) for lv, o in scratch.items()]

    def geometry(lv, q):
        """(source level, sx, sy, sw, sh, dw, dh) of plane (lv, q)."""
        w, h = dims[lv]
        if lv <= spec.interval:
            return 0, 0, 0, w0, h0, w, h
        sw, sh = dims[lv - nxt]
        return ((lv - nxt,) + ((0, 0, sw, sh, w, h), (1, 0, sw - 1, sh, w - 2, h),
                              (0, 1, sw, sh - 1, w, h - 2),
                              (1, 1, sw - 1, sh - 1, w - 2, h - 2))[q])

    jobs, xi, xf, yi, yf, gens = [], [], [], [], [], []
    nx = ny = 0
    for g in range(max((lv for (lv, *_r) in dests), default=-1) // nxt + 1):
        first, pixels = len(jobs), 0
        for (lv, q, dst, o, row, col) in sorted(dests):
            if lv // nxt != g:
                continue
            w, h = dims[lv]
            src, sx, sy, sw, sh, dw, dh = geometry(lv, q)
            row_job = [0] * JOB_COLS
            row_job[JOB_OUT_W], row_job[JOB_OUT_H] = w, h
            row_job[JOB_DST], row_job[JOB_OFF] = dst, o
            row_job[JOB_ROW], row_job[JOB_COL] = row, col
            row_job[JOB_START] = pixels
            if lv == 0:
                row_job[JOB_SRC], row_job[JOB_SRC_W] = -2, w0
                row_job[JOB_DW], row_job[JOB_DH] = w0, h0
            else:
                row_job[JOB_SRC] = -1 if src == 0 else scratch[src]
                row_job[JOB_SRC_W] = dims[src][0]
                if dw > 0 and dh > 0 and sw > 0 and sh > 0:
                    x0, x1, y0, y1, fx, gx, fy, gy = _grid(sx, sy, sw, sh,
                                                           dw, dh)
                    row_job[JOB_DW], row_job[JOB_DH] = dw, dh
                    row_job[JOB_XT], row_job[JOB_YT] = nx, ny
                    xi.append(np.stack([x0, x1], 1))
                    xf.append(np.stack([gx, fx], 1))
                    yi.append(np.stack([y0, y1], 1))
                    yf.append(np.stack([gy, fy], 1))
                    nx += dw
                    ny += dh
            jobs.append(row_job)
            pixels += w * h
        gens.append((first, len(jobs), pixels))

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.zeros((0, 2), dtype))

    return PyramidPlan(jobs=np.asarray(jobs, np.int32).reshape(-1, JOB_COLS),
                       xi=cat(xi, np.int32), xf=cat(xf, np.float32),
                       yi=cat(yi, np.int32), yf=cat(yf, np.float32),
                       gens=tuple(gens), S=S, L=L, plane_off=plane_off,
                       inter_off=inter_off)
