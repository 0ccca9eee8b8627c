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

__all__ = ["grayscale", "whitebalance", "channel_sums", "frame_shares",
           "frame_prep_plain", "slot_rows",
           "PWB_LENGTH", "resize_bilinear", "build_pyramid",
           "PyramidSpec", "pyramid_spec", "pack_pyramid", "PyramidPlan",
           "pyramid_plan"]


def grayscale(rgb):
    """(..., H, W, 3) u8 -> (..., H, W) u8.  Spec: (30 r + 59 g + 11 b + 50) // 100,
    exact in int16 (at most 25,550), so that a large batch's temporaries
    take 2 bytes a channel, not 4."""
    c = rgb.to(torch.int16)
    g = 30 * c[..., 0] + 59 * c[..., 1] + 11 * c[..., 2] + 50
    return torch.div(g, 100, rounding_mode="floor").to(torch.uint8)


# the most bytes of the integer copy a whitebalance slice of streams makes
# (a batch past it is summed a slice at a time)
_WB_SLICE_BYTES = 1 << 28


def whitebalance(rgb):
    """(N, H, W, 3) u8 -> (N,) f32 mean gray value (avgR + avgG + avgB) / 3.
    src/whitebalance.js:17-28.  The channel sums are exact integers
    (``channel_sums``), taken to f64 (as the JS numbers are: the same
    values an f64 sum gives), so a stream's value is the same in any batch
    and in any reduction order, and a large batch needs no wide copy of
    all its frames; it is rounded once to f32."""
    H, W = rgb.shape[-3], rgb.shape[-2]
    sums = channel_sums(rgb.reshape((-1, H * W, 3)))
    return _mean_gray(sums, H * W).reshape(rgb.shape[:-3])


def channel_sums(px):
    """(N, M, 3) u8 -> (N, 3) i64 exact channel sums, made in int32 where
    255 M fits it (else int64) over slices of streams whose integer copy
    stays within _WB_SLICE_BYTES."""
    N, M = px.shape[0], px.shape[1]
    dt = torch.int32 if 255 * M < 2 ** 31 else torch.int64
    step = max(1, _WB_SLICE_BYTES // max(1, 3 * M * dt.itemsize))
    if N > step:
        sums = torch.cat([px[s:s + step].sum(dim=1, dtype=dt)
                          for s in range(0, N, step)])
    else:
        sums = px.sum(dim=1, dtype=dt)
    return sums.to(torch.int64)


def _mean_gray(sums, npx):
    """(..., 3) i64 channel sums of npx pixels -> (...,) f32: the f64 means,
    ((m_r + m_g) + m_b) / 3, one rounding."""
    m = sums.to(torch.float64) / npx
    return ((m[..., 0] + m[..., 1] + m[..., 2]) / 3.0).to(torch.float32)


def frame_shares(hw, split):
    """The pixel ranges [a, b) of an hw-pixel frame that each of ``split``
    CTAs of the ``frame_prep`` kernel sums: ceil(units / split) units of
    16 pixels a CTA where hw % 16 == 0 (else 4 where hw % 4 == 0, else
    1; the kernel takes the same units where the frames' and gray plane's
    bases are aligned to them, narrower ones otherwise, and the sums are
    the same).  A CTA past the last unit sums none."""
    unit = 16 if hw % 16 == 0 else 4 if hw % 4 == 0 else 1
    share = -(-(hw // unit) // split) * unit
    return [(min(hw, k * share), min(hw, (k + 1) * share))
            for k in range(split)]


PWB_LENGTH = 15  # the whitebalance stability ring (src/facetrackr.js:59)
_MODE_WB, _MODE_VJ = 0, 1  # models/facetracker.py MODE_WB, MODE_VJ


def slot_rows(frames, slots):
    """``frames`` (N, ...) read through ``slots`` (S,) i64 padded with N:
    rows min(slot, N - 1) (the padding reads stream N - 1, whose result the
    caller drops); ``slots`` None: every row, in order."""
    if slots is None:
        return frames
    return frames.index_select(0, torch.clamp(slots, max=frames.shape[0] - 1))


def frame_prep_plain(frames, slots, mode, wb_ring, wb_n, gray=True,
                     wb_vj=False, split=None):
    """The ``frame_prep`` kernel's twin (kernels/frameprep.py): one pass
    over each served stream's frame, the grayscale plane and the WB
    branch of the state machine (src/facetrackr.js:79-95) in one.

    frames (N, H, W, 3) u8 read through ``slots`` (``slot_rows``); mode
    (S,) i32 the entry modes, wb_ring (S, 15) f32 and wb_n (S,) i32 the
    rows' state.  Returns (gray (S, H, W) u8 or None when ``gray`` is
    False, wb (S,) f32, wb_ring', wb_n', mode'): a stream that enters in
    WB takes the branch's new ring (its whitebalance pushed in front), n
    and mode (VJ once the full ring spans less than 2); every other stream
    keeps its rows.  wb is the frame's whitebalance where the stream enters
    in WB, or in VJ with ``wb_vj`` (the wbtrack step reports it there),
    else 0.  The whitebalance is ``whitebalance``'s: exact channel sums,
    f64 means, one f32 rounding.  As the kernel, the sums are taken over
    ``split`` shares of each frame (``frame_shares``; None: the kernel's
    ``pick_split``) and joined in order, exact, so any split gives the
    same bits."""
    rows = slot_rows(frames, slots)
    S, H, W = rows.shape[0], rows.shape[1], rows.shape[2]
    if split is None:
        from ..kernels.frameprep import pick_split
        split = pick_split(S)
    g = grayscale(rows) if gray else None
    px = rows.reshape(S, H * W, 3)
    sums = torch.zeros((S, 3), dtype=torch.int64, device=rows.device)
    for a, b in frame_shares(H * W, split):
        if b > a:
            sums += channel_sums(px[:, a:b])
    wb = _mean_gray(sums, H * W)
    is_wb = mode == _MODE_WB
    ring = torch.cat([wb[:, None], wb_ring[:, :-1]], dim=1)
    n = torch.clamp(wb_n + 1, max=PWB_LENGTH)
    stable = (n == PWB_LENGTH) & ((ring.amax(dim=1) - ring.amin(dim=1)) < 2.0)
    new_mode = torch.where(stable, _MODE_VJ, _MODE_WB).to(torch.int32)
    report = is_wb | (mode == _MODE_VJ) if wb_vj else is_wb
    return (g, torch.where(report, wb, 0.0),
            torch.where(is_wb[:, None], ring, wb_ring),
            torch.where(is_wb, n, wb_n).to(torch.int32),
            torch.where(is_wb, new_mode, mode).to(torch.int32))


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


# PyramidPlan.steps columns
(STEP_LEVEL, STEP_W, STEP_H, STEP_SW, STEP_SH, STEP_FROM, STEP_XA, STEP_YA,
 STEP_XB, STEP_YB, STEP_PLANE, STEP_INTER, STEP_SOURCE, STEP_SCR,
 STEP_COLS) = range(15)
# STEP_FROM: what a step reads
FROM_COPY, FROM_FRAME, FROM_PREV = -1, 0, 1


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    """``pack_pyramid`` as chains for the ``pyramid`` kernel.  Level i >= next
    is level i - next halved (and, from 2 next on, its shifted quarter
    variants read level i - next too), so the pyramid is ``next``
    independent chains c, c + next, c + 2 next, ... a stream; the kernel
    builds each chain's levels in order, each from the one before.

    steps (J, STEP_COLS) i32, a row a level, chain by chain
    (``chain_first``: (C + 1,) i32, chain j's rows are chain_first[j] up to
    chain_first[j + 1]): the level, its width and height, its source's
    width and height, what it reads (FROM_COPY: level 0, the frame copied;
    FROM_FRAME: a resize of the frame, levels 1..next; FROM_PREV: a resize
    of the chain's previous level), the rows of xg and yg where its grids start (A: the
    whole plane, sx = sy = 0; B: the shifted variants' sx = 1 or sy = 1, -1
    where that variant is empty), the packed offsets of its plane
    (row-major, -1: not packed) and of its interleaved quarter planes (-1:
    none), whether the next level reads it (STEP_SOURCE), and its scratch
    offset (-1: none; only a source that is not packed has one, and the
    kernel writes it there only when shared memory does not hold it).
    The quarter planes: q0 the plane itself (grids A, A), q1 (B, A),
    q2 (A, B), q3 (B, B), each filled on [0, dh) x [0, dw) and 0 beyond.
    xg/yg (X, 4) i32: a column's source columns x0, x1 and the f32 bits of
    its weights 1 - fx, fx (rows likewise), from ``_grid``, chain by chain:
    chain_grid (C, 4) i32 gives each chain's rows of xg and of yg (first,
    count); grid_bytes: the most bytes one chain's grids take (the kernel
    stages them in shared memory, beside the held levels).  S: scratch
    bytes a stream (0 for the detector's layouts: every source is packed),
    L: packed bytes.  The packed layout: plane_off[k], the offset of plane
    key k, and inter_off[i], that of scale step i's interleaved quarter
    planes (2 H2 x 2 W2, I[2a + dy, 2b + dx] = quarter_{2 dy + dx}[a, b])."""
    steps: np.ndarray
    chain_first: np.ndarray
    chain_grid: np.ndarray
    xg: np.ndarray
    yg: np.ndarray
    grid_bytes: int
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
    plane_off, inter_off = {}, {}
    off = 0
    for k in plane_keys:
        w, h = dims[k // 4]
        plane_off[k // 4] = off
        off += w * h
    for i in geom_levels:
        W2, H2 = dims[i + 2 * nxt]
        inter_off[i + 2 * nxt] = off
        off += 4 * H2 * W2
    L = off

    # the levels written, and those they read (level i reads i - next)
    needed = set(plane_off) | set(inter_off)
    for lv in sorted(needed, reverse=True):
        if lv >= nxt:
            needed.add(lv - nxt)
    xg, yg = [], []
    rows = {"x": 0, "y": 0}

    def grid(axis, s0, sn, dn):
        """The row of xg (axis "x") or yg where the grid of a resize of
        source span [s0, s0 + sn) to dn starts; -1 when it is empty."""
        if dn <= 0 or sn <= 0:
            return -1
        if axis == "x":
            a0, a1, _, _, f, g, _, _ = _grid(s0, 0, sn, 1, dn, 1)
        else:
            _, _, a0, a1, _, _, f, g = _grid(0, s0, 1, sn, 1, dn)
        (xg if axis == "x" else yg).append(np.stack(
            [a0.astype(np.int32), a1.astype(np.int32), g.view(np.int32),
             f.view(np.int32)], 1))
        row = rows[axis]
        rows[axis] += dn
        return row

    steps, chain_first, chain_grid, S = [], [], [], 0
    for c in range(nxt):
        chain = sorted(lv for lv in needed if lv % nxt == c)
        if not chain:
            continue
        chain_first.append(len(steps))
        chain_grid.append([rows["x"], 0, rows["y"], 0])
        for lv in chain:
            w, h = dims[lv]
            st = [0] * STEP_COLS
            st[STEP_LEVEL], st[STEP_W], st[STEP_H] = lv, w, h
            if lv == 0:
                st[STEP_FROM], (sw, sh) = FROM_COPY, (w0, h0)
            else:  # a level of source level 0 reads the frame itself
                st[STEP_FROM] = FROM_FRAME if lv <= nxt else FROM_PREV
                sw, sh = (w0, h0) if lv <= nxt else dims[lv - nxt]
            st[STEP_SW], st[STEP_SH] = sw, sh
            st[STEP_XA] = st[STEP_YA] = st[STEP_XB] = st[STEP_YB] = -1
            if lv:
                st[STEP_XA] = grid("x", 0, sw, w)
                st[STEP_YA] = grid("y", 0, sh, h)
            st[STEP_PLANE] = plane_off.get(lv, -1)
            st[STEP_INTER] = inter_off.get(lv, -1)
            if st[STEP_INTER] >= 0:
                st[STEP_XB] = grid("x", 1, sw - 1, w - 2)
                st[STEP_YB] = grid("y", 1, sh - 1, h - 2)
            st[STEP_SOURCE] = int(lv + nxt in needed and lv > 0)
            st[STEP_SCR] = -1
            if st[STEP_SOURCE] and st[STEP_PLANE] < 0:
                st[STEP_SCR], S = S, S + w * h
            steps.append(st)
        chain_grid[-1][1] = rows["x"] - chain_grid[-1][0]
        chain_grid[-1][3] = rows["y"] - chain_grid[-1][2]
    chain_first.append(len(steps))

    def cat(parts):
        return (np.concatenate(parts) if parts
                else np.zeros((0, 4), np.int32))

    return PyramidPlan(
        steps=np.asarray(steps, np.int32).reshape(-1, STEP_COLS),
        chain_first=np.asarray(chain_first, np.int32),
        chain_grid=np.asarray(chain_grid, np.int32).reshape(-1, 4),
        xg=cat(xg), yg=cat(yg),
        grid_bytes=16 * max((g[1] + g[3] for g in chain_grid), default=0),
        S=S, L=L,
        plane_off={lv * 4: o for lv, o in plane_off.items()},
        inter_off={lv - 2 * nxt: o for lv, o in inter_off.items()})

