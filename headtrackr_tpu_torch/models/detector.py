"""BBF cascade detector over a batch of streams: three kernels on the card.

Reference behavior: src/ccv.js:109-333.  The formulation is the oracle's
(headtrackr_tpu/oracle/detector.py): every window runs the cascade with
early exit, and the survivors go into a fixed buffer of ``k_cand`` slots a
stream (default CAPACITY, as in the reference package), the first
ones in window order; ``overflow`` counts the survivors beyond it.  Where
the reference package reports ``overflow == 0`` the candidate set is its.

On the card a detection is three kernels with no host read, so a CUDA graph
can capture it: ``pyramid`` (kernels/pyramid.py: the gray frames into the
packed plane buffer below), ``cascade`` (kernels/cascade.py: the windows
through the stages, the survivors compacted in window order) and ``group``
(kernels/group.py: the grouping below and the pick).  On the CPU each
wrapper runs its plain twin (ops/imageproc.py pack_pyramid, ops/detect.py
cascade_plain and group_plain), to the bit the kernel's results.

Window addressing.  The 4 detection phases (dx, dy in {0,1}^2) of a scale
step fold into one (2*qh, 2*qw) window grid; window (y2, x2) reads feature
pixel (px, py, z) at
    z=0: plane0[2*y2 + py, 2*x2 + px]
    z=1: plane1[y2 + py, x2 + px]
    z=2: I[y2 + 2*py, x2 + 2*px]
where I pixel-interleaves the 4 shifted quarter planes (I[2a+dy, 2b+dx] =
quarter_{2*dy+dx}[a, b]).  Each stream's planes are packed into one flat u8
buffer, so every feature read is one gather at ``base[z] + py*rowstep[z] +
px*colstep[z]`` (colstep 2 on I, else 1).  Windows are enumerated scale-major, then row-major over
(y2, x2): the candidate order of the reference package for single-chunk
cascades, which decides ties in ``detect_best``.

A weak classifier votes ``min(positive px) > max(negative px)``.  A stage sum
adds its f32 votes in f64, as the oracle does: exact in any order for these
alphas, so the stage decision is the oracle's and no reduction order can
flip it.  Confidences are kept as f32.  Box coordinates follow the
reference package for the same cascade, so ``floor(rect)`` at the handoff
matches: cascades deeper than ``CHUNK_A_END`` stages take ``2*x2`` times
the f32 scale in f32, single-chunk cascades the f64 product cast to f32.

Grouping (src/ccv.js:249-331) is connected components over each stream's
candidate slots, labelled by their smallest member slot, then member sums
(exact in f64, rounded to f32) and the containment filter.
"""

import collections
import dataclasses
import hashlib

import numpy as np
import torch

from ..cascade import ARRAY_FIELDS, cascade_to_torch
from ..device import resolve_device
from ..kernels.cascade import cascade as _cascade
from ..kernels.cascade import dense_stages
from ..kernels.group import group
from ..kernels.pyramid import pyramid
from ..ops.imageproc import pyramid_plan, pyramid_spec

__all__ = ["DetectorTables", "detector_tables", "detect_candidates",
           "group_candidates", "detect_objects_padded", "detect_best",
           "CHUNK_A_END", "CAPACITY"]

# the reference package's dense stage chunk; deeper cascades take its
# deep-path box arithmetic (see the module docstring)
CHUNK_A_END = 2
# candidate slots a stream: the reference package's k_cand (and
# maxCandidates' default)
CAPACITY = 256


@dataclasses.dataclass(frozen=True)
class _Stage:
    thresh: float
    alpha0: torch.Tensor   # (K,) f32
    alpha1: torch.Tensor   # (K,) f32
    sides: tuple           # (z, x offset, py, valid): positive, negative


@dataclasses.dataclass(frozen=True)
class _Plan:
    """ops/imageproc.py PyramidPlan (``host``) with its arrays on the
    device."""
    steps: torch.Tensor        # (J, STEP_COLS) i32, a row a level
    chain_first: torch.Tensor  # (C + 1,) i32
    chain_grid: torch.Tensor   # (C, 4) i32 a chain's xg and yg rows
    xg: torch.Tensor           # (X, 4) i32
    yg: torch.Tensor
    grid_bytes: int            # a chain's grids, staged
    chains: int                # C
    S: int                     # scratch bytes a stream
    host: object               # the PyramidPlan (NumPy)


@dataclasses.dataclass(frozen=True)
class DetectorTables:
    """Static tables for one (frame size, interval, cascade, device): the
    plain twins' and, in the kernels' layouts, the kernels' (all on the
    device once)."""
    spec: object
    M: int                 # windows per stream
    plane_keys: tuple      # pyramid planes packed first, in order
    geom_levels: tuple     # scale steps with windows (their I planes follow)
    L: int                 # flat buffer length per stream
    base: torch.Tensor     # (M, 3) i64 flat offset of feature (0, 0) per z
    rowstep: torch.Tensor  # (M, 3) i64
    out_x: torch.Tensor    # (M,) f32 box corner in frame px
    out_y: torch.Tensor
    out_w: torch.Tensor
    out_h: torch.Tensor
    stages: tuple          # tuple[_Stage]
    plan: _Plan            # the pyramid kernel's chains
    base32: torch.Tensor   # (M, 3) i32: base, rowstep as i32
    rowstep32: torch.Tensor
    feat: torch.Tensor     # (K, 10) i32 feature codes z | x' << 2 | y << 8
                           # (x' the column offset), -1 an empty slot;
                           # 5 positive, then 5 negative
    alpha: torch.Tensor    # (K, 2) f32
    thresh: torch.Tensor   # (S,) f32
    stage_end: torch.Tensor  # (S,) i32 end of each stage's weak range
    offs16: torch.Tensor   # (K, 10) i16 the deep kernel's feature slots:
                           # offsets in a window's footprint, -1 empty
    footprint: tuple       # (w0, h0, w1, h1, w2, h2): the footprint's
                           # bytes a row and rows a plane z (its layout)
    dense: "_Dense"        # the dense kernel's parameters (host arrays)
    launch: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
                           # the kernel wrappers' launch settings, cached


@dataclasses.dataclass(frozen=True)
class _Dense:
    """The cascade's dense kernel's parameters, host arrays copied into
    each launch (kernels/cascade.py): its leading stages' weak classifiers
    and the scale steps' geometry."""
    codes: np.ndarray      # (D, 10) i32, empty slots filled (_dense_codes)
    side: np.ndarray       # (D,) i32 sides with no slot
    alpha: np.ndarray      # (D, 2) f32
    thresh: np.ndarray     # (d,) f32 its stages' thresholds
    ends: np.ndarray       # (d,) i32 and ends
    ext: np.ndarray        # (3,) i32 plane rows a window row reads
    scales: np.ndarray     # (G, 9) i32 a scale step's first window,
                           # windows, columns 2 qw, plane offsets for z =
                           # 0, 1, 2, widths of planes 0, 1 and of I


def _dense_codes(codes):
    """The dense kernel's codes: each empty slot (-1) filled with the first
    slot of its side (a repeated pixel leaves min and max alone), and the
    sides with no slot at all: side bit 0 (no positive: min 255), bit 1
    (no negative: max 0), their slots code 0 (read, then ignored)."""
    out = codes.copy()
    side = np.zeros(len(codes), np.int32)
    for k, row in enumerate(codes):
        for bit, sl in ((1, slice(0, 5)), (2, slice(5, 10))):
            valid = row[sl][row[sl] >= 0]
            if valid.size == 0:
                side[k] |= bit
            out[k, sl] = np.where(row[sl] >= 0, row[sl],
                                  valid[0] if valid.size else 0)
    return out, side


def _dense_ext(codes):
    """The plane rows a window row reads, (3,) i32: planes 0 and 1 y < ext;
    I rows y2 + 2y, so 2 max y + 1; 0 for a plane no code reads."""
    z, y = codes & 3, codes >> 8
    ext = np.zeros(3, np.int32)
    for p in range(3):
        if (z == p).any():
            ext[p] = (2 if p == 2 else 1) * int(y[z == p].max()) + 1
    return ext


def _footprint(codes):
    """The deep kernel's footprint of a window (its feature pixels' extent
    by plane: (w0, h0, w1, h1, w2, h2), x' then y) and each slot's offset
    in it (planes 0, 1, 2 in turn, row-major; -1: an empty slot)."""
    ok = codes >= 0
    z, x, y = codes & 3, (codes >> 2) & 63, codes >> 8
    ext, offs = [], np.full(codes.shape, -1, np.int64)
    at = 0
    for p in range(3):
        on = ok & (z == p)
        w = int(x[on].max()) + 1 if on.any() else 0
        h = int(y[on].max()) + 1 if on.any() else 0
        offs[on] = at + y[on] * w + x[on]
        ext += [w, h]
        at += w * h
    return tuple(ext), offs.astype(np.int16)


def _feature_codes(cascade):
    """(K, 10) i32 codes of the weak classifiers' feature pixels (the
    cascade kernel's table)."""
    codes = []
    for zz, xx, yy in (("pz", "px", "py"), ("nz", "nx", "ny")):
        z = np.asarray(cascade[zz], np.int64)
        x = np.asarray(cascade[xx], np.int64)
        y = np.asarray(cascade[yy], np.int64)
        xo = np.where(z == 2, 2 * x, x)
        codes.append(np.where(z >= 0, z | (xo << 2) | (y << 8), -1))
    return np.concatenate(codes, axis=1).astype(np.int32)


def detector_tables(w0, h0, cascade, interval=5, device=None):
    """The static tables on ``device`` (see device.resolve_device)."""
    device = resolve_device(device)
    spec = pyramid_spec(w0, h0, interval)
    dims = dict(spec.dims)
    nxt = spec.next
    deep = int(cascade["count"]) > CHUNK_A_END

    geoms = []
    scale = 1.0
    for i in range(spec.scale_upto):
        W2, H2 = dims[i + 2 * nxt]
        qh, qw = H2 - 6, W2 - 6
        if qh > 0 and qw > 0:
            geoms.append((i, 2 * qh, 2 * qw, scale, H2, W2))
        scale *= spec.scale

    plane_keys = tuple(sorted({i * 4 for (i, *_r) in geoms} |
                              {(i + nxt) * 4 for (i, *_r) in geoms}))
    geom_levels = tuple(g[0] for g in geoms)
    # the packed buffer's layout is the plan's (ops/imageproc.py)
    p = pyramid_plan(spec, plane_keys, geom_levels)
    offs, ioffs = p.plane_off, p.inter_off

    base, rstep, ox, oy, ow, oh = [], [], [], [], [], []
    scales, first = [], 0
    for (i, qh2, qw2, sc, H2, W2) in geoms:
        scales.append([first, qh2 * qw2, qw2, offs[i * 4],
                       offs[(i + nxt) * 4], ioffs[i], dims[i][0],
                       dims[i + nxt][0], 2 * W2])
        first += qh2 * qw2
        y2, x2 = (a.ravel().astype(np.int64) for a in
                  np.meshgrid(np.arange(qh2), np.arange(qw2), indexing="ij"))
        w0p = dims[i][0]
        w1p = dims[i + nxt][0]
        wI = 2 * W2
        base.append(np.stack([offs[i * 4] + 2 * y2 * w0p + 2 * x2,
                              offs[(i + nxt) * 4] + y2 * w1p + x2,
                              ioffs[i] + y2 * wI + x2], axis=1))
        rstep.append(np.broadcast_to(np.array([w0p, w1p, 2 * wI], np.int64),
                                     (y2.size, 3)))
        if deep:
            s32 = np.float32(sc)
            ox.append((2 * x2).astype(np.float32) * s32)
            oy.append((2 * y2).astype(np.float32) * s32)
            ow.append(np.full(y2.size, np.float32(24) * s32, np.float32))
        else:
            ox.append((2 * x2 * sc).astype(np.float32))
            oy.append((2 * y2 * sc).astype(np.float32))
            ow.append(np.full(y2.size, 24 * sc, np.float32))
        oh.append(ow[-1])

    def cat(parts, dtype, width=None):
        if parts:
            return torch.as_tensor(np.concatenate(parts)).to(device)
        shape = (0,) if width is None else (0, width)
        return torch.zeros(shape, dtype=dtype, device=device)

    c = cascade_to_torch(cascade, device)
    cum = np.concatenate([[0], np.cumsum(np.asarray(cascade["stage_counts"]))])
    stages = []
    for s in range(int(cascade["count"])):
        k0, k1 = int(cum[s]), int(cum[s + 1])
        sides = []
        for zz, xx, yy in (("pz", "px", "py"), ("nz", "nx", "ny")):
            valid = c[zz][k0:k1] >= 0
            z, x, y = (torch.where(valid, c[a][k0:k1], 0) for a in (zz, xx, yy))
            # column step: 2 on the interleaved quarter plane (z=2), else 1
            sides.append((z, torch.where(z == 2, 2 * x, x), y, valid))
        stages.append(_Stage(
            thresh=float(c["stage_thresh"][s]),
            alpha0=c["alpha"][k0:k1, 0], alpha1=c["alpha"][k0:k1, 1],
            sides=tuple(sides)))

    dev = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    base_t = cat(base, torch.int64, 3)
    codes = _feature_codes(cascade)
    alpha = np.asarray(cascade["alpha"], np.float32).reshape(-1, 2)
    thresh = np.asarray(cascade["stage_thresh"], np.float32)
    ends = np.cumsum(np.asarray(cascade["stage_counts"])).astype(np.int32)
    d = dense_stages(ends)
    kd = int(ends[d - 1]) if d else 0
    foot, foot_offs = _footprint(codes)
    dense_codes, side = _dense_codes(codes[:kd])
    scales = np.asarray(scales, np.int32).reshape(-1, 9)
    ext = _dense_ext(dense_codes)
    rstep_t = cat(rstep, torch.int64, 3)
    return DetectorTables(
        spec=spec, M=sum(g[1] * g[2] for g in geoms),
        plane_keys=plane_keys, geom_levels=geom_levels,
        L=p.L, base=base_t, rowstep=rstep_t,
        out_x=cat(ox, torch.float32), out_y=cat(oy, torch.float32),
        out_w=cat(ow, torch.float32), out_h=cat(oh, torch.float32),
        stages=tuple(stages),
        plan=_Plan(steps=dev(p.steps), chain_first=dev(p.chain_first),
                   chain_grid=dev(p.chain_grid),
                   xg=dev(p.xg), yg=dev(p.yg), grid_bytes=p.grid_bytes,
                   chains=len(p.chain_first) - 1, S=p.S, host=p),
        base32=base_t.to(torch.int32).contiguous(),
        rowstep32=rstep_t.to(torch.int32).contiguous(),
        feat=dev(codes), alpha=dev(alpha), thresh=dev(thresh),
        stage_end=dev(ends), offs16=dev(foot_offs), footprint=foot,
        dense=_Dense(*(np.ascontiguousarray(a) for a in (
            dense_codes, side, alpha[:kd], thresh[:d], ends[:d], ext,
            scales))))


_TABLES = collections.OrderedDict()  # (w, h, interval, digest, device) -> tables
_TABLES_MAX = 16


def _cached_tables(w, h, cascade, interval, device):
    """``detector_tables``, cached per (frame size, cascade, interval,
    device) like the reference package's tables: a VJ frame does not
    rebuild them."""
    d = hashlib.sha1()
    for k in ARRAY_FIELDS:
        d.update(np.ascontiguousarray(np.asarray(cascade[k])).tobytes())
    key = (w, h, interval, d.hexdigest(), torch.device(device))
    if key in _TABLES:
        _TABLES.move_to_end(key)
    else:
        _TABLES[key] = detector_tables(w, h, cascade, interval, device=device)
        if len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
    return _TABLES[key]


def _tables_for(gray, cascade, interval):
    """The tables of ``cascade`` (a model, or its ``DetectorTables``) for
    gray (N, H, W) at ``interval``; a table set of another interval
    raises."""
    if isinstance(cascade, DetectorTables):
        if cascade.spec.interval != interval:
            raise ValueError(f"tables of interval {cascade.spec.interval} "
                             f"passed with interval={interval}")
        return cascade
    H, W = gray.shape[-2:]
    return _cached_tables(W, H, cascade, interval, gray.device)


def detect_candidates(gray, cascade, interval=5, k1=None, k2=None,
                      k_cand=CAPACITY):
    """Run the cascade over every window of every stream.

    gray (N, H, W) u8; cascade: a model (``Cascade`` of either package;
    its tables are built once per frame size, interval and device) or its
    ``detector_tables``.  k1 and k2 (the reference's tile and window caps)
    are accepted and ignored: the port has neither (F7).  Returns dict of
    (N, k_cand) arrays x, y, width, height, confidence + valid mask: each
    stream's first ``k_cand`` survivors in window order; and overflow (N,)
    i32, the survivors beyond ``k_cand`` (the reference package's key)."""
    tables = _tables_for(gray, cascade, interval)
    return _cascade(pyramid(gray, tables), tables, k_cand)


def group_candidates(x, y, w, h, conf, valid, min_neighbors=1):
    """src/ccv.js:249-331 over (N, K) candidate slots (K <= 256 on the
    card).

    Returns dict of (N, K) arrays: kept mask + grouped x/y/width/height/
    neighbors/confidence at component-representative slots (the smallest
    member index), in slot order like the JS seq2."""
    return group(x, y, w, h, conf, valid, max(int(min_neighbors), 1))[0]


def detect_objects_padded(gray, cascade, interval=5, min_neighbors=1,
                          k_cand=CAPACITY, k1=None, k2=None):
    """Grouped detections (ccv.detect_objects with min_neighbors > 0) as
    (N, k_cand) arrays + kept mask, and the cascade's overflow;
    min_neighbors=0 keeps every raw candidate.  cascade, k1, k2: as in
    ``detect_candidates``."""
    cand = detect_candidates(gray, cascade, interval, k_cand=k_cand)
    if not min_neighbors > 0:
        cand = dict(cand)
        cand["kept"] = cand.pop("valid")
        cand["neighbors"] = cand["kept"].to(torch.float32)
        return cand
    g = group_candidates(cand["x"], cand["y"], cand["width"],
                         cand["height"], cand["confidence"], cand["valid"],
                         min_neighbors)
    g["overflow"] = cand["overflow"]
    return g


def detect_best(gray, cascade, interval=5, min_neighbors=1, k_cand=CAPACITY,
                k1=None, k2=None):
    """The facetrackr candidate pick (src/facetrackr.js:157-165): max
    confidence, the first candidate wins ties.  Returns (found, x, y, w, h,
    confidence), each (N,).  No host read.  cascade, k1, k2: as in
    ``detect_candidates``."""
    cand = detect_candidates(gray, cascade, interval, k_cand=k_cand)
    return group(cand["x"], cand["y"], cand["width"], cand["height"],
                 cand["confidence"], cand["valid"],
                 min_neighbors if min_neighbors > 0 else 0)[1]
