"""BBF cascade detector over a batch of streams, in plain PyTorch on the device.

Reference behavior: src/ccv.js:109-333.  The formulation is the oracle's
(headtrackr_tpu/oracle/detector.py): the cascade is evaluated stage by stage
over the windows still alive, batched over streams, with no capacity caps.
Without caps the candidate set equals the reference package's wherever that
package reports ``overflow == 0``.

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
candidates by min-label propagation with pointer jumping (no matmul, so no
TF32 question), then member sums (exact in f64, rounded to f32) and the
containment filter.
"""

import dataclasses

import numpy as np
import torch

from ..cascade import cascade_to_torch
from ..device import resolve_device
from ..ops.imageproc import build_pyramid, pyramid_spec

__all__ = ["DetectorTables", "detector_tables", "detect_candidates",
           "group_candidates", "detect_objects_padded", "detect_best",
           "CHUNK_A_END"]

# the reference package's dense stage chunk; deeper cascades take its
# deep-path box arithmetic (see the module docstring)
CHUNK_A_END = 2
# alive windows x weak slots per gather chunk (bounds the index tensors)
_GATHER_BUDGET = 1 << 25


@dataclasses.dataclass(frozen=True)
class _Stage:
    thresh: float
    alpha0: torch.Tensor   # (K,) f32
    alpha1: torch.Tensor   # (K,) f32
    sides: tuple           # (z, x offset, py, valid): positive, negative


@dataclasses.dataclass(frozen=True)
class DetectorTables:
    """Static tables for one (frame size, interval, cascade, device)."""
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

    plane_keys = sorted({i * 4 for (i, *_r) in geoms} |
                        {(i + nxt) * 4 for (i, *_r) in geoms})
    offs = {}
    L = 0
    for k in plane_keys:
        w, h = dims[k // 4]
        offs[k] = L
        L += w * h
    ioffs = {}
    for (i, _, _, _, H2, W2) in geoms:
        ioffs[i] = L
        L += 4 * H2 * W2

    base, rstep, ox, oy, ow, oh = [], [], [], [], [], []
    for (i, qh2, qw2, sc, H2, W2) in geoms:
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

    return DetectorTables(
        spec=spec, M=sum(g[1] * g[2] for g in geoms),
        plane_keys=tuple(plane_keys), geom_levels=tuple(g[0] for g in geoms),
        L=L, base=cat(base, torch.int64, 3), rowstep=cat(rstep, torch.int64, 3),
        out_x=cat(ox, torch.float32), out_y=cat(oy, torch.float32),
        out_w=cat(ow, torch.float32), out_h=cat(oh, torch.float32),
        stages=tuple(stages))


def _pack_planes(gray, tables):
    """(N, H, W) u8 -> (N, L) u8: the pyramid planes and interleaved
    quarter planes of every stream, flat, in the tables' layout."""
    N = gray.shape[0]
    pyr, spec = build_pyramid(gray, tables.spec.interval)
    nxt = spec.next
    parts = [pyr[k].reshape(N, -1) for k in tables.plane_keys]
    for i in tables.geom_levels:
        q = torch.stack([pyr[(i + 2 * nxt) * 4 + j] for j in range(4)], dim=1)
        _, _, H2, W2 = q.shape
        inter = q.view(N, 2, 2, H2, W2).permute(0, 3, 1, 4, 2)
        parts.append(inter.reshape(N, 4 * H2 * W2))
    return torch.cat(parts, dim=1).contiguous()


def _stage_sums(buf, tables, stage, nidx, midx):
    """f64 vote sums of one stage for the alive windows (nidx, midx)."""
    base = tables.base[midx]
    rstep = tables.rowstep[midx]
    row0 = nidx * buf.shape[1]
    ext = []
    for (z, xoff, py, valid), fill, reduce in zip(
            stage.sides, (255, 0), (torch.amin, torch.amax)):
        idx = row0[:, None, None] + base[:, z] + py * rstep[:, z] + xoff
        vals = buf.view(-1)[idx].to(torch.int16)
        vals = torch.where(valid, vals, fill)
        ext.append(reduce(vals, dim=2))
    votes = torch.where(ext[0] > ext[1], stage.alpha1, stage.alpha0)
    return votes.to(torch.float64).sum(dim=1)


def detect_candidates(gray, tables):
    """Run the cascade over every window of every stream.

    gray (N, H, W) u8.  Returns dict of (N, K) arrays x, y, width, height,
    confidence + valid mask, K = the largest per-stream candidate count;
    each stream's candidates are in window order."""
    N = gray.shape[0]
    dev = gray.device
    M = tables.M
    if M == 0 or N == 0:
        z = torch.zeros((N, 0), dtype=torch.float32, device=dev)
        return dict(x=z, y=z, width=z, height=z, confidence=z,
                    valid=torch.zeros((N, 0), dtype=torch.bool, device=dev))
    buf = _pack_planes(gray, tables)
    alive = torch.arange(N * M, dtype=torch.int64, device=dev)
    conf = torch.zeros((N * M,), dtype=torch.float32, device=dev)
    for stage in tables.stages:
        if alive.numel() == 0:
            break
        per = max(1, _GATHER_BUDGET // (10 * stage.alpha0.numel()))
        sums = torch.cat([
            _stage_sums(buf, tables, stage, a // M, a % M)
            for a in torch.split(alive, per)])
        conf[alive] = sums.to(torch.float32)
        alive = alive[sums >= stage.thresh]

    n, m = alive // M, alive % M
    counts = torch.bincount(n, minlength=N)
    K = int(counts.max()) if alive.numel() else 0
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(alive.numel(), device=dev) - start[n]

    def pack(vals, fill=0.0):
        out = torch.full((N, K), fill, dtype=vals.dtype, device=dev)
        out[n, slot] = vals
        return out

    return dict(x=pack(tables.out_x[m]), y=pack(tables.out_y[m]),
                width=pack(tables.out_w[m]), height=pack(tables.out_h[m]),
                confidence=pack(conf[alive]),
                valid=pack(torch.ones_like(alive, dtype=torch.bool), False))


def _components(adj, valid):
    """(N, K, K) symmetric adjacency -> (N, K) component label = the
    smallest member index (K for invalid slots)."""
    N, K, _ = adj.shape
    idx = torch.arange(K, device=adj.device)
    lab = torch.where(valid, idx, K).expand(N, K).contiguous()
    while True:
        nb = torch.where(adj, lab[:, None, :], K).amin(dim=2)
        new = torch.minimum(lab, nb)
        # pointer jumping: a label is a member index of the same component
        new = torch.minimum(new, torch.gather(
            torch.cat([new, torch.full((N, 1), K, device=adj.device,
                                       dtype=new.dtype)], 1), 1, new))
        if torch.equal(new, lab):
            return lab
        lab = new


def group_candidates(x, y, w, h, conf, valid, min_neighbors=1):
    """src/ccv.js:249-331 over (N, K) candidate slots.

    Returns dict of (N, K) arrays: kept mask + grouped x/y/width/height/
    neighbors/confidence at component-representative slots (the smallest
    member index), in slot order like the JS seq2."""
    N, K = x.shape
    if K == 0:
        return dict(kept=valid, x=x, y=y, width=w, height=h,
                    neighbors=x, confidence=conf)
    f32 = torch.float32
    dist = torch.floor(w * 0.25 + 0.5)
    wide = torch.floor(w * 1.5 + 0.5)
    col = lambda t: t[:, :, None]  # noqa: E731  (candidate i, the r1 role)
    row = lambda t: t[:, None, :]  # noqa: E731  (candidate j, the r2 role)
    pred = ((row(x) <= col(x) + col(dist)) & (row(x) >= col(x) - col(dist)) &
            (row(y) <= col(y) + col(dist)) & (row(y) >= col(y) - col(dist)) &
            (row(w) <= col(wide)) & (row(wide) >= col(w)))
    eye = torch.eye(K, dtype=torch.bool, device=x.device)
    adj = (pred | pred.transpose(1, 2)) & col(valid) & row(valid)
    adj = adj | (eye & col(valid))
    label = _components(adj, valid)

    idxv = torch.arange(K, device=x.device)
    member = (row(label) == idxv[None, :, None]) & row(valid)  # [n, rep, j]
    # member sums in f64, exact in any order, rounded once to f32: a
    # stream's boxes do not depend on the K its batch pads it to
    mf = member.to(torch.float64)
    msum = lambda t: (mf * row(t).to(torch.float64)).sum(dim=2).to(f32)  # noqa: E731
    n = mf.sum(dim=2).to(f32)
    sx, sy, sw, sh = msum(x), msum(y), msum(w), msum(h)
    mconf = torch.where(member, row(conf), -torch.inf).amax(dim=2)

    rep = valid & (label == idxv) & (n >= min_neighbors)
    n_safe = torch.clamp(n, min=1.0)
    gx = (sx * 2 + n) / (2 * n_safe)
    gy = (sy * 2 + n) / (2 * n_safe)
    gw = (sw * 2 + n) / (2 * n_safe)
    gh = (sh * 2 + n) / (2 * n_safe)

    # containment filter (src/ccv.js:305-331): drop r1 contained (+-dist) in
    # a kept r2 with more neighbors
    dist2 = torch.floor(gw * 0.25 + 0.5)
    inside = ((col(gx) >= row(gx) - row(dist2)) &
              (col(gy) >= row(gy) - row(dist2)) &
              (col(gx) + col(gw) <= row(gx) + row(gw) + row(dist2)) &
              (col(gy) + col(gh) <= row(gy) + row(gh) + row(dist2)) &
              ((row(n) > torch.clamp(col(n), min=3.0)) | (col(n) < 3.0)) &
              row(rep) & ~eye)
    kept = rep & ~inside.any(dim=2)
    return dict(kept=kept, x=gx, y=gy, width=gw, height=gh,
                neighbors=n, confidence=mconf)


def detect_objects_padded(gray, tables, min_neighbors=1):
    """Grouped detections (ccv.detect_objects with min_neighbors > 0) as
    (N, K) arrays + kept mask; min_neighbors=0 keeps every raw candidate."""
    cand = detect_candidates(gray, tables)
    if not min_neighbors > 0:
        cand = dict(cand)
        cand["kept"] = cand.pop("valid")
        cand["neighbors"] = cand["kept"].to(torch.float32)
        return cand
    return group_candidates(cand["x"], cand["y"], cand["width"],
                            cand["height"], cand["confidence"], cand["valid"],
                            min_neighbors)


def detect_best(gray, tables, min_neighbors=1):
    """The facetrackr candidate pick (src/facetrackr.js:157-165): max
    confidence, the first candidate wins ties.  Returns (found, x, y, w, h,
    confidence), each (N,)."""
    g = detect_objects_padded(gray, tables, min_neighbors)
    N, K = g["kept"].shape
    if K == 0:
        z = torch.zeros((N,), dtype=torch.float32, device=gray.device)
        return (torch.zeros((N,), dtype=torch.bool, device=gray.device),
                z, z, z, z, torch.full_like(z, -torch.inf))
    score = torch.where(g["kept"], g["confidence"], -torch.inf)
    i = torch.argmax(score, dim=1, keepdim=True)
    pick = lambda k: torch.gather(g[k], 1, i)[:, 0]  # noqa: E731
    return (g["kept"].any(dim=1), pick("x"), pick("y"), pick("width"),
            pick("height"), pick("confidence"))
