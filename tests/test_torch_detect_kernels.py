"""The detector kernels' plain twins and tables (kernels/pyramid.py,
kernels/cascade.py, kernels/group.py) against the reference package and
the oracle, on the CPU:

- pyramid: the packed plane buffer bit-exact against the oracle's planes,
  within one u8 step of the reference package's (F1), and the kernel's job
  plan (ops/imageproc.py pyramid_plan, run here in NumPy as the kernel
  reads it) bit-exact against the twin;
- cascade: the candidate set and its window order against the reference
  package's ``detect_candidates`` (toy cascade, tiny frames: overflow 0
  there, then a capacity of 4 that it overflows: ``overflow`` and the kept
  first 4 equal), against the oracle on the real cascade at 320x240, and
  the kernel's feature-code tables (run here in NumPy as the kernel reads
  them) against the twin;
- group: the twin against the reference package's ``group_candidates``;
  a tie of ``detect_best`` won by the first candidate in window order;
- the package's ``models`` exports the reference's four names.

Small shapes: the JAX side compiles the toy detector at 48x64 twice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.cascade import frontalface as j_frontalface
from headtrackr_tpu.cascade import toy_cascade as j_toy
from headtrackr_tpu.models import detector as jd
from headtrackr_tpu.ops import imageproc as ji
from headtrackr_tpu.oracle import detector as od
from headtrackr_tpu.oracle import imageproc as oi
from headtrackr_tpu_torch.cascade import frontalface, toy_cascade
from headtrackr_tpu_torch.kernels.cascade import (DENSE, DENSE_TILES,
                                                  DENSE_WEAK, cascade,
                                                  dense_stages, dense_tile,
                                                  dense_tiles)
from headtrackr_tpu_torch.kernels.group import group
from headtrackr_tpu_torch.kernels.pyramid import (CTAS_PER_SM, SMEM_BYTES,
                                                  SPLITS, held_bytes,
                                                  pyramid, pyramid_regions)
from headtrackr_tpu_torch.kernels.pyramid import split as pyramid_split
from headtrackr_tpu_torch.models import detector as td
from headtrackr_tpu_torch.ops import imageproc as ti

torch.set_num_threads(2)

KEYS = ("x", "y", "width", "height", "confidence")


def _toy_frames(H=48, W=64):
    """Three streams: two 14 px squares, one square, no square."""
    f = np.full((3, H, W), 40, np.uint8)
    f[0, 6:20, 8:22] = 200
    f[0, 26:40, 36:50] = 200
    f[1, 20:34, 30:44] = 200
    return f


def _face_frame(H, W, corners):
    """A gray frame of the background with the synthetic 24x24 face at each
    (top, left) corner."""
    import importlib
    import os
    tc = importlib.import_module("headtrackr_tpu_torch.cascade")
    face = np.load(os.path.join(tc.DATA_DIR, "synthface.npz"))["rgb"]
    rgb = np.full((H, W, 3), (120, 100, 90), np.uint8)
    for y, x in corners:
        rgb[y:y + 24, x:x + 24] = face
    return np.asarray(oi.grayscale(rgb), np.uint8)


def _emulate_plan(gray, plan, nxt, split=1, limit=SMEM_BYTES):
    """The pyramid kernel's reads and writes in NumPy: each chain's steps in
    order, a level at a time vectorized over the plane, its source rows
    from the frame, from the chain's previous level as ``split`` CTAs hold
    it in shared memory (row r on CTA r % split at local row r // split)
    or, where ``pyramid_regions`` does not hold it, from its packed plane.
    Each packed byte records the (chain, step) that wrote it: a step reads
    only bytes its chain's previous step wrote, and no byte is written
    twice."""
    N, h0, w0 = gray.shape
    frame = gray.reshape(N, h0, w0)
    out = np.zeros((N, plan.L), np.uint8)
    scr = np.zeros((N, plan.S), np.uint8)
    wrote = np.full(plan.L, -1)
    regions = pyramid_regions(plan, split, limit)
    cf = plan.chain_first

    def grid(table, row, n):
        t = table[row:row + n]
        return t[:, 0], t[:, 1], t[:, 2].view(np.float32), \
            t[:, 3].view(np.float32)

    def lerp(rows, xs, ys):
        x0, x1, gx, fx = xs
        y0, y1, gy, fy = ys
        r0 = rows(y0).astype(np.float32)
        r1 = rows(y1).astype(np.float32)
        top = r0[:, :, x0] * gx + r0[:, :, x1] * fx
        bot = r1[:, :, x0] * gx + r1[:, :, x1] * fx
        v = top * gy[:, None] + bot * fy[:, None]
        return np.round(np.clip(v, 0, 255)).astype(np.uint8)

    def write(off, vals, tag):
        size = vals.shape[1]
        assert (wrote[off:off + size] == -1).all(), "a byte written twice"
        out[:, off:off + size] = vals
        wrote[off:off + size] = tag

    for c in range(len(cf) - 1):
        held = [None, None]
        prev = None
        for j, st in enumerate(plan.steps[cf[c]:cf[c + 1]]):
            tag = 100 * c + j
            w, h = int(st[ti.STEP_W]), int(st[ti.STEP_H])
            hold = bool(st[ti.STEP_SOURCE]) and (
                held_bytes(st, split) <= regions[j & 1])
            if st[ti.STEP_FROM] == ti.FROM_COPY:
                if st[ti.STEP_PLANE] >= 0:
                    write(st[ti.STEP_PLANE], gray.reshape(N, -1), tag)
                prev = (st, None)
                continue
            if st[ti.STEP_FROM] == ti.FROM_FRAME:
                rows = lambda y: frame[:, y]  # noqa: E731
            elif prev[1] is not None:  # the previous level, in shared memory
                sm = prev[1]
                rows = lambda y, sm=sm: sm[:, y % split, y // split]  # noqa: E731
            else:  # read back from its packed plane (or the scratch)
                p = prev[0]
                pw, ph = int(p[ti.STEP_W]), int(p[ti.STEP_H])
                if p[ti.STEP_PLANE] >= 0:
                    o = int(p[ti.STEP_PLANE])
                    assert (wrote[o:o + pw * ph] == tag - 1).all(), \
                        "a step read bytes its chain's previous step did not write"
                    src = out[:, o:o + pw * ph].reshape(N, ph, pw)
                else:
                    o = int(p[ti.STEP_SCR])
                    src = scr[:, o:o + pw * ph].reshape(N, ph, pw)
                rows = lambda y, src=src: src[:, y]  # noqa: E731
            if st[ti.STEP_FROM] == ti.FROM_PREV:
                p = prev[0]
                assert (st[ti.STEP_LEVEL] - p[ti.STEP_LEVEL] == nxt
                        and (st[ti.STEP_SW], st[ti.STEP_SH])
                        == (p[ti.STEP_W], p[ti.STEP_H]))
            xa = grid(plan.xg, st[ti.STEP_XA], w)
            ya = grid(plan.yg, st[ti.STEP_YA], h)
            q0 = lerp(rows, xa, ya)
            if st[ti.STEP_PLANE] >= 0:
                write(st[ti.STEP_PLANE], q0.reshape(N, -1), tag)
            sm = None
            if hold:
                rh = -(-h // split)
                sm = np.zeros((N, split, rh, w), np.uint8)
                for r in range(h):
                    sm[:, r % split, r // split] = q0[:, r]
            elif st[ti.STEP_SCR] >= 0:
                o = int(st[ti.STEP_SCR])
                scr[:, o:o + w * h] = q0.reshape(N, -1)
            if st[ti.STEP_INTER] >= 0:
                q = np.zeros((4, N, h, w), np.uint8)
                q[0] = q0
                if st[ti.STEP_XB] >= 0:
                    xb = grid(plan.xg, st[ti.STEP_XB], w - 2)
                    q[1, :, :, :w - 2] = lerp(rows, xb, ya)
                if st[ti.STEP_YB] >= 0:
                    yb = grid(plan.yg, st[ti.STEP_YB], h - 2)
                    q[2, :, :h - 2] = lerp(rows, xa, yb)
                    if st[ti.STEP_XB] >= 0:
                        q[3, :, :h - 2, :w - 2] = lerp(rows, xb, yb)
                inter = q.reshape(2, 2, N, h, w).transpose(2, 3, 0, 4, 1)
                write(st[ti.STEP_INTER], inter.reshape(N, -1), tag)
            prev = (st, sm)
    assert (wrote >= 0).all(), "a packed byte no step wrote"
    return out


def _pack_oracle(planes, tables):
    """The oracle's planes in the tables' packed layout."""
    nxt = tables.spec.next
    parts = [planes[k].ravel() for k in tables.plane_keys]
    for i in tables.geom_levels:
        q = np.stack([planes[(i + 2 * nxt) * 4 + j] for j in range(4)])
        _, H2, W2 = q.shape
        parts.append(q.reshape(2, 2, H2, W2).transpose(2, 0, 3, 1).ravel())
    return np.concatenate(parts)


@pytest.mark.parametrize("shape", [(48, 64), (57, 99), (240, 320),
                                   (480, 640)])
def test_pyramid_twin_and_plan_against_oracle(shape, rng):
    H, W = shape
    gray = rng.integers(0, 256, (2, H, W), np.uint8)
    tables = td.detector_tables(W, H, toy_cascade(), 5, "cpu")
    got = pyramid(torch.as_tensor(gray), tables).numpy()
    assert got.shape == (2, tables.L)
    for n in range(2):
        want = _pack_oracle(oi.build_pyramid(gray[n])[0], tables)
        np.testing.assert_array_equal(got[n], want, err_msg=f"stream {n}")
    plan = ti.pyramid_plan(tables.spec, tables.plane_keys, tables.geom_levels)
    for split in SPLITS:
        np.testing.assert_array_equal(
            _emulate_plan(gray, plan, tables.spec.next, split), got,
            err_msg=f"split {split}")
    assert plan.L == tables.L and torch.equal(
        tables.plan.steps, torch.as_tensor(plan.steps))
    # the reference package's planes: within one u8 step (F1)
    pyr_j = jax.jit(lambda g: ji.build_pyramid(g)[0])(jnp.asarray(gray[0]))
    packed_j = _pack_oracle({k: np.asarray(v) for k, v in pyr_j.items()},
                            tables)
    assert np.abs(packed_j.astype(int) - got[0]).max() <= 1


def test_pyramid_plan_spills_to_the_packed_plane(rng):
    """At 480x640 a CTA of a chain split 1, 2 or 4 ways cannot hold the
    first levels in its share of an SM (SMEM_BYTES, two CTAs an SM: level
    1 alone is 243,390 bytes at split 1, 60,990 at split 4, beside the
    other region and the staged grids): those the regions drop are the
    largest of their parity, the next levels read them back from their
    packed planes, and the planes still equal the twin's; at 240x320
    every split holds every source level, and no layout needs scratch."""
    for (H, W), spills in (((480, 640), True), ((240, 320), False)):
        tables = td.detector_tables(W, H, toy_cascade(), 5, "cpu")
        plan = ti.pyramid_plan(tables.spec, tables.plane_keys,
                               tables.geom_levels)
        assert plan.S == 0
        for split in SPLITS:
            r = pyramid_regions(plan, split)
            assert sum(r) + plan.grid_bytes + 15 <= SMEM_BYTES
            sizes = [(held_bytes(st, split), j & 1, int(st[ti.STEP_LEVEL]))
                     for c in range(len(plan.chain_first) - 1)
                     for j, st in enumerate(plan.steps[
                         plan.chain_first[c]:plan.chain_first[c + 1]])
                     if st[ti.STEP_SOURCE]]
            dropped = [lv for size, par, lv in sizes if size > r[par]]
            held = [(size, par) for size, par, lv in sizes if size <= r[par]]
            assert bool(dropped) == (spills and split <= 4), (H, split)
            for size, par, lv in sizes:
                if lv in dropped:
                    assert all(size >= h for h, p in held if p == par)
            if dropped:
                assert 1 in dropped
    gray = rng.integers(0, 256, (1, 480, 640), np.uint8)
    tables = td.detector_tables(640, 480, toy_cascade(), 5, "cpu")
    plan = ti.pyramid_plan(tables.spec, tables.plane_keys,
                           tables.geom_levels)
    want = pyramid(torch.as_tensor(gray), tables).numpy()
    for split in (1, 4):
        np.testing.assert_array_equal(
            _emulate_plan(gray, plan, tables.spec.next, split), want,
            err_msg=f"split {split}")


@pytest.mark.parametrize("shape", [(48, 64), (57, 99), (240, 320),
                                   (480, 640)])
def test_pyramid_chains_read_only_their_own_levels(shape):
    """Chain c holds levels c, c + next, ... in order, each computed once:
    a FROM_PREV step reads the level ``next`` below it, the step before it
    in its own chain; levels 1..next read the frame; every packed plane and
    interleaved block is written by exactly one step; and each chain's
    levels are the ones the packed layout needs, with every source level
    among them."""
    H, W = shape
    tables = td.detector_tables(W, H, toy_cascade(), 5, "cpu")
    spec, nxt = tables.spec, tables.spec.next
    plan = ti.pyramid_plan(spec, tables.plane_keys, tables.geom_levels)
    dims = dict(spec.dims)
    levels, planes, inters = [], [], []
    cf = plan.chain_first
    for c in range(len(cf) - 1):
        rows = plan.steps[cf[c]:cf[c + 1]]
        lv = [int(r[ti.STEP_LEVEL]) for r in rows]
        assert lv == list(range(lv[0], lv[0] + nxt * len(lv), nxt))
        assert len({v % nxt for v in lv}) == 1
        for j, r in enumerate(rows):
            w, h = dims[lv[j]]
            assert (r[ti.STEP_W], r[ti.STEP_H]) == (w, h)
            if lv[j] == 0:
                assert r[ti.STEP_FROM] == ti.FROM_COPY
            elif lv[j] <= nxt:
                assert r[ti.STEP_FROM] == ti.FROM_FRAME
                assert (r[ti.STEP_SW], r[ti.STEP_SH]) == (W, H)
            else:
                assert r[ti.STEP_FROM] == ti.FROM_PREV and j > 0
                assert (r[ti.STEP_SW], r[ti.STEP_SH]) == dims[lv[j] - nxt]
                src = rows[j - 1]
                assert src[ti.STEP_SOURCE] == 1
                assert src[ti.STEP_PLANE] >= 0 or src[ti.STEP_SCR] >= 0
            assert r[ti.STEP_SOURCE] == (j + 1 < len(rows) and lv[j] > 0)
        levels += lv
        planes += [int(r[ti.STEP_PLANE]) for r in rows
                   if r[ti.STEP_PLANE] >= 0]
        inters += [int(r[ti.STEP_INTER]) for r in rows
                   if r[ti.STEP_INTER] >= 0]
        # the chain's grids: one contiguous run of xg and of yg rows
        x0, xn, y0, yn = plan.chain_grid[c]
        for r in rows[rows[:, ti.STEP_FROM] != ti.FROM_COPY]:
            w, h = int(r[ti.STEP_W]), int(r[ti.STEP_H])
            assert x0 <= r[ti.STEP_XA] and r[ti.STEP_XA] + w <= x0 + xn
            assert y0 <= r[ti.STEP_YA] and r[ti.STEP_YA] + h <= y0 + yn
            if r[ti.STEP_XB] >= 0:
                assert r[ti.STEP_XB] + w - 2 <= x0 + xn
            if r[ti.STEP_YB] >= 0:
                assert r[ti.STEP_YB] + h - 2 <= y0 + yn
    assert plan.grid_bytes == 16 * max(g[1] + g[3] for g in plan.chain_grid)
    assert plan.chain_grid[:, 1].sum() == len(plan.xg)
    assert len(levels) == len(set(levels))
    assert sorted(planes) == sorted(plan.plane_off.values())
    assert sorted(inters) == sorted(plan.inter_off.values())
    need = {k // 4 for k in tables.plane_keys} | {
        i + 2 * nxt for i in tables.geom_levels}
    assert set(levels) == need | {v - nxt for v in need if v >= nxt}


def test_pyramid_split_fills_one_wave():
    """kernels/pyramid.py split on the H100's 132 SMs (two CTAs an SM: 264):
    16 CTAs a chain at one stream (96 CTAs), 8 at 3 to 5 streams, 4 at the
    relock bucket's 8 streams (192), 2 at 22 (264), 1 from 23 streams on
    (the 256-stream full tick: 1,536 CTAs)."""
    assert [pyramid_split(n, 6, 132) for n in (1, 2, 3, 5, 6, 8, 11, 12,
                                               22, 23, 44, 256)] \
        == [16, 16, 8, 8, 4, 4, 4, 2, 2, 1, 1, 1]
    assert pyramid_split(1, 6, 4) == 1


def test_pyramid_plan_rows_are_the_kernels():
    """The plan's step rows have the columns csrc/pyramid.cu reads, in its
    order; its instances are SPLITS, its residency CTAS_PER_SM CTAs an SM
    (its launch bounds) and its shared-memory cap SMEM_BYTES."""
    import pathlib
    import re
    src = (pathlib.Path(ti.__file__).parent.parent / "csrc"
           / "pyramid.cu").read_text()
    cols = int(re.search(r"constexpr int kCols = (\d+);", src).group(1))
    names = re.search(r"enum \{([^}]*)\}", src).group(1).replace(
        " ", "").replace("\n", "").split(",")
    assert cols == ti.STEP_COLS == len(names)
    consts = {k: v for k, v in vars(ti).items() if k.startswith("STEP_")
              and k != "STEP_COLS"}
    for name, col in consts.items():
        assert names[col] == "k" + name[5:].title().replace("_", ""), name
    froms = re.search(r"enum \{ kFromCopy = (-?\d+), kFromFrame = (-?\d+), "
                      r"kFromPrev = (-?\d+) \}", src).groups()
    assert tuple(map(int, froms)) == (ti.FROM_COPY, ti.FROM_FRAME,
                                      ti.FROM_PREV)
    assert tuple(int(c) for c in re.findall(r"case (\d+):", src)) == SPLITS
    assert f"constexpr int kCtasPerSm = {CTAS_PER_SM};" in src
    assert "__launch_bounds__(kThreads, kCtasPerSm)" in src
    cap = re.search(r"constexpr int kSmemPerCta = (\d+) / kCtasPerSm - "
                    r"(\d+);", src).groups()
    assert int(cap[0]) // CTAS_PER_SM - int(cap[1]) == SMEM_BYTES
    assert "smem > kSmemPerCta" in src
    tables = td.detector_tables(64, 48, toy_cascade(), 5, "cpu")
    assert tuple(tables.plan.steps.shape) == (len(tables.plan.steps), cols)


def _weak_votes(b, codes, alpha, base, rstep):
    """(windows, weak) f64 votes of the weak classifiers of feature codes
    ``codes`` (weak, 10) and ``alpha`` (weak, 2) at windows whose plane
    offsets and row steps by z are ``base``, ``rstep`` (windows, 3), as the
    kernels read them."""
    ok = codes >= 0
    z, x, y = (np.where(ok, a, 0) for a in (codes & 3, (codes >> 2) & 63,
                                              codes >> 8))
    px = b[base[:, z] + y * rstep[:, z] + x].astype(int)  # (w, k, 10)
    pmin = np.where(ok[:, :5], px[..., :5], 255).min(-1)
    nmax = np.where(ok[:, 5:], px[..., 5:], 0).max(-1)
    return np.where(pmin > nmax, alpha[:, 1], alpha[:, 0]).astype(np.float64)


def _filled_votes(b, codes, side, alpha, base, rstep):
    """_weak_votes as the dense kernel takes them: every slot read (empty
    ones filled with a slot of their side), then ``side``'s empty sides
    set to 255 (positive) and 0 (negative)."""
    z, x, y = codes & 3, (codes >> 2) & 63, codes >> 8
    px = b[base[:, z] + y * rstep[:, z] + x].astype(int)  # (w, k, 10)
    pmin = np.where(side & 1, 255, px[..., :5].min(-1))
    nmax = np.where(side & 2, 0, px[..., 5:].max(-1))
    return np.where(pmin > nmax, alpha[:, 1], alpha[:, 0]).astype(np.float64)


def _warp_sum(votes):
    """A stage's f64 sum as a warp takes it: lane l adds votes l, l + 32,
    ... (pairs l, l + 32 per turn), then five xor shuffles."""
    n, k = votes.shape
    lanes = np.zeros((n, 32))
    for j in range(k):
        lanes[:, j % 32] += votes[:, j]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    return lanes[:, 0]


def _footprint_votes(b, offs, alpha, foot, base, rstep):
    """(1, weak) f64 votes at one window as the deep kernel takes them:
    its footprint (``foot`` = (w0, h0, w1, h1, w2, h2): rows of plane z at
    the window's base and row step, w[z] bytes each) copied out, then each
    slot an offset into it (-1 empty)."""
    fp = np.concatenate([
        b[base[0, z] + rstep[0, z] * np.arange(foot[2 * z + 1])[:, None]
          + np.arange(foot[2 * z])].ravel() for z in range(3)]).astype(int)
    ok = offs >= 0
    px = fp[np.where(ok, offs, 0)]
    pmin = np.where(ok[:, :5], px[:, :5], 255).min(-1)
    nmax = np.where(ok[:, 5:], px[:, 5:], 0).max(-1)
    return np.where(pmin > nmax, alpha[:, 1],
                    alpha[:, 0]).astype(np.float64)[None]


def _cascade_emulated(buf, tables, capacity, rng, tile):
    """The cascade kernels' work division in NumPy.  cascade_dense: a CTA
    a tile (``tile`` windows of one scale step from the word of its first
    window; ``tables.dense``'s scales and tile_first, whose feature offsets
    must be base32 / rowstep32), a thread a window through the dense
    stages; each warp's survivors appended to the work list in lane order
    at a ticket, its ballot ORed into its bitmap word.  cascade_deep: the
    list taken in a shuffled order (the kernel's warps finish in no
    order), each survivor's footprint copied and its deep stages summed as
    a warp sums them (offs16); a dying survivor clears its bit, a living
    one writes its confidence.  cascade_compact: each stream's set bits in
    word order, the first ``capacity`` kept."""
    dn = tables.dense
    codes_d, side_d, alpha_d, thresh_d, ends_d = (dn.codes, dn.side, dn.alpha,
                                                  dn.thresh, dn.ends)
    ext, scales = dn.ext, dn.scales
    tile_first, tile_bytes = dense_tiles(scales, ext, tile)
    d = len(ends_d)
    ends = np.concatenate([[0], tables.stage_end.numpy()])
    thresh = tables.thresh.numpy()
    offs16 = tables.offs16.numpy().astype(np.int64)
    alpha = tables.alpha.numpy()
    base32, rstep32 = tables.base32.numpy(), tables.rowstep32.numpy()
    N, M = buf.shape[0], tables.M
    stages = len(ends) - 1
    words = -(-M // 32)
    bits = np.zeros((N, words), np.uint64)
    conf = np.zeros((N, M), np.float32)
    work = []
    tiles = [(g, scales[g][0] // 32 * 32 + tile * j)
             for g in range(len(scales))
             for j in range(tile_first[g + 1] - tile_first[g])]
    for n in range(N):
        for g, m0 in tiles:
            first, count, cols, o0, o1, o2, w0, w1, wi = scales[g]
            m = np.arange(m0, m0 + tile)
            on = (m >= first) & (m < first + count)
            y2, x2 = np.divmod(np.where(on, m - first, 0), cols)
            base = np.stack([o0 + 2 * y2 * w0 + 2 * x2, o1 + y2 * w1 + x2,
                             o2 + y2 * wi + x2], 1)
            rstep = np.broadcast_to(np.array([w0, w1, 2 * wi]), base.shape)
            np.testing.assert_array_equal(base[on], base32[m[on]])
            np.testing.assert_array_equal(rstep[on], rstep32[m[on]])
            # the staged rows of planes 0, 1 and I (each run at its global
            # offset's alignment mod 16, the buffer's start taken as 0 mod
            # 16), and each window's base in them
            y2lo = (max(m0, first) - first) // cols
            y2hi = (min(m0 + tile, first + count) - 1 - first) // cols
            staged = np.zeros(tile_bytes, np.uint8)
            at, t = [], 0
            for z, (off, wz, sy) in enumerate(((o0, w0, 2), (o1, w1, 1),
                                               (o2, wi, 1))):
                rows = (sy * (y2hi - y2lo) + ext[z]) if ext[z] else 0
                src = off + sy * y2lo * wz
                at.append(t + (n * buf.shape[1] + src) % 16)
                staged[at[-1]:at[-1] + rows * wz] = buf[n, src:src + rows * wz]
                if rows:
                    t += (rows * wz + 30) & ~15
            assert t <= tile_bytes
            tb = np.stack([at[0] + 2 * (y2 - y2lo) * w0 + 2 * x2,
                           at[1] + (y2 - y2lo) * w1 + x2,
                           at[2] + (y2 - y2lo) * wi + x2], 1)
            alive = on.copy()
            ssum = np.zeros(m.size)
            k0 = 0
            for s in range(d):
                w = np.nonzero(alive)[0]
                ssum[w] = _filled_votes(staged, codes_d[k0:ends_d[s]],
                                        side_d[k0:ends_d[s]],
                                        alpha_d[k0:ends_d[s]], tb[w],
                                        rstep[w]).sum(-1)
                alive[w] = ssum[w] >= np.float64(thresh_d[s])
                k0 = ends_d[s]
            for w0_ in range(0, tile, 32):
                lanes = alive[w0_:w0_ + 32]
                if not lanes.any():  # a zero ballot writes nothing
                    continue
                bits[n, (m0 + w0_) // 32] |= np.uint64(sum(
                    1 << int(i) for i in np.nonzero(lanes)[0]))
                if stages > d:
                    work += [n * M + int(v) for v in m[w0_:w0_ + 32][lanes]]
            if stages <= d:
                conf[n, m[alive]] = ssum[alive].astype(np.float32)
    assert len(tiles) == tile_first[-1]
    work = rng.permutation(np.asarray(work, np.int64))
    n, m = work // M, work % M
    live = np.ones(work.size, bool)
    total = np.zeros(work.size)
    for s in range(d, stages):
        for i in np.nonzero(live)[0]:
            total[i] = _warp_sum(_footprint_votes(
                buf[n[i]], offs16[ends[s]:ends[s + 1]],
                alpha[ends[s]:ends[s + 1]], tables.footprint,
                base32[m[i:i + 1]], rstep32[m[i:i + 1]]))[0]
        w = np.nonzero(live)[0]
        live[w] = total[w] >= np.float64(thresh[s])
    for i in range(work.size):
        if live[i]:
            conf[n[i], m[i]] = np.float32(total[i])
        else:
            bits[n[i], m[i] // 32] &= ~np.uint64(1 << int(m[i] % 32))
    out = []
    for n in range(N):
        idx = np.asarray([32 * w + b for w in range(words) for b in range(32)
                          if int(bits[n, w]) >> b & 1], np.int64)
        out.append((idx[:capacity], conf[n, idx[:capacity]],
                    max(idx.size - capacity, 0)))
    return out


def test_dense_stages_fit_the_kernels_parameters():
    """The dense kernel runs the leading stages (at most 2) whose weak
    classifiers fit its 16: the frontal-face cascade's 4 + 4, the toy's
    1; a cascade whose first stage has more gives the deep kernel every
    stage.  The constants are csrc/cascade.cu's."""
    import pathlib
    import re
    src = (pathlib.Path(ti.__file__).parent.parent / "csrc"
           / "cascade.cu").read_text()
    const = lambda name: int(re.search(  # noqa: E731
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kDense"), const("kDenseWeak"), const("kMaxTile")) == (
        DENSE, DENSE_WEAK, max(DENSE_TILES))
    assert all(t % const("kThreads") == 0 for t in DENSE_TILES)
    # the larger tile where its CTAs fill 8 an SM of the H100's 132
    assert [dense_tile(n, 75, 132) for n in (1, 8, 14, 15, 256)] == [
        256, 256, 256, 1024, 1024]
    assert const("kScaleCols") == 9
    assert dense_stages(np.array([4, 8, 15])) == 2
    assert dense_stages(np.array([1])) == 1
    assert dense_stages(np.array([12, 20])) == 1
    assert dense_stages(np.array([17, 20])) == 0
    assert const("kMaxScales") >= 25  # 1080p's scale steps
    t = td.detector_tables(80, 60, frontalface(), 5, "cpu")
    dn = t.dense
    assert [a.shape for a in (dn.codes, dn.side, dn.alpha, dn.thresh,
                              dn.ends)] == [(8, 10), (8,), (8, 2), (2,), (2,)]
    # empty slots filled from their own side; a side with none flagged
    codes = np.array([[5, -1, 9, -1, -1, -1, -1, -1, -1, -1],
                      [-1, -1, -1, -1, -1, 7, -1, 3, -1, -1]], np.int32)
    filled, side = td._dense_codes(codes)
    assert filled.tolist() == [[5, 5, 9, 5, 5, 0, 0, 0, 0, 0],
                               [0, 0, 0, 0, 0, 7, 7, 3, 7, 7]]
    assert side.tolist() == [2, 1]
    # the footprint: 24 x 24, 12 x 12 and 11 x 6 bytes, every slot in it
    assert t.footprint == (24, 24, 12, 12, 11, 6)
    offs, feat = t.offs16.numpy(), t.feat.numpy()
    assert ((offs >= 0) == (feat >= 0)).all()
    assert offs.max() < 24 * 24 + 12 * 12 + 11 * 6


@pytest.mark.parametrize("casc,shape", [(toy_cascade, (48, 64)),
                                        (frontalface, (60, 80))])
def test_cascade_tables_emulated_equal_twin(casc, shape, rng):
    """The toy cascade (one stage: no deep kernel) on noise and squares;
    the real one on noise and on two synthetic faces, whose windows pass
    all 16 stages (and many die on the way: cleared bits)."""
    H, W = shape
    gray = torch.as_tensor(rng.integers(0, 256, (2, H, W), np.uint8))
    if casc is toy_cascade:
        gray[1] = torch.as_tensor(_toy_frames(H, W)[0])
    else:
        gray[1] = torch.as_tensor(_face_frame(H, W, [(18, 28), (30, 4)]))
    tables = td.detector_tables(W, H, casc(), 5, "cpu")
    buf = pyramid(gray, tables)
    for cap, tile in ((256, DENSE_TILES[0]), (3, DENSE_TILES[1])):
        got = cascade(buf, tables, cap)
        emulated = _cascade_emulated(buf.numpy(), tables, cap, rng, tile)
        assert emulated[1][0].size > 0
        for n, (idx, conf, ovf) in enumerate(emulated):
            k = idx.size
            assert got["valid"][n].sum() == k and got["valid"][n, :k].all()
            np.testing.assert_array_equal(got["x"][n, :k].numpy(),
                                          tables.out_x[idx].numpy())
            np.testing.assert_array_equal(got["y"][n, :k].numpy(),
                                          tables.out_y[idx].numpy())
            np.testing.assert_array_equal(got["confidence"][n, :k].numpy(),
                                          conf)
            assert int(got["overflow"][n]) == ovf
            assert (got["x"][n, k:] == 0).all()


_JAX_CAND = {}


def _jax_candidates(gray, k_cand):
    if k_cand not in _JAX_CAND:
        _JAX_CAND[k_cand] = jax.jit(jax.vmap(lambda g: jd.detect_candidates(
            g, j_toy(), 5, k_cand=k_cand)))
    return {k: np.asarray(v)
            for k, v in _JAX_CAND[k_cand](jnp.asarray(gray)).items()}


@pytest.mark.parametrize("k_cand", [256, 4])
def test_cascade_twin_equals_reference_candidates(k_cand):
    """The toy cascade (one stage: the reference's single-chunk path, whose
    order is window order) at 48x64: the set, the order, the values and
    ``overflow`` (0 at 256; the survivors beyond 4 at 4, the kept ones the
    first 4)."""
    gray = _toy_frames()
    want = _jax_candidates(gray, k_cand)
    tables = td.detector_tables(64, 48, toy_cascade(), 5, "cpu")
    got = {k: v.numpy() for k, v in
           td.detect_candidates(torch.as_tensor(gray), tables,
                                k_cand=k_cand).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    v = want["valid"]
    assert v.sum(1).tolist()[:2] != [0, 0]
    for k in KEYS:
        np.testing.assert_allclose(got[k][v], want[k][v], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    if k_cand == 256:
        assert (want["overflow"] == 0).all()
    else:
        assert want["overflow"][0] > 0  # survivors beyond the capacity
    # detect_objects_padded reports the same overflow
    g = td.detect_objects_padded(torch.as_tensor(gray), tables,
                                 min_neighbors=1, k_cand=k_cand)
    np.testing.assert_array_equal(g["overflow"].numpy(), want["overflow"])


def test_cascade_twin_equals_oracle_real_cascade():
    """The real cascade at 320x240 on a frame with two faces: the raw
    candidates equal the oracle's dense scores (set; x, y, w to rtol 1e-6,
    confidence to 1e-5), in window order (scale-major, then row-major)."""
    import importlib
    import os
    tc = importlib.import_module("headtrackr_tpu_torch.cascade")
    face = np.load(os.path.join(tc.DATA_DIR, "synthface.npz"))["rgb"]
    rgb = np.full((240, 320, 3), (120, 100, 90), np.uint8)
    rgb[108:132, 148:172] = face
    rgb[40:64, 60:84] = face
    gray = np.asarray(oi.grayscale(rgb), np.uint8)
    tables = td.detector_tables(320, 240, frontalface(), 5, "cpu")
    got = {k: v[0].numpy() for k, v in
           td.detect_candidates(torch.as_tensor(gray)[None], tables).items()}
    assert int(got["overflow"]) == 0
    v = got["valid"]
    mine = np.stack([got[k][v] for k in ("x", "y", "width",
                                         "confidence")], 1)
    ora = od.dense_scores(gray, j_frontalface())
    ref = np.array([[s["x"], s["y"], s["width"], s["confidence"]]
                    for s in ora])
    assert len(ref) == len(mine) > 0
    order = lambda a: np.lexsort((a[:, 0], a[:, 1], a[:, 2]))  # noqa: E731
    np.testing.assert_allclose(mine[order(mine)][:, :3],
                               ref[order(ref)][:, :3], rtol=1e-6)
    np.testing.assert_allclose(mine[order(mine)][:, 3],
                               ref[order(ref)][:, 3], atol=1e-5)
    # window order: scale-major (width), then row-major
    key = mine[:, 2] * 1e6 + mine[:, 1] * 1e3 + mine[:, 0]
    assert (np.diff(key) > 0).all()


def _clustered(rng, n, k):
    """(n, k) candidate slots: boxes around a few centres, widths from the
    pyramid's scales, the first valid slots a prefix of varying length."""
    x = np.zeros((n, k), np.float32)
    y, w, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    valid = np.zeros((n, k), bool)
    for s in range(n):
        m = int(rng.integers(0, k + 1))
        centres = rng.uniform(0, 200, (3, 2))
        pick = rng.integers(0, 3, m)
        scale = (2.0 ** (1 / 6)) ** rng.integers(0, 6, m)
        x[s, :m] = (2 * np.round(centres[pick, 0] + rng.normal(0, 2, m))
                    * scale).astype(np.float32)
        y[s, :m] = (2 * np.round(centres[pick, 1] + rng.normal(0, 2, m))
                    * scale).astype(np.float32)
        w[s, :m] = (24 * scale).astype(np.float32)
        c[s, :m] = rng.normal(-3, 1, m).astype(np.float32)
        valid[s, :m] = True
    return x, y, w, w.copy(), c, valid


def test_group_twin_equals_reference(rng):
    x, y, w, h, c, valid = _clustered(rng, 6, 24)
    want = jax.jit(jax.vmap(jd.group_candidates))(
        *(jnp.asarray(a) for a in (x, y, w, h, c, valid)))
    slots, best = group(*(torch.as_tensor(a) for a in (x, y, w, h, c,
                                                      valid)), 1)
    np.testing.assert_array_equal(slots["kept"].numpy(),
                                  np.asarray(want["kept"]))
    kept = np.asarray(want["kept"])
    assert kept.sum() > 6
    for k in ("x", "y", "width", "height", "neighbors"):
        np.testing.assert_allclose(slots[k].numpy()[kept],
                                   np.asarray(want[k])[kept], rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(slots["confidence"].numpy()[kept],
                                  np.asarray(want["confidence"])[kept])
    # the pick: the kept slot of the largest confidence
    score = np.where(kept, np.asarray(want["confidence"]), -np.inf)
    i = np.argmax(score, 1)
    np.testing.assert_array_equal(best[0].numpy(), kept.any(1))
    np.testing.assert_array_equal(
        best[1].numpy(), slots["x"].numpy()[np.arange(6), i])


def test_detect_best_tie_goes_to_the_first_candidate():
    """Two equal faces (the same square at two places) score the same
    confidence: detect_best picks the one first in window order (the upper
    one), as the reference package does; so does the group twin on hand-made
    slots with equal confidences."""
    gray = np.full((1, 48, 64), 40, np.uint8)
    gray[0, 26:40, 36:50] = 200
    gray[0, 6:20, 8:22] = 200
    tables = td.detector_tables(64, 48, toy_cascade(), 5, "cpu")
    found, x, y, *_ = td.detect_best(torch.as_tensor(gray), tables)
    jf, jx, jy, *_ = jax.jit(lambda g: jd.detect_best(g, j_toy()))(
        jnp.asarray(gray[0]))
    assert bool(found[0]) and bool(jf)
    assert float(y[0]) < 20 and float(x[0]) < 30
    np.testing.assert_allclose([float(x[0]), float(y[0])],
                               [float(jx), float(jy)], rtol=1e-6)
    f32 = lambda a: torch.tensor([a], dtype=torch.float32)  # noqa: E731
    slots = (f32([100.0, 10.0, 200.0]), f32([50.0, 10.0, 20.0]),
             f32([24.0, 24.0, 24.0]), f32([24.0, 24.0, 24.0]),
             f32([-2.0, -1.5, -1.5]), torch.tensor([[True, True, True]]))
    _, (bf, bx, by, _, _, bc) = group(*slots, 1)
    # grouped: (2 x + n) / 2n, the first of the two -1.5 slots
    assert bool(bf[0]) and float(bx[0]) == 10.5 and float(bc[0]) == -1.5
    _, (bf, bx, *_r) = group(*slots, 0)
    assert bool(bf[0]) and float(bx[0]) == 10.0


def test_models_exports_the_reference_names():
    import headtrackr_tpu.models as jm
    import headtrackr_tpu_torch.models as tm
    assert sorted(tm.__all__) == sorted(jm.__all__)
    for name in jm.__all__:
        assert getattr(tm, name) is getattr(td, name)
