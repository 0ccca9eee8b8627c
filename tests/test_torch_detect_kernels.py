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
from headtrackr_tpu_torch.kernels.cascade import cascade
from headtrackr_tpu_torch.kernels.group import group
from headtrackr_tpu_torch.kernels.pyramid import pyramid
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


def _emulate_plan(gray, plan):
    """The pyramid kernel's reads and writes in NumPy: each generation's
    jobs, a pixel at a time vectorized over the plane."""
    N = gray.shape[0]
    frame = gray.reshape(N, -1)
    scr = np.zeros((N, plan.S), np.uint8)
    out = np.zeros((N, plan.L), np.uint8)
    for first, end, _ in plan.gens:
        for j in plan.jobs[first:end]:
            src, sw, ow, oh, dw, dh, xt, yt, dst, off, row, col = j[:12]
            val = np.zeros((N, oh, ow), np.uint8)
            if src == -2:
                val[:] = gray
            elif dw > 0:
                s = frame if src == -1 else scr[:, src:]
                xi, xf = plan.xi[xt:xt + dw], plan.xf[xt:xt + dw]
                yi, yf = plan.yi[yt:yt + dh], plan.yf[yt:yt + dh]

                def px(r, c):
                    return s[:, r[:, None] * sw + c[None, :]].astype(np.float32)

                top = (px(yi[:, 0], xi[:, 0]) * xf[:, 0] +
                       px(yi[:, 0], xi[:, 1]) * xf[:, 1])
                bot = (px(yi[:, 1], xi[:, 0]) * xf[:, 0] +
                       px(yi[:, 1], xi[:, 1]) * xf[:, 1])
                v = top * yf[:, None, 0] + bot * yf[:, None, 1]
                val[:, :dh, :dw] = np.round(np.clip(v, 0, 255))
            r, c = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
            (scr if dst == 0 else out)[:, off + r * row + c * col] = val
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


@pytest.mark.parametrize("shape", [(48, 64), (57, 99), (240, 320)])
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
    np.testing.assert_array_equal(_emulate_plan(gray, plan), got)
    assert plan.L == tables.L and torch.equal(
        tables.plan.jobs, torch.as_tensor(plan.jobs))
    # the reference package's planes: within one u8 step (F1)
    pyr_j = jax.jit(lambda g: ji.build_pyramid(g)[0])(jnp.asarray(gray[0]))
    packed_j = _pack_oracle({k: np.asarray(v) for k, v in pyr_j.items()},
                            tables)
    assert np.abs(packed_j.astype(int) - got[0]).max() <= 1


def test_pyramid_plan_rows_are_the_kernels():
    """The plan's job rows have the columns csrc/pyramid.cu reads."""
    import pathlib
    import re
    src = (pathlib.Path(ti.__file__).parent.parent / "csrc"
           / "pyramid.cu").read_text()
    cols = int(re.search(r"constexpr int kCols = (\d+);", src).group(1))
    names = re.search(r"enum \{([^}]*)\}", src).group(1).replace(
        " ", "").replace("\n", "").split(",")
    assert cols == ti.JOB_COLS == len(names)
    assert names.index("kStart") == ti.JOB_START
    tables = td.detector_tables(64, 48, toy_cascade(), 5, "cpu")
    assert tuple(tables.plan.jobs.shape) == (len(tables.plan.jobs), cols)


def _cascade_emulated(buf, tables, capacity):
    """The cascade kernels' table reads in NumPy: every window through the
    stages by the (K, 10) feature codes, then the first ``capacity``
    survivors in window order."""
    feat, alpha = tables.feat.numpy(), tables.alpha.numpy()
    thresh, ends = tables.thresh.numpy(), tables.stage_end.numpy()
    base, rstep = tables.base32.numpy(), tables.rowstep32.numpy()
    M = tables.M
    ok = feat >= 0
    z, x, y = (np.where(ok, a, 0) for a in (feat & 3, (feat >> 2) & 63,
                                              feat >> 8))
    out = []
    for b in buf:
        alive = np.ones(M, bool)
        conf = np.zeros(M)
        k0 = 0
        for s, k1 in enumerate(ends):
            zz, xx, yy, okk = z[k0:k1], x[k0:k1], y[k0:k1], ok[k0:k1]
            w = np.nonzero(alive)[0]
            bz = base[w][:, zz]            # (windows, k, 10)
            rz = rstep[w][:, zz]
            px = b[bz + yy * rz + xx].astype(int)
            pmin = np.where(okk[:, :5], px[..., :5], 255).min(-1)
            nmax = np.where(okk[:, 5:], px[..., 5:], 0).max(-1)
            votes = np.where(pmin > nmax, alpha[k0:k1, 1], alpha[k0:k1, 0])
            ssum = votes.astype(np.float64).sum(-1)
            conf[w] = ssum
            alive[w] = ssum >= np.float64(thresh[s])
            k0 = k1
        idx = np.nonzero(alive)[0]
        out.append((idx[:capacity], conf[idx[:capacity]].astype(np.float32),
                    max(idx.size - capacity, 0)))
    return out


@pytest.mark.parametrize("casc,shape", [(toy_cascade, (48, 64)),
                                        (frontalface, (60, 80))])
def test_cascade_tables_emulated_equal_twin(casc, shape, rng):
    H, W = shape
    gray = torch.as_tensor(rng.integers(0, 256, (2, H, W), np.uint8))
    gray[1] = torch.as_tensor(_toy_frames(H, W)[0]) if H == 48 else gray[1]
    tables = td.detector_tables(W, H, casc(), 5, "cpu")
    buf = pyramid(gray, tables)
    for cap in (256, 3):
        got = cascade(buf, tables, cap)
        for n, (idx, conf, ovf) in enumerate(
                _cascade_emulated(buf.numpy(), tables, cap)):
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
                                capacity=k_cand).items()}
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
    g = td.detect_objects_padded(torch.as_tensor(gray), tables, 1,
                                 capacity=k_cand)
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
