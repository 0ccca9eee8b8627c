"""The ``meanshift`` kernel's plain twin (ops/meanshift.py, the CPU path of
kernels/meanshift.py) against the JAX package's ``_mean_shift_core``
(``exact=True``, vmapped over the streams; one compile per shape):

  * pdfs of quarter steps, on which every sum is exact in f32 whatever the
    order: windows, escapes, zero mass and all twelve moments bit-equal,
    full frame and band;
  * real backprojection pdfs (seeded blob frames through the port's
    histogram and backprojection twins): windows, escapes and zero mass
    exact, moments within rtol 1e-5 / atol 1e-4 (the two sum in different
    orders);
  * the edge cases, bit-equal: zero mass, an empty window, a window partly
    off the frame, escapes in iteration 1 and in iteration 5, a fixed point
    in iteration 1 (the iteration counts checked by running the twin with
    fewer iterations);
  * a stream's result alone equals its result in a batch of 6;
  * the stated order: f64 running sums rounded to f32 (where an f32
    running sum differs), and adjacent pairs in the tree;
  * the twin at 480x640 on 2 streams (2x nearest-neighbour upsampled
    backprojections, the card phase's new shape): windows, escapes and
    zero mass exact, moments within rtol 1e-5 / atol 1e-4;
  * the kernels' route and the cluster kernel's strips (the Python mirror
    of csrc/meanshift.cu's layouts): every row and column in exactly one
    CTA's strip, strip boundaries on 32-element segments, each shape's
    kernel and its shared-memory budget;
  * the wrapper's checks and its device dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu_torch.kernels import meanshift as kms
from headtrackr_tpu_torch.kernels.meanshift import MAX_SIDE, mean_shift
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.ops import histogram as thg
from headtrackr_tpu_torch.ops import meanshift as oms

torch.set_num_threads(2)

H, W = 60, 80
BAND = (40, 56)
N = 6
_CORE = {}


def _jax_core(pdf, win, ry, rx, frame=(H, W)):
    """The reference's _mean_shift_core over a batch of streams (numpy in,
    numpy out) in a frame of ``frame`` (H, W); one jit a pdf shape."""
    fh, fw = frame
    core = _CORE.setdefault((pdf.shape[1:], frame), jax.jit(jax.vmap(
        lambda p, w, y, x: jcs._mean_shift_core(p, w, True, y, x, fh, fw))))
    w, m, z, e = core(jnp.asarray(pdf), jnp.asarray(win), jnp.asarray(ry),
                      jnp.asarray(rx))
    return (np.asarray(w), {k: np.asarray(v) for k, v in m.items()},
            np.asarray(z), np.asarray(e))


def _twin(pdf, win, ry=None, rx=None, frame=(H, W)):
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    w, m, z, e = oms.mean_shift_plain(t(pdf), t(win), t(ry), t(rx), frame)
    return (w.numpy(), {k: v.numpy() for k, v in m.items()}, z.numpy(),
            e.numpy())


def _assert_bits(a, b, what):
    """Equal to the bit, NaN where NaN (its sign and payload aside)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), what)
        a = np.where(np.isnan(a), 0, a).view(np.int32)
        b = np.where(np.isnan(b), 0, b).view(np.int32)
    np.testing.assert_array_equal(a, b, what)


# the central moments: mu = a - b * c (mu11 the JS quirk m11 - m01 * xc)
CENTRAL = {"mu20": ("m20", "m10", "xc"), "mu02": ("m02", "m01", "yc"),
           "mu11": ("m11", "m01", "xc")}


def _assert_same(got, want, exact_moments=True):
    """Windows and flags exact; moments to the bit (exact_moments) or
    within rtol 1e-5 / atol 1e-4, the central moments relative to their
    terms.  Bit for bit, the central moments differ
    by one rounding: XLA:CPU contracts the reference's a - b * c into a
    fused multiply-add, which the twin (and the kernel, F1) does not.  So
    each side is checked against its own formula on the twin's moments."""
    for what, a, b in (("window", got[0], want[0]),
                       ("zero_mass", got[2], want[2]),
                       ("escaped", got[3], want[3])):
        np.testing.assert_array_equal(a, b, what)
    m = got[1]
    for k in oms.MOMENTS:
        if not exact_moments and k in CENTRAL:
            # a difference of near-equal terms (mu11 ~5 from terms ~1e3):
            # its rounding is the terms', so the tolerance scales with them
            a, b, c = (m[v].astype(np.float64) for v in CENTRAL[k])
            scale = np.abs(a) + np.abs(b * c)
            ok = np.isnan(want[1][k]) | (np.abs(m[k] - want[1][k])
                                         <= 1e-5 * scale + 1e-4)
            assert ok.all() and np.array_equal(np.isnan(m[k]),
                                               np.isnan(want[1][k])), k
        elif not exact_moments:
            np.testing.assert_allclose(m[k], want[1][k], rtol=1e-5,
                                       atol=1e-4, err_msg=k)
        elif k in CENTRAL:
            a, b, c = (m[v] for v in CENTRAL[k])
            _assert_bits(m[k], a - b * c, k)  # two f32 roundings
            fused = (a.astype(np.float64) - b.astype(np.float64) * c)
            _assert_bits(want[1][k], fused.astype(np.float32), k)
        else:
            _assert_bits(m[k], want[1][k], k)


def _quarter_pdfs(rng):
    pdf = np.zeros((N, H, W), np.float32)
    for k in range(N):
        cy, cx = rng.integers(15, H - 15), rng.integers(15, W - 15)
        pdf[k, cy - 9:cy + 9, cx - 7:cx + 7] = rng.integers(0, 5, (18, 14)) / 4
    pdf[5] = 0  # a zero-mass stream
    win = np.stack([rng.integers(0, W - 20, N), rng.integers(0, H - 20, N),
                    rng.integers(8, 30, N), rng.integers(8, 30, N)],
                   1).astype(np.int32)
    return pdf, win


def _band_of(pdf, win):
    """(band pdfs, ry, rx) of band_rect's placement for each window."""
    ry, rx, _, _ = tcs.band_rect(torch.as_tensor(win), BAND, (H, W))
    ry, rx = ry.numpy(), rx.numpy()
    part = np.stack([p[y:y + BAND[0], x:x + BAND[1]]
                     for p, y, x in zip(pdf, ry, rx)])
    return np.ascontiguousarray(part), ry, rx


@pytest.mark.parametrize("band", [False, True])
def test_twin_matches_reference_on_quarter_steps(rng, band):
    pdf, win = _quarter_pdfs(rng)
    if band:
        pdf, ry, rx = _band_of(pdf, win)
        got = _twin(pdf, win, ry, rx)
    else:
        ry = rx = np.zeros(N, np.int32)
        got = _twin(pdf, win)
    _assert_same(got, _jax_core(pdf, win, ry, rx))
    assert got[2][5] and not got[2][:5].all()


def _blob_frame(rng, cx, cy):
    f = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
    f[max(0, cy - 8):cy + 8, max(0, cx - 6):cx + 6] = (215, 80, 60)
    f[max(0, cy - 8):cy + 8, max(0, cx - 6):cx + 6, 0] += rng.integers(
        0, 30, f[max(0, cy - 8):cy + 8, max(0, cx - 6):cx + 6, 0].shape,
        dtype=np.uint8)
    return f


@pytest.mark.parametrize("band", [False, True])
def test_twin_matches_reference_on_backprojections(rng, band):
    """pdfs as the tracker makes them: the model histogram of each stream's
    detection box, the ratio weights against the next frame's histogram,
    the backprojection (full frame, or the band at band_rect's origin)."""
    centers = [(20 + 8 * k, 18 + 4 * k) for k in range(N)]
    f0 = np.stack([_blob_frame(rng, cx, cy) for cx, cy in centers])
    f1 = np.stack([_blob_frame(rng, cx + 3, cy - 2) for cx, cy in centers])
    win = np.array([[cx - 6, cy - 8, 12, 16] for cx, cy in centers],
                   np.int32)
    win[4, 2:] = (30, 40)  # a window larger than the band: escapes
    model = thg.histogram_rects(torch.as_tensor(f0), torch.as_tensor(win))
    frames = torch.as_tensor(f1)
    cur = thg.hist4096_plain(frames, thg.full_rects(N, (H, W), "cpu")).float()
    weights = thg.backprojection_weights(model, cur)
    if band:
        ry, rx, bh, bw = tcs.band_rect(torch.as_tensor(win), BAND, (H, W))
        pdf = thg.backproject_plain(frames, weights,
                                    tcs.band_rects(ry, rx, bh, bw), BAND)
        ry, rx = ry.numpy(), rx.numpy()
        got = _twin(pdf.numpy(), win, ry, rx)
        assert got[3][4] and not got[3][:4].any()
    else:
        pdf = thg.backproject_plain(frames, weights)
        ry = rx = np.zeros(N, np.int32)
        got = _twin(pdf.numpy(), win)
    want = _jax_core(pdf.numpy(), win, ry, rx)
    _assert_same(got, want, exact_moments=False)
    assert (got[0][:, :2] != win[:, :2]).any()  # the windows moved


def test_twin_matches_reference_at_480x640(rng):
    """Two streams of 480x640 pdfs, as chip_smoke's new case makes them:
    240x320 backprojections (a blob frame's model histogram of its box,
    weighed against the next frame's histogram) upsampled 2x by nearest
    neighbour, windows the boxes doubled.  Windows, escapes and zero mass
    exact; moments within rtol 1e-5 / atol 1e-4 (the central moments
    relative to their terms): the reference's prefix sums are f32 matmuls,
    the twin's f64 running sums."""
    fh, fw, n = 240, 320, 2
    centers = [(150, 100), (90, 160)]
    frames = []
    for dx, dy in ((0, 0), (4, -3)):
        fr = rng.integers(0, 60, (n, fh, fw, 3), dtype=np.uint8)
        for k, (cx, cy) in enumerate(centers):
            fr[k, cy + dy - 20:cy + dy + 20, cx + dx - 15:cx + dx + 15] = (
                215, 80, 60)
        frames.append(torch.as_tensor(fr))
    box = np.array([[cx - 15, cy - 20, 30, 40] for cx, cy in centers],
                   np.int32)
    model = thg.histogram_rects(frames[0], torch.as_tensor(box))
    cur = thg.hist4096_plain(frames[1],
                             thg.full_rects(n, (fh, fw), "cpu")).float()
    pdf = thg.backproject_plain(frames[1],
                                thg.backprojection_weights(model, cur))
    pdf = pdf.repeat_interleave(2, 1).repeat_interleave(2, 2).numpy()
    win = 2 * box
    zero = np.zeros(n, np.int32)
    got = _twin(pdf, win, frame=(2 * fh, 2 * fw))
    _assert_same(got, _jax_core(pdf, win, zero, zero, (2 * fh, 2 * fw)),
                 exact_moments=False)
    assert (got[0][:, :2] != win[:, :2]).any() and not got[2].any()


ROUTE_SHAPES = [(1, 1), (57, 99), (96, 128), (128, 192), (240, 320),
                (480, 640), (1024, 1024)]


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_strips_cover_each_row_and_column_once(c):
    """The cluster kernel's split of each side: c strips in order, every
    row and column in exactly one, every boundary on a 32-element segment
    (or the side's end), none wider than the layout's room."""
    for bh, bw in ROUTE_SHAPES:
        for side in (bh, bw):
            most = 32 * -(-(-(-side // 32)) // c)  # ceil(segments / c)
            st = kms.strips(side, c)
            assert len(st) == c and st[0][0] == 0 and st[-1][1] == side
            held = np.zeros(side, int)
            for (lo, hi), nxt in zip(st, st[1:] + [(side, side)]):
                assert hi == nxt[0] and lo <= hi
                assert lo % 32 == 0 or lo == side
                assert hi % 32 == 0 or hi == side
                assert hi - lo <= most
                held[lo:hi] += 1
            assert (held == 1).all()


def test_route_picks_the_stated_kernel():
    """On an H100, the sweep's winners (PERF.md): the cluster kernel over
    the 240x320 frame (16 CTAs a stream at one stream, 8 at 32 to 231:
    up to 7 waves of 33) and the 480x640 frame (16, up to 56 streams: 7
    waves of 8), the scratch kernel beyond (256 frames of 240x320, 128 of
    480x640) and beyond 16 CTAs' room (1024x1024); one CTA at the
    headline's 96x128 band and 256 streams, a cluster of 2 at 128x192 and
    256 streams; the budgets the source's header states."""
    want = {(1, 240, 320): 16, (32, 240, 320): 8, (192, 240, 320): 8,
            (231, 240, 320): 8, (232, 240, 320): kms.SCRATCH,
            (256, 240, 320): kms.SCRATCH, (1, 480, 640): 16,
            (56, 480, 640): 16, (57, 480, 640): kms.SCRATCH,
            (128, 480, 640): kms.SCRATCH,
            (256, 96, 128): kms.ONE_CTA, (256, 128, 192): 2,
            (256, 57, 99): kms.ONE_CTA, (1, 1, 1): kms.ONE_CTA,
            (1, 1024, 1024): kms.SCRATCH, (256, 1024, 1024): kms.SCRATCH}
    for (n, bh, bw), c in want.items():
        assert kms.route(n, bh, bw, kms.H100) == c, (n, bh, bw)
    smem = kms.H100.smem_cta
    kb = {c: kms.smem_bytes(240, 320, c) / 1024 for c in (2, 4, 8, 16)}
    assert kb[2] * 1024 > smem
    assert [round(kb[c]) for c in (4, 8, 16)] == [178, 107, 77]
    assert round(kms.smem_bytes(480, 640, 16) / 1024) == 210
    assert kms.smem_bytes(480, 640, 8) > smem
    assert kms.smem_bytes(1024, 1024, 16) > smem
    assert kms.smem_bytes(96, 128, kms.ONE_CTA) <= smem // 2
    assert kms.smem_bytes(128, 192, kms.ONE_CTA) <= smem


def _edge_batch():
    """Six band pdfs (40x56 at the given origins in a 60x80 frame) and
    windows, one edge case a stream:
      0 zero mass;                       1 an empty window (width 0);
      2 a window partly off the frame;   3 escapes in iteration 1;
      4 escapes in iteration 5;          5 a fixed point in iteration 1.
    Every value a quarter step: all sums exact."""
    bh, bw = BAND
    pdf = np.zeros((N, bh, bw), np.float32)
    ry = np.array([10, 10, 0, 10, 10, 10], np.int32)
    rx = np.array([12, 12, 0, 12, 12, 12], np.int32)
    pdf[1, 5:20, 10:30] = 0.75
    pdf[2, 0:12, 0:10] = np.arange(10, dtype=np.float32) / 4
    pdf[3, 10:20, 40:56] = 0.5
    # a mass doubling every two columns pulls the window 2 px right an
    # iteration: from x = 49 its right edge passes the band's (frame x 68)
    # in iteration 5
    pdf[4, :, 36:] = 2.0 ** (np.arange(36, bw) // 2 - 20)
    pdf[5, 12:22, 20:32] = 1.0  # symmetric about the window's centre
    win = np.array([[20, 20, 12, 10], [20, 20, 0, 10], [-5, -3, 12, 10],
                    [62, 22, 12, 10], [49, 20, 12, 10], [32, 22, 12, 10]],
                   np.int32)
    return pdf, win, ry, rx


def test_edge_cases_match_reference():
    pdf, win, ry, rx = _edge_batch()
    got = _twin(pdf, win, ry, rx)
    _assert_same(got, _jax_core(pdf, win, ry, rx))
    w, m, zero, esc = got
    assert zero.tolist() == [True, True, False, False, False, False]
    assert esc.tolist() == [False, False, False, True, True, False]
    np.testing.assert_array_equal(w[0], win[0])  # no mass: no move
    assert np.isnan(m["xc"][0]) and np.isinf(m["invM00"][0])
    assert m["m00"][1] == 0 and m["m11"][1] == 0
    assert (w[2, :2] >= 0).all() and m["m00"][2] > 0
    np.testing.assert_array_equal(w[5], win[5])  # did not move


@pytest.mark.parametrize("iters,esc4,fixed5", [(1, False, True),
                                               (4, False, True),
                                               (5, True, True)])
def test_edge_cases_stop_where_stated(monkeypatch, iters, esc4, fixed5):
    """The twin run for fewer iterations: stream 3 escapes in iteration 1,
    stream 4 first in iteration 5; stream 5's iteration-1 result is its
    final one."""
    pdf, win, ry, rx = _edge_batch()
    full = _twin(pdf, win, ry, rx)
    monkeypatch.setattr(oms, "MEANSHIFT_ITERS", iters)
    w, m, _, esc = _twin(pdf, win, ry, rx)
    assert esc[3] and esc[4] == esc4
    assert (w[4, 0] == win[4, 0] + 2 * iters) == (iters < 5)
    if fixed5:
        np.testing.assert_array_equal(w[5], full[0][5])
        for k in oms.MOMENTS:
            _assert_bits(m[k][5], full[1][k][5], k)


@pytest.mark.parametrize("band", [False, True])
def test_stream_alone_equals_stream_in_batch(rng, band):
    pdf, win = _quarter_pdfs(rng)
    pdf = pdf + rng.random(pdf.shape, dtype=np.float32) / 7  # inexact sums
    ry = rx = None
    if band:
        pdf, ry, rx = _band_of(pdf, win)
    batch = _twin(pdf, win, ry, rx)
    for n in range(N):
        one = _twin(pdf[n:n + 1], win[n:n + 1],
                    None if ry is None else ry[n:n + 1],
                    None if rx is None else rx[n:n + 1])
        for a, b in zip((one[0], one[2], one[3]),
                        (batch[0], batch[2], batch[3])):
            np.testing.assert_array_equal(a[0], b[n])
        for k in oms.MOMENTS:
            _assert_bits(one[1][k][0], batch[1][k][n], k)


def test_prefix_sums_are_f64_running_sums():
    """1 then four 2**-25 down a column: an f64 running sum rounded to f32
    gives 1 + 2**-23, the twin's (and the kernel's) value, whichever device
    it runs on.  An f32 running sum would stay at 1 (each add rounds back),
    as an f32 scan in another order may.  The window's mass is the
    difference of the sums at its edges."""
    tiny = np.float32(2.0 ** -25)
    pdf = np.zeros((1, 5, 4), np.float32)
    pdf[0, :, 0] = [1, tiny, tiny, tiny, tiny]
    col, row = oms.prefix_planes(torch.as_tensor(pdf))
    assert col.shape == (1, 6, 4) and row.shape == (1, 5, 5)
    want = [np.float32(1 + k * 2.0 ** -25) for k in range(5)]
    assert col[0, :, 0].tolist() == [0.0] + [float(v) for v in want]
    assert want[-1] == np.float32(1 + 2.0 ** -23)
    f32_run = np.float32(0)
    for v in pdf[0, :, 0]:
        f32_run = np.float32(f32_run + v)
    assert f32_run == 1  # what an f32 running sum would give instead
    assert row[0, :, 1].tolist() == [1] + [float(tiny)] * 4
    _, m, zero, _ = oms.mean_shift_plain(
        torch.as_tensor(pdf), torch.tensor([[0, 0, 4, 5]], dtype=torch.int32))
    assert float(m["m00"][0]) == float(want[-1]) and not zero[0]


def test_tree_sum_adds_adjacent_pairs():
    """[1, e, 0, e] with e = 2**-24: adjacent pairs give (1 + e) + (0 + e),
    each rounding to 1; halving pairs ((1 + 0) + (e + e)) would give
    1 + 2**-23.  A ragged length pads with zeros."""
    e = 2.0 ** -24
    v = torch.tensor([[1, e, 0, e], [e, e, 1, 0]], dtype=torch.float32)
    assert oms.tree_sum(v).tolist() == [1.0, 1.0 + 2 * e]
    assert oms.tree_sum(torch.arange(7, dtype=torch.float32)).item() == 21
    assert oms.tree_sum(torch.ones((3, 1))).tolist() == [1, 1, 1]


def test_camshift_mean_shift_is_the_wrapper(monkeypatch):
    """models/camshift.mean_shift (the reference's three outputs) dispatches
    through the kernel's wrapper: on CPU tensors, the twin."""
    calls = []
    monkeypatch.setattr(kms, "mean_shift",
                        lambda *a: calls.append(a) or mean_shift(*a))
    rng = np.random.default_rng(3)
    pdf, win = _quarter_pdfs(rng)
    got = mean_shift(torch.as_tensor(pdf), torch.as_tensor(win))
    want = _twin(pdf, win)
    for a, b in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_array_equal(a.numpy(), b)
    for k in oms.MOMENTS:
        _assert_bits(got[1][k].numpy(), want[1][k], k)
    three = tcs.mean_shift(torch.as_tensor(pdf), torch.as_tensor(win))
    assert len(calls) == 1 and len(three) == 3
    for a, b in zip((three[0], three[2]), (want[0], want[2])):
        np.testing.assert_array_equal(a.numpy(), b)
    for k in oms.MOMENTS:
        _assert_bits(three[1][k].numpy(), want[1][k], k)


def test_wrapper_rejects_what_it_does_not_take():
    pdf = torch.zeros((2, 8, 8))
    win = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="pdf"):
        mean_shift(pdf.double(), win)
    with pytest.raises(ValueError, match="pdf"):
        mean_shift(torch.zeros((2, 8, MAX_SIDE + 1)), win)
    with pytest.raises(ValueError, match="window"):
        mean_shift(pdf, win.long())
    with pytest.raises(ValueError, match="fit the frame"):
        mean_shift(pdf, win, (4, 8))  # a band larger than its frame
    with pytest.raises(TypeError):  # the kernel places the band: no origins
        mean_shift(pdf, win, torch.zeros((2,), dtype=torch.int32),
                   torch.zeros((2,), dtype=torch.int32), (8, 8))
    with pytest.raises(ValueError, match="no kernel"):  # no CPU fallback
        mean_shift(pdf.to("meta"), win.to("meta"))
