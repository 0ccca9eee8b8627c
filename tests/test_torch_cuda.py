"""The port's CUDA kernels and serving tick on the card, held against their
plain PyTorch twins on the CPU.  Marked ``cuda``: they skip without a card.
The JAX reference is not needed here, so on a machine without jax run them
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from headtrackr_tpu_torch import BatchedTracker, toy_cascade
from headtrackr_tpu_torch.kernels import histpdf as K
from headtrackr_tpu_torch.kernels.launch import launches
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.ops import histogram as hg

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(240, 320), (57, 99)])
def test_kernels_bit_equal_to_twins(dev, shape):
    g = torch.Generator().manual_seed(3)
    N = 8
    frames = torch.randint(0, 256, (N,) + shape + (3,), generator=g,
                           dtype=torch.uint8)
    frames[:4, : shape[0] // 2] = torch.tensor([120, 100, 90], dtype=torch.uint8)
    rects = torch.cat([torch.randint(-10, 60, (N, 2), generator=g),
                       torch.randint(0, 80, (N, 2), generator=g)], 1).int()
    rects[0] = torch.tensor([0, 0, shape[1], shape[0]])
    w = torch.rand((N, 4096), generator=g)
    before = dict(launches)
    got_h = K.hist4096(frames.to(dev), rects.to(dev))
    got_p = K.backproject(frames.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert launches["hist4096"] == before["hist4096"] + 1
    assert launches["backproject"] == before["backproject"] + 1
    assert torch.equal(got_h.cpu(), hg.hist4096_plain(frames, rects).float())
    assert torch.equal(got_p.cpu(), hg.backproject_plain(frames, w))


@pytest.mark.parametrize("shape,band", [((240, 320), (96, 128)),
                                        ((57, 99), (24, 40)),
                                        ((240, 320), (240, 320))])
def test_band_kernels_bit_equal_to_twins(dev, shape, band):
    """histpdf_band (both modes) and backproject_rect against their twins;
    the band kernels take the rects as search windows and place each band
    (band_rect's rule), the twins read band_rect's rects."""
    g = torch.Generator().manual_seed(5)
    N = 8
    frames = torch.randint(0, 256, (N,) + shape + (3,), generator=g,
                           dtype=torch.uint8)
    frames[:4, : shape[0] // 2] = torch.tensor([120, 100, 90], dtype=torch.uint8)
    # windows inside and outside the frame (bands clipped by both sides)
    rects = torch.cat([torch.randint(-20, shape[1], (N, 1), generator=g),
                       torch.randint(-20, shape[0], (N, 1), generator=g),
                       torch.randint(0, 80, (N, 2), generator=g)], 1).int()
    placed = _placed(rects, band, shape)
    model = torch.randint(0, 200, (N, 4096), generator=g).float()
    model[:, :64] = 0
    w = torch.rand((N, 4096), generator=g)
    before = dict(launches)
    cur, pdf = K.histpdf_band(frames.to(dev), rects.to(dev), model.to(dev), band)
    hist = K.histpdf_band(frames.to(dev), rects.to(dev))
    bp = K.backproject(frames.to(dev), w.to(dev), rects.to(dev), band)
    torch.cuda.synchronize()
    for k in ("histpdf_band", "histpdf_band_hist", "backproject_rect"):
        assert launches[k] == before[k] + 1, k
    want_cur, want_pdf = hg.histpdf_band_plain(frames, placed, model, band)
    assert torch.equal(cur.cpu(), want_cur)
    assert torch.equal(pdf.cpu(), want_pdf)
    assert torch.equal(hist.cpu(), hg.histpdf_band_plain(frames, rects))
    assert torch.equal(bp.cpu(), hg.backproject_plain(frames, w, placed,
                                                      band))


def _placed(windows, band, shape):
    """band_rect's (N, 4) i32 band rects of the search windows: the rects
    form the twins read."""
    from headtrackr_tpu_torch.models import camshift as tcs
    return tcs.band_rects(*tcs.band_rect(windows, band, shape))


def _clip_windows(n, shape, g):
    """n search windows hitting every clip of the band placement: x or y
    below 0, past the right or bottom edge, negative and odd sizes, the
    whole frame and beyond (chip_smoke's clip_windows)."""
    from chip_smoke import clip_windows
    return clip_windows(n, shape, g, torch.device("cpu"))


@pytest.mark.parametrize("n", [1, 8, 256, 70000])
def test_placed_band_kernels_bit_equal(dev, n):
    """histpdf_band's pdf mode, backproject_rect and meanshift (every route
    that takes the band: one CTA, each cluster size, the scratch kernel)
    place each stream's band from its search window in the kernel: at
    windows that hit every clip, bit-equal to the rects / origins form of
    their twins run on the card at band_rect's placement, and to the
    placed twins on the CPU (the wrappers' own CPU path) at N <= 256.  At
    70,000 streams histpdf_band and backproject_rect split into launches
    of 65,535; the twins run in slices."""
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.models import camshift as tcs
    from headtrackr_tpu_torch.ops import meanshift as om
    H, W, band, step = 120, 160, (64, 96), 4096
    g = torch.Generator().manual_seed(n)
    pool = torch.randint(0, 256, (64, H, W, 3), generator=g,
                         dtype=torch.uint8)
    pool[::2, 30:90, 40:100] = torch.tensor([200, 80, 60], dtype=torch.uint8)
    fr = pool.to(dev)[torch.arange(n, device=dev) % 64]
    win = _clip_windows(n, (H, W), g).to(dev)
    model = torch.randint(0, 200, (n, 4096), generator=g).float().to(dev)
    w = torch.rand((n, 4096), generator=g).to(dev)
    rects = _placed(win, band, (H, W))
    ry, rx, _, _ = tcs.band_rect(win, band, (H, W))
    cur, pdf = K.histpdf_band(fr, win, model, band)
    bp = K.backproject(fr, w, win, band)
    for s in range(0, n, step):
        sl = slice(s, s + step)
        want_cur, want_pdf = hg.histpdf_band_plain(fr[sl], rects[sl],
                                                   model[sl], band)
        assert torch.equal(cur[sl], want_cur) and torch.equal(pdf[sl],
                                                              want_pdf)
        assert torch.equal(bp[sl], hg.backproject_plain(fr[sl], w[sl],
                                                        rects[sl], band))
    if n <= 256:
        cpu = torch.device("cpu")
        for a, b in zip((cur, pdf), K.histpdf_band(
                fr.cpu(), win.cpu(), model.cpu(), band)):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(bp.cpu(), K.backproject(fr.to(cpu), w.cpu(),
                                                   win.cpu(), band))
    card = kms.card(dev)
    routes = [c for c in (kms.ONE_CTA,) + kms.CLUSTER_SIZES
              if kms.smem_bytes(*band, c) <= card.smem_cta] + [kms.SCRATCH]
    want = [om.mean_shift_plain(pdf[s:s + step], win[s:s + step],
                                ry[s:s + step], rx[s:s + step], (H, W))
            for s in range(0, n, step)]
    placed_cpu = (kms.mean_shift(pdf.cpu(), win.cpu(), (H, W)) if n <= 256
                  else None)
    for c in routes:
        got = kms.launch_kernel(c, pdf, win, (H, W))
        for k, s in enumerate(range(0, n, step)):
            part = tuple(v[s:s + step] if torch.is_tensor(v)
                         else {m: v[m][s:s + step] for m in v} for v in got)
            _meanshift_equal(part, want[k])
        if placed_cpu is not None:
            _meanshift_equal(tuple(v.cpu() if torch.is_tensor(v) else
                                   {m: v[m].cpu() for m in v} for v in got),
                             placed_cpu)


def test_kernel_rejects_what_it_does_not_take(dev):
    frames = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)
    rects = hg.full_rects(2, (8, 8), dev)
    with pytest.raises(ValueError):  # not contiguous
        K.hist4096(frames.transpose(1, 2), rects)
    with pytest.raises(ValueError):  # wrong table width
        K.backproject(frames, torch.zeros((2, 4095), device=dev))
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        K.backproject(frames, torch.zeros(2 * 4096 + 1, device=dev)[1:]
                      .view(2, 4096))
    with pytest.raises(ValueError):  # model not 16-byte aligned
        K.histpdf_band(frames, rects, torch.zeros(2 * 4096 + 1, device=dev)
                       [1:].view(2, 4096), (4, 4))
    with pytest.raises(ValueError):  # band larger than the frame
        K.histpdf_band(frames, rects, torch.zeros((2, 4096), device=dev),
                       (9, 8))
    # a launch the card refuses raises, as does a cluster size the C
    # launcher does not take
    from headtrackr_tpu_torch.kernels.build import load_library
    out = torch.empty((2, 4096), device=dev)
    fn = load_library().fn("hist4096_launch")
    stream = torch.cuda.current_stream().cuda_stream
    for c in (3, 32):
        assert fn(frames.data_ptr(), rects.data_ptr(), out.data_ptr(), 2, 8,
                  8, c, 0, 0, stream) != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        from headtrackr_tpu_torch.kernels.launch import launch
        launch("hist4096", "hist4096_launch", frames.data_ptr(),
               rects.data_ptr(), out.data_ptr(), 2, 8, 8, 3, 0, 0)


def test_serving_tick_card_equals_cpu(dev):
    H, W = 120, 160

    def frame(cx, cy):
        f = np.full((H, W, 3), 40, np.uint8)
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
        return f

    blue = np.zeros((H, W, 3), np.uint8)
    blue[..., 2] = 250
    clip = ([frame(60, 50)] * 16 + [frame(60 + t, 50) for t in range(10)]
            + [blue] * 2 + [frame(80, 60)] * 8)
    clip = np.stack([np.stack([f, np.roll(f, 20, axis=1)]) for f in clip])
    for kw in ({}, dict(band=(64, 96), bandHist=True, bucket=1)):
        _card_equals_cpu(dev, clip, (H, W), kw)


def _card_equals_cpu(dev, clip, shape, kw):
    outs = []
    for d in (dev, torch.device("cpu")):
        bt = BatchedTracker(2, shape, cascade=toy_cascade(), device=d, **kw)
        outs.append([[t.cpu().numpy() for t in bt.step(f)] for f in clip])
    # a tracker on the card pins full-f32 matmuls and convolutions (no TF32)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    for a_t, b_t in zip(*outs):
        for a, b in zip(a_t, b_t):
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,dim,idx_shape", [
    ((1, 8, 128), 2, (1, 8, 128)),      # X8's own lane gather
    ((8, 97, 128), 1, (8, 2, 1)),       # mean shift's rows of col_cum
    ((8, 96, 129), 2, (8, 1, 2)),       # and columns of row_cum
    ((8, 241, 320), 1, (8, 5, 320)),
    ((3, 7, 9), 2, (3, 7, 4))])
def test_take_along_bit_equal_to_twin(dev, shape, dim, idx_shape):
    from headtrackr_tpu_torch.kernels.gather import take_along
    from headtrackr_tpu_torch.ops.gather import take_along_plain
    g = torch.Generator().manual_seed(9)
    src = torch.rand(shape, generator=g)
    idx = torch.randint(0, shape[dim], idx_shape, generator=g,
                        dtype=torch.int32)
    before = launches["take_along"]
    got = take_along(src.to(dev), idx.to(dev), dim)
    torch.cuda.synchronize()
    assert launches["take_along"] == before + 1
    assert torch.equal(got.cpu(), take_along_plain(src, idx, dim))


def _serving_clip(H, W, n, tall=4):
    """Faces drifting right; stream 1 loses track at tick 20; every
    ``tall``-th stream from stream ``tall`` - 1 (streams 3 and 7 of 8)
    carries a face taller than a 64-row band (an escape every band
    tick)."""
    def frame(cx, cy, half):
        f = np.full((H, W, 3), 40, np.uint8)
        f[cy - half:cy + half, cx - half:cx + half] = (230, 80, 60)
        return f

    blue = np.zeros((H, W, 3), np.uint8)
    blue[..., 2] = 250
    clip = []
    for t in range(30):
        clip.append(np.stack([
            blue if (s, t) == (1, 20) else
            np.roll(frame(60 + t % 5, 55, 26 if s % tall == tall - 1
                          else 12), 10 * (s % 8), axis=1)
            for s in range(n)]))
    return np.stack(clip)


@pytest.mark.parametrize("kw", [{}, dict(band=(64, 96), bandHist=True)])
def test_graph_replayed_ticks_equal_host_step(dev, kw):
    """step_auto and run_scan (each call one launch of the serving
    program) against the eager step(sync=True) at sync_interval 1, 8
    streams, on the card: the lock, steady ticks, a loss and its relock,
    and with the band the escape fallback on the card."""
    H, W, n = 120, 160, 8
    clip = _serving_clip(H, W, n)
    mk = lambda **k: BatchedTracker(n, (H, W), cascade=toy_cascade(),  # noqa: E731
                                    device=dev, bucket=2, **kw, **k)
    host, auto, scan = mk(sync_interval=1), mk(), mk().warmup()
    want = [[t.cpu().numpy() for t in host.step(f, sync=True)] for f in clip]
    before = dict(launches)
    got_auto = [[t.cpu().numpy() for t in auto.step_auto(f)] for f in clip]
    assert auto._graph is not None  # the program's all-CS body
    esc = np.stack([o[tft.StepOutput._fields.index("escaped")]
                    for o in got_auto])
    assert esc[-5:, [3, 7]].all() == bool(kw)  # escapes in the program
    assert launches["meanshift"] > before["meanshift"]
    assert launches["take_along"] == before["take_along"]
    out = scan.run_scan(clip[:13])
    out2 = scan.run_scan(torch.as_tensor(clip[13:]).to(dev))
    got_scan = [[v[k].cpu().numpy() for v in o] for o in (out, out2)
                for k in range(o.mode_after.shape[0])]
    for got in (got_auto, got_scan):
        for t, (a_t, b_t) in enumerate(zip(want, got)):
            for a, b in zip(a_t, b_t):
                if a.dtype.kind in "biu":
                    np.testing.assert_array_equal(b, a, err_msg=f"tick {t}")
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                               err_msg=f"tick {t}")
    assert scan.modes.tolist() == [2] * n


@pytest.mark.parametrize("donate", [True, False])
def test_batched_steps_equal_tracker_on_the_card(dev, donate):
    """make_batched_steps' step_auto and step_scan against
    BatchedTracker.step_auto on the card, band and bandHist, 8 streams:
    every output of every tick bit-equal, through the lock, all-CS ticks
    with escapes, a loss and its relock.  donate=True hands back the
    program's state buffers (the same tree each tick); donate=False leaves
    the caller's state untouched and hands back a tree of its own."""
    from headtrackr_tpu_torch.runtime.serving import make_batched_steps
    H, W, n = 120, 160, 8
    clip = _serving_clip(H, W, n)
    kw = dict(bucket=2, band=(64, 96))
    bt = BatchedTracker(n, (H, W), cascade=toy_cascade(), device=dev,
                        bandHist=True, **kw)
    _, _, _, step_auto, step_scan = make_batched_steps(
        toy_cascade(), bt.config, (H, W), donate=donate, device=dev, **kw)
    state = tft.init_state(n, band_audit=True, device=dev)
    same_tree = []
    for t, f in enumerate(clip):
        want = bt.step_auto(f)
        before = [x.clone() for x in _leaves(state)]
        new, got = step_auto(state, f)
        if not donate:
            for a, b in zip(before, _leaves(state)):
                assert torch.equal(a, b), f"tick {t}: the state moved"
        same_tree.append(new is state)
        state = new
        for name, x, y in zip(tft.StepOutput._fields, want, got):
            assert torch.equal(x, y), f"tick {t} {name}"
    assert any(same_tree[-5:]) == donate  # the program's state buffers
    for x, y in zip(_leaves(bt.state), _leaves(state)):
        assert torch.equal(x, y)
    want, (state, got) = bt.run_scan(clip[:6]), step_scan(state, clip[:6])
    for name, x, y in zip(tft.StepOutput._fields, want, got):
        assert torch.equal(x, y), f"scan {name}"
    for x, y in zip(_leaves(bt.state), _leaves(state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw,hist,pdf", [
    ({}, "hist_mma", "backproject_ratio"),
    (dict(histKernel="pallas"), "hist4096", "backproject_ratio"),
    (dict(band=(64, 96)), "hist_mma", "backproject_rect_ratio"),
    (dict(band=(64, 96), bandHist=True), "histpdf_band", None)])
def test_graph_replay_counts_its_launches(dev, kw, hist, pdf):
    """One all-CS tick of the serving program adds the launches its
    all-CS body holds (one meanshift, no take_along, one histogram:
    hist_mma, the default histKernel's; hist4096, the "pallas" one's; or
    the band's cluster histpdf_band, which also makes the pdf; and one pdf,
    the ratio form, which forms the weights) and one launch of each
    schedule kernel the tick ran (escape_select only with a band; no
    scan_step: every all-CS body reads the tick's frames in place).  Three
    streams: the clip's fourth carries a face taller than the band."""
    H, W, n = 120, 160, 3
    clip = _serving_clip(H, W, n)
    bt = BatchedTracker(n, (H, W), cascade=toy_cascade(), device=dev, **kw)
    for f in clip[:18]:
        bt.step_auto(f)
    assert (bt.modes == 2).all() and bt._graph is not None
    before = dict(launches)
    bt.step_auto(clip[18])
    torch.cuda.synchronize()
    got = {k: launches[k] - before[k] for k in launches}
    sched = {"tick_select": 1, "scan_commit": 1,
             "escape_select": int("band" in kw)}
    assert got == {k: v + sched.get(k, 0)
                   for k, v in bt._graph.launches.items()}
    assert got["meanshift"] == 1 and got["take_along"] == 0
    assert got[hist] == 1
    if pdf is not None:
        assert got[pdf] == 1
    others = {"hist_mma", "hist4096", "histpdf_band", "backproject",
              "backproject_rect", "scan_step"} - {hist}
    assert all(got[k] == 0 for k in others)


@pytest.mark.parametrize("n", [1, 2, 3, 256])
@pytest.mark.parametrize("kind", ["random", "one_bin", "bench"])
def test_hist_mma_bit_equal_to_twin(dev, n, kind):
    from bench import build_pool
    from headtrackr_tpu_torch.kernels.histmma import hist_mma
    H, W = 240, 320
    g = torch.Generator().manual_seed(17)
    if kind == "random":
        frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                               dtype=torch.uint8)
    elif kind == "one_bin":
        frames = torch.tensor([120, 100, 90], dtype=torch.uint8).expand(
            n, H, W, 3).contiguous()
    else:
        frames = torch.as_tensor(build_pool(n, H, W, 2, 0,
                                            np.random.default_rng(0),
                                            face_noise=20)[1])
    boxes = torch.cat([torch.randint(-20, 300, (n, 2), generator=g),
                       torch.randint(0, 240, (n, 2), generator=g)], 1).int()
    for rects in (hg.full_rects(n, (H, W), "cpu"), boxes):
        before = launches["hist_mma"]
        got = hist_mma(frames.to(dev), rects.to(dev))
        torch.cuda.synchronize()
        assert launches["hist_mma"] == before + 1
        assert torch.equal(got.cpu(), hg.hist_mma_plain(frames, rects))
        assert torch.equal(got.cpu(), hg.hist4096_plain(frames, rects).float())


def test_hist_mma_odd_frames_and_views(dev):
    """Frames whose pixel count is not a multiple of 8 take the kernel's
    byte loads; a stream slice of a batch is a view at an offset."""
    from headtrackr_tpu_torch.kernels.histmma import hist_mma
    g = torch.Generator().manual_seed(19)
    frames = torch.randint(0, 256, (5, 57, 99, 3), generator=g,
                           dtype=torch.uint8)
    rects = torch.tensor([[0, 0, 99, 57], [-5, -3, 20, 20], [10, 7, 200, 200],
                          [3, 4, 0, 5], [98, 56, 1, 1]], dtype=torch.int32)
    got = hist_mma(frames.to(dev), rects.to(dev))
    assert torch.equal(got.cpu(), hg.hist_mma_plain(frames, rects))
    got = hist_mma(frames.to(dev)[3:], rects.to(dev)[3:])
    assert torch.equal(got.cpu(), hg.hist_mma_plain(frames[3:], rects[3:]))


@pytest.mark.parametrize("shape", [(57, 99), (241, 320), (48, 80), (7, 5)])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_hist_mma_ragged_frames(dev, shape, n):
    """Pixel counts off the kernel's 1,024-pixel stage and 128-pixel tile:
    with the bulk copies (241 x 320, 48 x 80: a multiple of 16 pixels) and
    without (57 x 99, 7 x 5); full frames and boxes, bit-equal to the twin
    and to hist4096."""
    from headtrackr_tpu_torch.kernels.histmma import hist_mma
    g = torch.Generator().manual_seed(31 + n)
    H, W = shape
    frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                           dtype=torch.uint8)
    frames[0, : H // 2] = torch.tensor([120, 100, 90], dtype=torch.uint8)
    boxes = torch.cat([torch.randint(-5, W, (n, 2), generator=g),
                       torch.randint(0, 2 * H, (n, 2), generator=g)], 1).int()
    for rects in (hg.full_rects(n, shape, "cpu"), boxes):
        got = hist_mma(frames.to(dev), rects.to(dev)).cpu()
        assert torch.equal(got, hg.hist_mma_plain(frames, rects))
        assert torch.equal(got, hg.hist4096_plain(frames, rects).float())


@pytest.mark.parametrize("shape,band", [((240, 320), (96, 128)),
                                        ((240, 320), (95, 127)),
                                        ((240, 320), (96, 131)),
                                        ((240, 320), (240, 320)),
                                        ((57, 99), (24, 41)),
                                        ((57, 99), (57, 99))])
def test_backproject_rect_origins_and_widths(dev, shape, band):
    """backproject_rect on windows of the band's size with x on the 8-pixel
    grid (the serving path's 4-pixel loop) and from -20 (the kernel places
    each band), odd band widths (origins clipped off the grid) and the
    whole frame, bit-equal to the twin at band_rect's rects; a view one
    stream in."""
    g = torch.Generator().manual_seed(37)
    H, W = shape
    bh, bw = band
    n = 16
    frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                           dtype=torch.uint8)
    w = torch.rand((n, 4096), generator=g)
    x = torch.randint(-20, W - bw + 21, (n,), generator=g)
    x[: n // 2] = x[: n // 2].clamp(0, W - bw) // 8 * 8
    rects = torch.stack([x, torch.randint(-20, H - bh + 21, (n,), generator=g),
                         torch.full((n,), bw), torch.full((n,), bh)], 1).int()
    before = launches["backproject_rect"]
    got = K.backproject(frames.to(dev), w.to(dev), rects.to(dev), band)
    torch.cuda.synchronize()
    assert launches["backproject_rect"] == before + 1
    placed = _placed(rects, band, shape)
    assert torch.equal(got.cpu(), hg.backproject_plain(frames, w, placed,
                                                       band))
    got = K.backproject(frames.to(dev)[1:], w.to(dev)[1:], rects.to(dev)[1:],
                        band)
    assert torch.equal(got.cpu(), hg.backproject_plain(frames[1:], w[1:],
                                                       placed[1:], band))


def test_session_tracker_card_equals_cpu(dev):
    """Tracker(debug=True) on the card and on the CPU over 24 frames: the
    same events (time excluded) and debug backprojection bytes."""
    import headtrackr_tpu_torch as pt
    H, W = 120, 160

    def frame(cx, cy):
        f = np.full((H, W, 3), 40, np.uint8)
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
        return f

    blue = np.zeros((H, W, 3), np.uint8)
    blue[..., 2] = 250
    clip = np.stack([frame(60, 50)] * 16 + [frame(60 + t, 50)
                                            for t in range(4)]
                    + [blue] + [frame(70, 55)] * 3)
    runs = []
    for d in (dev, "cpu"):
        bus = pt.events.EventBus()
        log, bps = [], []
        for ty in (pt.events.STATUS, pt.events.FACETRACKING,
                   pt.events.HEADTRACKING):
            bus.add_event_listener(ty, lambda e, ty=ty: log.append(
                (ty, {k: v for k, v in vars(e).items() if k != "time"})))
        t = pt.Tracker(ui=False, bus=bus, cascade=toy_cascade(), debug=True,
                       device=d)
        t.init(pt.ClipSource(clip), canvas=(W, H))
        while t.step_once() is not None:
            bps.append(t.get_debug()["backprojection"])
        runs.append((log, bps))
    (log_a, bp_a), (log_b, bp_b) = runs
    assert [ty for ty, _ in log_a] == [ty for ty, _ in log_b]
    for (_, a), (_, b) in zip(log_a, log_b):
        for k in b:
            if isinstance(b[k], str):
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4)
    assert len(bp_a) == len(clip) and sum(b is not None for b in bp_a) > 4
    for a, b in zip(bp_a, bp_b):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_replayed_outputs_survive_the_next_replay(dev):
    """A tick's StepOutput lives in output packs of its own launch, so
    holding tick t-1's outputs across tick t (BatchedSession's pipelined
    emission) is safe."""
    H, W, n = 120, 160, 4
    clip = _serving_clip(H, W, n)
    bt = BatchedTracker(n, (H, W), cascade=toy_cascade(), device=dev)
    for f in clip[:18]:
        bt.step_auto(f)
    assert (bt.modes == 2).all() and bt._graph is not None
    held = bt.step_auto(clip[18])
    snap = [v.clone() for v in held]
    nxt = bt.step_auto(clip[19])
    torch.cuda.synchronize()
    for a, b in zip(held, snap):
        assert torch.equal(a, b)
    assert not torch.equal(held.face_x, nxt.face_x)


@pytest.mark.parametrize("kind", ["x5", "bench", "random", "pads_tail", "n1"])
def test_hist_bins_bit_equal_to_twin(dev, kind):
    """hist_bins against its twin and against hist4096 of the same pixels:
    X5's workload (uniform random ids of shape (256, 8, 9600)), the bench
    pool's bins, uniform random frames' bins, rows of 76,799 ids with
    out-of-range ids among them (and the same rows off the 16-byte
    boundary), and N = 1."""
    from bench import build_pool
    from headtrackr_tpu_torch.kernels.histbins import hist_bins
    H, W, n = 240, 320, 256
    g = torch.Generator().manual_seed(29)
    if kind == "x5":
        ids = torch.as_tensor(np.random.default_rng(0).integers(
            0, 4096, (n, 8, 9600)).astype(np.int32)).view(n, -1)
        frames = torch.stack([(ids >> 8) << 4, ((ids >> 4) & 15) << 4,
                              (ids & 15) << 4], -1).view(n, H, W, 3).to(
                                  torch.uint8)
    elif kind == "pads_tail":
        frames = torch.randint(0, 256, (n, 1, H * W - 65, 3), generator=g,
                               dtype=torch.uint8)
        ids = torch.cat([hg.rgb_bins(frames).view(n, -1),
                         torch.tensor([-1, -64, 4096, 2 ** 31 - 1] * 16,
                                      dtype=torch.int32).expand(n, 64)], 1)
        ids = ids[:, torch.randperm(ids.shape[1], generator=g)].contiguous()
    else:
        if kind == "random":
            frames = torch.randint(0, 256, (n, H, W, 3), generator=g,
                                   dtype=torch.uint8)
        else:
            frames = torch.as_tensor(build_pool(n, H, W, 2, 0,
                                                np.random.default_rng(0))[1])
        if kind == "n1":
            frames = frames[:1].contiguous()
        ids = hg.rgb_bins(frames).view(frames.shape[0], -1)
    m = frames.shape[0]
    want = hg.hist4096_plain(frames, hg.full_rects(
        m, frames.shape[1:3], "cpu")).float()
    before = launches["hist_bins"]
    got = hist_bins(ids.to(dev))
    torch.cuda.synchronize()
    assert launches["hist_bins"] == before + 1
    assert torch.equal(got.cpu(), hg.hist_bins_plain(ids))
    assert torch.equal(got.cpu(), want)
    if kind == "pads_tail":  # a row that starts off the 16-byte boundary
        assert torch.equal(hist_bins(ids.to(dev)[1:]).cpu(),
                           hg.hist_bins_plain(ids[1:]))


@pytest.mark.parametrize("n", [1, 8, 256])
def test_hist_pallas_pdf_pallas_bit_equal_to_twins(dev, n):
    """The reference-named entry points on the card: hist_pallas launches
    hist_bins, pdf_pallas pdf_bins (one launch each, and no take_along),
    bit-equal to the twins on (n, 240, 320) bins with ids below 0 and from
    4096 up among them (counted nowhere, looked up as 0), and on one
    (240, 320) frame."""
    from headtrackr_tpu_torch.kernels import hist_pallas, pdf_pallas
    g = torch.Generator().manual_seed(16)
    bins = torch.randint(0, 4096, (n, 240, 320), generator=g).int()
    bins[:, 0, :6] = torch.tensor([-1, -64, 4096, 5000, -2 ** 31,
                                   2 ** 31 - 1], dtype=torch.int32)
    w = torch.rand((n, 4096), generator=g)
    want_p = hg.pdf_bins_plain(bins, w)
    before = dict(launches)
    h = hist_pallas(bins.to(dev))
    p = pdf_pallas(bins.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert launches["hist_bins"] == before["hist_bins"] + 1
    assert launches["pdf_bins"] == before["pdf_bins"] + 1
    assert launches["take_along"] == before["take_along"]
    assert torch.equal(h.cpu(), hg.hist_bins_plain(bins.view(n, -1)))
    assert torch.equal(p.cpu(), want_p)
    assert (p.cpu()[:, 0, :6] == 0).all()
    assert torch.equal(hist_pallas(bins[0].to(dev)).cpu(), h[0].cpu())
    assert torch.equal(pdf_pallas(bins[0].to(dev), w[0].to(dev)).cpu(),
                       want_p[0])


def _pdf_case(kind):
    """(bins (N, H, W) i32, weights (N, 4096) f32) of a pdf_bins case."""
    g = torch.Generator().manual_seed(17)
    n, shape = {"odd_p": (3, (23, 29)), "n1_frame": (1, (240, 320)),
                "bench_shape": (256, (240, 320)), "one_id": (5, (1, 1)),
                "tail": (2, (1, 76_799))}.get(kind, (3, (23, 29)))
    bins = torch.randint(-70, 4200, (n,) + shape, generator=g).int()
    w = torch.rand((n, 4096), generator=g) * 2 - 1
    if bins[0].numel() >= 5:
        bins.view(n, -1)[:, :5] = torch.tensor(
            [-1, -64, 4096, -2 ** 31, 2 ** 31 - 1], dtype=torch.int32)
    if kind == "zero_weights":
        w[:, ::2] = 0.0
        w[-1] = 0.0
    if kind == "special_weights":  # -0.0, denormals, extremes: exact bits
        w[:, :8] = torch.tensor([-0.0, 1e-40, -1e-45, 2.0 ** -149, 1.17e-38,
                                 3.4e38, -float("inf"), float("inf")])
        bins.view(n, -1)[:, 5:13] = torch.arange(8, dtype=torch.int32)
    return bins, w


PDF_CASES = ("odd_p", "n1_frame", "bench_shape", "one_id", "tail",
             "zero_weights", "special_weights")


@pytest.mark.parametrize("kind", PDF_CASES)
def test_pdf_bins_bit_equal_to_twin(dev, kind):
    """pdf_bins on the card equals its twin bit for bit (ids outside [0,
    4096) among them, looked up as +0.0), through the wrapper and through
    pdf_pallas in both forms; one launch a call; then on the ids viewed one
    element past their start (a head off the 16-byte boundary), whose
    output starts at the same offset."""
    from headtrackr_tpu_torch.kernels import pdf_pallas
    from headtrackr_tpu_torch.kernels.pdfbins import pdf_bins
    bins, w = _pdf_case(kind)
    n = bins.shape[0]
    flat = bins.view(n, -1)
    want = hg.pdf_bins_plain(flat, w)
    before = launches["pdf_bins"]
    got = pdf_bins(flat.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert launches["pdf_bins"] == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(pdf_pallas(bins.to(dev), w.to(dev)).cpu(),
                       want.view(bins.shape))
    assert torch.equal(pdf_pallas(bins[0].to(dev), w[0].to(dev)).cpu(),
                       want[0].view(bins.shape[1:]))
    ids = flat.reshape(-1).to(dev)
    w2 = w.repeat(2, 1)[:2]
    for m in (1, 2):  # one row, two rows, each from the second id on
        length = (ids.numel() - 1) // m
        if length < 1:
            continue
        view = ids[1:1 + m * length].view(m, length)
        assert view.data_ptr() % 16 == 4
        out = pdf_bins(view, w2[:m].to(dev))
        torch.cuda.synchronize()
        assert out.data_ptr() % 16 == 4
        assert torch.equal(out.cpu(), hg.pdf_bins_plain(view.cpu(), w2[:m]))


def test_pdf_bins_empty_past_the_grid_and_misaligned(dev):
    """N = 0 and P = 0 launch nothing and give empty outputs; 65,537 rows
    of 3 ids take two launches (a launch's 65,535 rows); a table off the
    16-byte boundary raises, as does a launch the C launcher refuses."""
    from headtrackr_tpu_torch.kernels import pdf_pallas
    from headtrackr_tpu_torch.kernels.build import load_library
    from headtrackr_tpu_torch.kernels.pdfbins import pdf_bins
    before = launches["pdf_bins"]
    for n, p in ((0, 76_800), (3, 0)):
        out = pdf_bins(torch.zeros((n, p), dtype=torch.int32, device=dev),
                       torch.zeros((n, 4096), device=dev))
        assert tuple(out.shape) == (n, p)
    assert pdf_pallas(torch.zeros((0, 24, 32), dtype=torch.int32,
                                  device=dev),
                      torch.zeros((0, 4096), device=dev)).shape == (0, 24, 32)
    assert launches["pdf_bins"] == before
    g = torch.Generator().manual_seed(18)
    bins = torch.randint(-2, 4098, (65_537, 3), generator=g).int().to(dev)
    # a table a row (1 GB), each entry its bin plus its row: exact in f32
    w = (torch.arange(4096, device=dev)
         + torch.arange(65_537, device=dev).view(-1, 1)).float()
    got = pdf_bins(bins, w)
    torch.cuda.synchronize()
    assert launches["pdf_bins"] == before + 2
    assert torch.equal(got, hg.pdf_bins_plain(bins, w))  # the twin on the card
    del w, got
    ids = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    odd = torch.zeros(2 * 4096 + 1, device=dev)[1:].view(2, 4096)
    with pytest.raises(ValueError, match="16-byte"):
        pdf_bins(ids, odd)
    with pytest.raises(ValueError, match="16-byte"):
        pdf_pallas(ids.view(2, 8, 8), odd)
    out = torch.empty((2, 64), device=dev)
    fn = load_library().fn("pdf_bins_launch")
    stream = torch.cuda.current_stream().cuda_stream
    table = torch.zeros((2, 4096), device=dev)
    # an output whose address differs from the ids' modulo 16, and c = 0
    assert fn(ids.data_ptr(), table.data_ptr(), out[:, 1:].data_ptr(), 2, 63,
              1, stream) != 0
    assert fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), 2, 64, 0,
              stream) != 0
    assert launches["pdf_bins"] == before + 2


def test_reference_surface_on_the_card(dev):
    """The repaired reference-shaped calls with device left at None run on
    the card and equal the paths they alias: mean_shift(pdf, window) the
    kernel wrapper's first three outputs, handoff_band_audit on bins the
    frames route of init_tracker, detect_best(gray, cascade) the tables
    route; init_state and cascade_to_torch land on the card."""
    from headtrackr_tpu_torch.cascade import cascade_to_torch
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.models import camshift as tcs
    from headtrackr_tpu_torch.models import detector as td
    assert tft.init_state(2).mode.device.type == "cuda"
    assert tcs.init_state(2).window.device.type == "cuda"
    assert cascade_to_torch(toy_cascade())["alpha"].device.type == "cuda"
    g = torch.Generator().manual_seed(17)
    frames = torch.randint(20, 60, (8, 120, 160, 3), generator=g,
                           dtype=torch.uint8)
    frames[:, 38:62, 48:72] = torch.tensor([230, 80, 60], dtype=torch.uint8)
    frames[1, 2:5, 150:153] = torch.tensor([230, 80, 60], dtype=torch.uint8)
    rects = torch.tensor([[50, 40, 20, 20]] * 8, dtype=torch.int32)
    f, r = frames.to(dev), rects.to(dev)
    st = tcs.init_tracker(f, r, audit_band=(64, 96))
    got = tcs.handoff_band_audit(hg.rgb_bins(f), st.model_hist, r, (64, 96))
    assert got.tolist() == st.band_dirty.tolist()
    assert got.tolist()[:2] == [False, True]
    pdf = torch.rand((8, 120, 160), generator=g).to(dev)
    three = tcs.mean_shift(pdf, r)
    four = kms.mean_shift(pdf, r)
    for a, b in zip(three, (four[0], four[1], four[2])):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    gray = torch.full((2, 120, 160), 40, dtype=torch.uint8, device=dev)
    gray[:, 38:62, 48:72] = 220
    tables = td.detector_tables(160, 120, toy_cascade(), 5, dev)
    for a, b in zip(td.detect_best(gray, toy_cascade()),
                    td.detect_best(gray, tables)):
        assert torch.equal(a, b)


def _hist_bins_ids(kind, g):
    """(rows, ids a row) of i32 ids of one kind: random in [0, 4096), one
    bin, ids of [-100, 5000) with the pads and the i32 extremes among them,
    or camera-like runs of a few bins."""
    if kind == "random":
        return torch.randint(0, 4096, (37, 1001), generator=g).int()
    if kind == "one_bin":
        return torch.full((3, 70_001), 1234, dtype=torch.int32)
    if kind == "pads":
        ids = torch.randint(-100, 5000, (9, 4099), generator=g).int()
        ids[:, :8] = torch.tensor([-1, -64, 4096, 4095, 0, -2 ** 31,
                                   2 ** 31 - 1, 65535], dtype=torch.int32)
        return ids
    runs = torch.tensor([17, 18, 273, 4000], dtype=torch.int32)[
        torch.randint(0, 4, (5, 300), generator=g)]
    return runs.repeat_interleave(
        torch.randint(1, 60, (300,), generator=g), dim=1).contiguous()


@pytest.mark.parametrize("kind", ["random", "one_bin", "pads", "runs"])
def test_hist_bins_edges_bit_equal_to_twin(dev, kind):
    """hist_bins against its twin on random ids, one bin (a count past
    2^16), out-of-range pads, camera-like runs; each also as views one,
    two and three ids off the 16-byte boundary and as short rows of 0-17
    ids (fewer than a vector; a head with no body)."""
    from headtrackr_tpu_torch.kernels.histbins import hist_bins
    g = torch.Generator().manual_seed(61)
    ids = _hist_bins_ids(kind, g)
    d = ids.to(dev)
    before = launches["hist_bins"]
    assert torch.equal(hist_bins(d).cpu(), hg.hist_bins_plain(ids))
    assert launches["hist_bins"] == before + 1
    flat, flat_d = ids.view(-1), d.view(-1)
    n, p = ids.shape
    for off in (1, 2, 3):
        view = flat_d[off:off + (n - 1) * p].view(n - 1, p)
        assert torch.equal(hist_bins(view).cpu(), hg.hist_bins_plain(
            flat[off:off + (n - 1) * p].view(n - 1, p))), off
    for q in (0, 1, 2, 3, 4, 5, 7, 17):
        for off in (0, 1, 3):
            m = min(n, 3)
            v = flat[off:off + m * q].view(m, q)
            got = hist_bins(flat_d[off:off + m * q].view(m, q))
            assert torch.equal(got.cpu(), hg.hist_bins_plain(v)), (q, off)


def test_hist_bins_empty_one_and_past_the_grid(dev):
    """N = 0 launches nothing; N = 1; N = 65,537 rows of 16 ids (past the
    grid's 65,535 rows) takes two launches and equals the twin."""
    from headtrackr_tpu_torch.kernels.histbins import hist_bins
    g = torch.Generator().manual_seed(67)
    before = launches["hist_bins"]
    assert hist_bins(torch.empty((0, 5), dtype=torch.int32,
                                 device=dev)).shape == (0, 4096)
    assert launches["hist_bins"] == before
    one = torch.randint(-3, 4100, (1, 76_800), generator=g).int()
    assert torch.equal(hist_bins(one.to(dev)).cpu(), hg.hist_bins_plain(one))
    big = torch.randint(-3, 4100, (65_537, 16), generator=g).int().to(dev)
    before = launches["hist_bins"]
    got = hist_bins(big)
    torch.cuda.synchronize()
    assert launches["hist_bins"] == before + 2
    assert torch.equal(got, hg.hist_bins_plain(big))


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_hist_bins_every_cluster_size(dev, c):
    """The launcher at each cluster size C (tools/torch_histbins_variants.py
    times them all) on random ids, runs and pads, on rows on and off the
    16-byte boundary, bit-equal to the twin."""
    from headtrackr_tpu_torch.kernels.launch import launch
    g = torch.Generator().manual_seed(71 + c)
    for kind in ("random", "runs", "pads"):
        ids = _hist_bins_ids(kind, g)
        n, p = ids.shape
        flat = ids.to(dev).view(-1)
        for off in (0, 1):
            rows = flat[off:off + (n - 1) * p].view(n - 1, p)
            out = torch.full((n - 1, 4096), -1.0, device=dev)
            launch("hist_bins", "hist_bins_launch", rows.data_ptr(),
                   out.data_ptr(), n - 1, p, c)
            assert torch.equal(out, hg.hist_bins_plain(rows)), (kind, off)


def test_facades_default_to_the_card(dev):
    """Without device= the facades run on the card and agree with the CPU:
    camshift.Histogram exactly, facetrackr.Tracker over 24 frames result
    for result (integers exact, floats rtol 1e-5 / atol 1e-4)."""
    import headtrackr_tpu_torch as pt
    H, W = 120, 160

    def frame(cx, cy):
        f = np.full((H, W, 3), 40, np.uint8)
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
        return f

    clip = np.stack([frame(60, 50)] * 16 + [frame(60 + t, 50)
                                            for t in range(8)])
    assert pt.camshift.Tracker().device.type == "cuda"
    assert pt.Smoother().device.type == "cuda"
    assert pt.ccv.grayscale(clip[0]).is_cuda
    np.testing.assert_array_equal(pt.camshift.Histogram(clip[0]),
                                  pt.camshift.Histogram(clip[0], device="cpu"))
    runs = []
    for kw in ({}, {"device": "cpu"}):
        t = pt.facetrackr.Tracker(cascade=toy_cascade(), sendEvents=False,
                                  **kw)
        t.init(pt.ClipSource(clip))
        runs.append([vars(t.track()) for _ in range(len(clip))])
    assert [r["detection"] for r in runs[0]][-1] == "CS"
    for a, b in zip(*runs):
        for k in b:
            if k == "time":
                continue
            if isinstance(b[k], (str, int)) and isinstance(a[k], type(b[k])):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4)


def _meanshift_case(n, shape, banded, seed):
    """A batch of pdfs (40% of pixels zero), windows (some partly off the
    frame, some larger than the band, one of width 0) and the band origins
    band_rect places for them, with a zero-mass stream where n > 2.  A
    band lies in a 240x320 frame; a full-frame pdf is its frame."""
    from headtrackr_tpu_torch.models import camshift as tcs
    g = torch.Generator().manual_seed(seed)
    bh, bw = shape
    H, W = (240, 320) if banded else shape
    pdf = torch.rand((n, bh, bw), generator=g)
    pdf[pdf < 0.4] = 0
    if n > 2:
        pdf[1] = 0
    win = torch.stack([torch.randint(-12, W - 4, (n,), generator=g),
                       torch.randint(-12, H - 4, (n,), generator=g),
                       torch.randint(4, 60, (n,), generator=g),
                       torch.randint(4, 60, (n,), generator=g)], 1).int()
    win[-1, 2] = 0
    origins = (tcs.band_rect(win, shape, (H, W))[:2] if banded
               else (None, None))
    return pdf, win, origins, (H, W)


def _bits(t):
    """An f32 tensor's bits, NaNs (whatever their sign and payload) as 0."""
    return torch.where(torch.isnan(t), 0, t.view(torch.int32))


def _meanshift_equal(got, want):
    from headtrackr_tpu_torch.ops.meanshift import MOMENTS
    for a, b in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        assert torch.equal(a.cpu(), b.cpu())
    for k in MOMENTS:
        a, b = got[1][k].cpu(), want[1][k].cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b)), k
        assert torch.equal(_bits(a), _bits(b)), k


def _meanshift_args(case, d):
    """The twin's arguments: the origins form (ry, rx from band_rect)."""
    pdf, win, (ry, rx), frame = case
    on = lambda t: None if t is None else t.to(d)  # noqa: E731
    return pdf.to(d), win.to(d), on(ry), on(rx), frame


def _kernel_args(case, d):
    """The wrapper's arguments: the kernel places the band from each
    window (a band's frame given; a full-frame pdf's left out)."""
    pdf, win, (ry, _), frame = case
    return pdf.to(d), win.to(d), None if ry is None else frame


@pytest.mark.parametrize("n,shape,banded", [
    (n, shape, banded)
    for n in (1, 3, 256)
    for shape, banded in (((96, 128), True), ((128, 192), True),
                          ((240, 320), False), ((57, 99), True),
                          ((480, 640), False))] + [(1, (1024, 1024), False)])
def test_meanshift_bit_equal_to_twin(dev, n, shape, banded):
    """One launch of the kernel route picks; bit-equal to the twin run on
    the card and on the CPU: a cluster over the 240x320 and 480x640 frames
    at 1 and 3 streams, the global scratch at 256 of them and at
    1024x1024, one CTA or a cluster at the bands (57x99 takes the plain
    loads instead of TMA)."""
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.ops.meanshift import mean_shift_plain
    case = _meanshift_case(n, shape, banded, seed=n)
    c = kms.route(n, *shape, kms.card(dev))
    if shape in ((240, 320), (480, 640)) and n < 256:
        assert c in kms.CLUSTER_SIZES
    assert (c == kms.SCRATCH) == (shape == (1024, 1024) or (
        shape in ((240, 320), (480, 640)) and n == 256))
    before = launches["meanshift"]
    got = kms.mean_shift(*_kernel_args(case, dev))
    torch.cuda.synchronize()
    assert launches["meanshift"] == before + 1
    _meanshift_equal(got, mean_shift_plain(*_meanshift_args(case, dev)))
    _meanshift_equal(got, mean_shift_plain(*_meanshift_args(case, "cpu")))
    _meanshift_equal(got, kms.mean_shift(*_kernel_args(case, "cpu")))


@pytest.mark.parametrize("shape,banded,kernels", [
    ((240, 320), False, (0, 4, 8, 16)),
    ((96, 128), True, (0, 2, 4, 8, 16)),
    ((57, 99), True, (2, 16)),
    ((1, 1), False, (2, 16)),
    ((480, 640), False, (16,))])
def test_meanshift_every_kernel(dev, shape, banded, kernels):
    """Each kernel forced (the scratch kernel, the cluster kernel at every
    size that fits) at n = 8, bit-equal to the twin on the card; the sizes
    that do not fit are refused."""
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.ops.meanshift import mean_shift_plain
    case = _meanshift_case(8, shape, banded, seed=91)
    args = _kernel_args(case, dev)
    want = mean_shift_plain(*_meanshift_args(case, dev))
    smem = kms.card(dev).smem_cta
    for c in kernels:
        _meanshift_equal(kms.launch_kernel(c, *args), want)
    for c in (kms.ONE_CTA,) + kms.CLUSTER_SIZES:
        if kms.smem_bytes(*shape, c) > smem:
            with pytest.raises(RuntimeError, match="meanshift launch"):
                kms.launch_kernel(c, *args)


def test_meanshift_route_mirrors_the_source(dev):
    """kernels/meanshift.py smem_bytes equals the source's layouts, and
    route sends to the scratch exactly the shapes for which the source
    asks for scratch (meanshift_scratch_floats)."""
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.kernels.build import load_library
    lib = load_library()
    card = kms.card(dev)
    assert card.sms > 0 and card.smem_sm >= card.smem_cta > 0
    for bh, bw in ((1, 1), (57, 99), (96, 128), (128, 192), (240, 320),
                   (241, 321), (480, 640), (700, 900), (1024, 1024)):
        for c in (kms.SCRATCH, kms.ONE_CTA) + kms.CLUSTER_SIZES:
            assert kms.smem_bytes(bh, bw, c) == lib.fn(
                "meanshift_smem_bytes")(bh, bw, c), (bh, bw, c)
        floats = lib.fn("meanshift_scratch_floats")(bh, bw)
        assert (kms.route(1, bh, bw, card) == kms.SCRATCH) == (floats > 0)
        assert floats in (0, kms.scratch_floats(bh, bw))


def test_meanshift_in_a_graph_equals_eager(dev):
    """Each kernel captured in a CUDA graph (one CTA at the band, the
    cluster and the scratch kernel over the frame, the scratch allocated
    in the graph's pool) and replayed equals the eager call."""
    from headtrackr_tpu_torch.kernels import meanshift as kms
    for shape, banded, c in (((96, 128), True, kms.ONE_CTA),
                             ((240, 320), False, 8),
                             ((240, 320), False, kms.SCRATCH)):
        args = _kernel_args(_meanshift_case(8, shape, banded, seed=4), dev)
        eager = kms.launch_kernel(c, *args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kms.launch_kernel(c, *args)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got = kms.launch_kernel(c, *args)
        g.replay()
        torch.cuda.synchronize()
        _meanshift_equal(got, eager)


def _hist_frames(kind, n, shape, g):
    """(n, H, W, 3) u8 frames: the bench pool cropped or edge-padded to
    ``shape``, uniform random bytes, or one bin everywhere."""
    H, W = shape
    if kind == "random":
        return torch.randint(0, 256, (n, H, W, 3), generator=g,
                             dtype=torch.uint8)
    if kind == "one_bin":
        return torch.tensor([120, 100, 90], dtype=torch.uint8).expand(
            n, H, W, 3).contiguous()
    from bench import build_pool
    pool = build_pool(n, 240, 320, 2, 0, np.random.default_rng(n),
                      face_noise=20)[1]
    pool = np.pad(pool, ((0, 0), (0, max(0, H - 240)), (0, 0), (0, 0)),
                  mode="edge")
    return torch.as_tensor(np.ascontiguousarray(pool[:, :H, :W]))


def _cluster_rects(n, shape, g):
    """Full-frame rects; boxes partly outside the frame; rects of zero
    width or height or wholly off the frame."""
    H, W = shape
    boxes = torch.cat([torch.randint(-W // 2, W, (n, 1), generator=g),
                       torch.randint(-H // 2, H, (n, 1), generator=g),
                       torch.randint(1, W + 1, (n, 1), generator=g),
                       torch.randint(1, H + 1, (n, 1), generator=g)], 1).int()
    empty = boxes.clone()
    empty[0::3, 2] = 0
    empty[1::3, 3] = 0
    empty[2::3, 0] = W + 3
    return {"full": hg.full_rects(n, shape, "cpu"), "boxes": boxes,
            "empty": empty}


@pytest.mark.parametrize("kind", ["bench", "random", "one_bin"])
@pytest.mark.parametrize("n", [1, 2, 3, 256])
@pytest.mark.parametrize("shape", [(240, 320), (241, 320), (57, 99), (8, 8)])
def test_hist4096_cluster_bit_equal_to_twin(dev, shape, n, kind):
    """hist4096 (one cluster a stream, its C from cluster_split) and
    histpdf_band's hist-only mode against the twin, tolerance 0: full
    frames, boxes partly outside, zero-size rects; and the same frames in
    a buffer one byte off the 16-byte boundary (every row's head and tail
    taken pixel by pixel)."""
    g = torch.Generator().manual_seed(43 + n)
    frames = _hist_frames(kind, n, shape, g)
    off = torch.empty(frames.numel() + 1, dtype=torch.uint8,
                      device=dev)[1:].view(frames.shape)
    off.copy_(frames.to(dev))
    assert off.data_ptr() % 16 and off.is_contiguous()
    for name, rects in _cluster_rects(n, shape, g).items():
        want = hg.hist4096_plain(frames, rects).float()
        before = dict(launches)
        got = K.hist4096(frames.to(dev), rects.to(dev))
        hist = K.histpdf_band(frames.to(dev), rects.to(dev))
        torch.cuda.synchronize()
        assert launches["hist4096"] == before["hist4096"] + 1
        assert launches["histpdf_band_hist"] == before["histpdf_band_hist"] + 1
        assert torch.equal(got.cpu(), want), name
        assert torch.equal(hist.cpu(), want), name
        assert torch.equal(K.hist4096(off, rects.to(dev)).cpu(), want), name


@pytest.mark.parametrize("n", [1, 3, 256])
@pytest.mark.parametrize("shape,band", [((240, 320), (96, 128)),
                                        ((240, 320), (95, 127)),
                                        ((240, 320), (96, 131)),
                                        ((240, 320), (240, 320)),
                                        ((57, 99), (24, 41)),
                                        ((57, 99), (57, 99))])
def test_histpdf_band_cluster_bit_equal_to_twin(dev, shape, band, n):
    """histpdf_band in pdf mode (the kernel placing each band around windows
    of the band's size with x on the 8-pixel grid and from -20; odd widths,
    origins clipped off the grid; the whole frame, X7's use) and in
    hist-only mode, bit-equal to the twins (the pdf mode's at band_rect's
    rects), on random and bench frames; a view one stream in."""
    g = torch.Generator().manual_seed(53 + n)
    H, W = shape
    bh, bw = band
    for kind in ("random", "bench"):
        frames = _hist_frames(kind, n, shape, g)
        x = torch.randint(-20, W - bw + 21, (n,), generator=g)
        x[: (n + 1) // 2] = x[: (n + 1) // 2].clamp(0, W - bw) // 8 * 8
        rects = torch.stack([x, torch.randint(-20, H - bh + 21, (n,),
                                              generator=g),
                             torch.full((n,), bw), torch.full((n,), bh)],
                            1).int()
        model = torch.randint(0, 200, (n, 4096), generator=g).float()
        model[:, :64] = 0
        before = launches["histpdf_band"]
        cur, pdf = K.histpdf_band(frames.to(dev), rects.to(dev),
                                  model.to(dev), band)
        torch.cuda.synchronize()
        assert launches["histpdf_band"] == before + 1
        placed = _placed(rects, band, shape)
        want_cur, want_pdf = hg.histpdf_band_plain(frames, placed, model,
                                                   band)
        assert torch.equal(cur.cpu(), want_cur), kind
        assert torch.equal(pdf.cpu(), want_pdf), kind
        boxes = _cluster_rects(n, shape, g)["boxes"]
        assert torch.equal(K.histpdf_band(frames.to(dev), boxes.to(dev)).cpu(),
                           hg.histpdf_band_plain(frames, boxes)), kind
        if n > 1:
            got = K.histpdf_band(frames.to(dev)[1:], rects.to(dev)[1:],
                                 model.to(dev)[1:], band)
            want = hg.histpdf_band_plain(frames[1:], placed[1:], model[1:],
                                         band)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1, 3, 256])
@pytest.mark.parametrize("shape,band", [((240, 320), (96, 128)),
                                        ((57, 99), (24, 41))])
def test_histpdf_band_in_place_equals_direct(dev, shape, band, n):
    """histpdf_band's pdf mode reading its frames in place (under
    launch.frames_at: a buffer poisoned with 255, its frames at the address
    held in an i64 word, as the serving program's tick_select sets it) is
    bit-equal to the direct read of the same frames: on three ticks of a
    scan, staged on and off the 16-byte grid, eagerly and replayed from a
    CUDA graph captured once, the word changed between replays (the
    address is read when the kernel runs); a sub-batch of the buffer and
    the hist-only mode are not redirected."""
    from headtrackr_tpu_torch.kernels import launch as L
    g = torch.Generator().manual_seed(71 + n)
    H, W = shape
    bh, bw = band
    seq = torch.stack([_hist_frames("random", n, shape, g)
                       for _ in range(3)])
    x = torch.randint(-20, W - bw + 21, (n,), generator=g)
    x[: (n + 1) // 2] = x[: (n + 1) // 2].clamp(0, W - bw) // 8 * 8
    rects = torch.stack([x, torch.randint(-20, H - bh + 21, (n,),
                                          generator=g),
                         torch.full((n,), bw), torch.full((n,), bh)],
                        1).int().to(dev)
    model = torch.randint(0, 200, (n, 4096), generator=g).float().to(dev)
    buf = torch.full(seq.shape[1:], 255, dtype=torch.uint8, device=dev)
    word = torch.zeros(1, dtype=torch.int64, device=dev)
    for offset in (0, 5):
        flat = torch.zeros(seq.numel() + 16, dtype=torch.uint8, device=dev)
        staged = flat[offset:offset + seq.numel()].view(seq.shape)
        staged.copy_(seq.to(dev))
        want = [K.histpdf_band(staged[k], rects, model, band)
                for k in range(3)]
        for k in range(3):
            word.fill_(staged[k].data_ptr())
            before = launches["histpdf_band"]
            with L.frames_at(buf, word):
                got = K.histpdf_band(buf, rects, model, band)
                sub = K.histpdf_band(buf[:n], rects, model, band)
                hist = K.histpdf_band(buf, rects)
            torch.cuda.synchronize()
            assert launches["histpdf_band"] == before + 2
            for a, b in zip(got, want[k]):
                assert torch.equal(a, b), (offset, k)
            poisoned = K.histpdf_band(buf, rects, model, band)
            for a, b in zip(sub, poisoned):
                assert torch.equal(a, b), (offset, k)
            assert torch.equal(hist, K.histpdf_band(buf, rects))
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), L.frames_at(buf, word):
            K.histpdf_band(buf, rects, model, band)
        torch.cuda.current_stream().wait_stream(side)
        with L.frames_at(buf, word), torch.cuda.graph(graph):
            out = K.histpdf_band(buf, rects, model, band)
        for k in (2, 0, 1):
            word.fill_(staged[k].data_ptr())
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(out, want[k]):
                assert torch.equal(a, b), (offset, k, "graph")


@pytest.mark.parametrize("kw", [{}, dict(band=(64, 96), bandHist=True)])
def test_mesh_of_two_shards_equals_meshless(dev, kw):
    """stream_mesh([cuda:0] * 2) over 8 streams: each tick's outputs and
    the final state equal the meshless tracker's bit for bit through the
    lock, all-CS ticks, a loss and (banded) the escape fallback; each
    shard launches a serving program of its own."""
    from headtrackr_tpu_torch.parallel import stream_mesh
    H, W, n = 120, 160, 8
    clip = _serving_clip(H, W, n)
    mk = lambda **k: BatchedTracker(n, (H, W), cascade=toy_cascade(),  # noqa: E731
                                    bucket=2, **kw, **k)
    one, mesh = mk(device=dev), mk(mesh=stream_mesh([dev] * 2))
    esc = []
    for t, f in enumerate(clip):
        a, b = one.step_auto(f), mesh.step_auto(f)
        for name, x, y in zip(tft.StepOutput._fields, a, b):
            assert y.device == dev
            np.testing.assert_array_equal(y.cpu().numpy(), x.cpu().numpy(),
                                          err_msg=f"tick {t} {name}")
        esc.append(b.escaped.cpu().numpy())
    assert np.stack(esc)[-5:, [3, 7]].all() == bool(kw)
    for x, y in zip(_leaves(one.state), _leaves(mesh.state)):
        np.testing.assert_array_equal(y.cpu().numpy(), x.cpu().numpy())
    graphs = [s._graph for s in mesh._shards]
    assert all(g is not None for g in graphs)
    assert graphs[0] is not graphs[1] and graphs[0].graph is not graphs[1].graph
    assert [s.n for s in mesh._shards] == [4, 4]
    assert mesh.modes.tolist() == one.modes.tolist() == [2] * n


def _leaves(tree):
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


def test_mesh_kernel_failure_on_one_shard_raises(dev, monkeypatch):
    """A kernel launch refused on the second shard raises out of the mesh
    tick: no shard gives way to a plain twin."""
    from headtrackr_tpu_torch.kernels import build
    from headtrackr_tpu_torch.parallel import stream_mesh
    H, W, n = 120, 160, 4
    clip = _serving_clip(H, W, n)
    bt = BatchedTracker(n, (H, W), cascade=toy_cascade(),
                        mesh=stream_mesh([dev] * 2))
    real = build.load_library

    class Refusing:
        def fn(self, name):
            f = real().fn(name)
            return (lambda *a: 1) if name == "meanshift_launch" else f

    shard = bt._shards[1]._steps  # the second shard's tick
    track = shard._track

    def refused(*a, **k):
        with monkeypatch.context() as m:
            m.setattr(build, "load_library", Refusing)
            return track(*a, **k)

    shard._track = refused
    with pytest.raises(RuntimeError, match="meanshift launch failed"):
        for f in clip:
            bt.step_auto(f)


@pytest.mark.parametrize("casc", ["toy", "real"])
@pytest.mark.parametrize("n,shape", [(8, (240, 320)), (1, (240, 320)),
                                     (3, (57, 99)), (2, (480, 640))])
def test_detector_kernels_bit_equal_to_twins(dev, casc, n, shape):
    """pyramid, cascade (capacity 256 and 4: survivors beyond it, the
    overflow) and group (min_neighbors 1 and 0) against their twins on
    the CPU, slot for slot, on random frames with flat squares."""
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.kernels.cascade import cascade
    from headtrackr_tpu_torch.kernels.group import group
    from headtrackr_tpu_torch.kernels.pyramid import pyramid
    from headtrackr_tpu_torch.models import detector as td
    H, W = shape
    c = toy_cascade() if casc == "toy" else frontalface()
    g = torch.Generator().manual_seed(11)
    gray = torch.randint(0, 256, (n, H, W), generator=g, dtype=torch.uint8)
    gray[:, H // 4:H // 4 + 24, W // 4:W // 4 + 24] = 200
    tc = td.detector_tables(W, H, c, 5, "cpu")
    tg = td.detector_tables(W, H, c, 5, dev)
    before = dict(launches)
    buf = pyramid(gray.to(dev), tg)
    torch.cuda.synchronize()
    assert launches["pyramid"] - before["pyramid"] == 1
    want_buf = pyramid(gray, tc)
    assert torch.equal(buf.cpu(), want_buf)
    keys = ("x", "y", "width", "height", "confidence", "valid")
    for cap in (256, 4):
        before = dict(launches)
        got = cascade(buf, tg, cap)
        assert launches["cascade"] - before["cascade"] == (
            2 if casc == "toy" else 3)
        want = cascade(want_buf, tc, cap)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), (cap, k)
        for mn in (1, 0):
            s_got, b_got = group(*(got[k] for k in keys), mn)
            s_want, b_want = group(*(want[k] for k in keys), mn)
            for k, v in s_want.items():
                assert torch.equal(s_got[k].cpu(), v), (cap, mn, k)
            for a, b in zip(b_got, b_want):
                assert torch.equal(a.cpu(), b), (cap, mn)


def _group_cases():
    """tools/torch_group_cases.py's slot sets (a script, loaded by path)."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "tools"
            / "torch_group_cases.py")
    spec = importlib.util.spec_from_file_location("torch_group_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cases(np.random.default_rng(15))


def _gbits(t):
    """A group output's bits: an f32's int32 view, a mask as it is."""
    return t.view(torch.int32) if t.is_floating_point() else t


GROUP_CASES = ("clustered", "chain", "chain shuffled", "singletons", "dense",
               "k = 1, 32, 33, 256", "ties", "holes", "nested")


@pytest.mark.parametrize("mn", [0, 1, 3])
@pytest.mark.parametrize("name", GROUP_CASES)
def test_group_kernel_equals_twin_on_adversarial_slots(dev, name, mn):
    """group on the card against its twin on the CPU, bit for bit, on the
    longest component, 256 singletons, every slot valid, k = 1, 32, 33 and
    256 (warp 0 alone, then the CTA), equal confidences, a non-prefix mask
    and a contained cluster."""
    from headtrackr_tpu_torch.kernels.group import group
    arrays = _group_cases()[name]
    want_s, want_b = group(*(torch.as_tensor(a) for a in arrays), mn)
    before = launches["group"]
    got_s, got_b = group(*(torch.as_tensor(a).to(dev) for a in arrays), mn)
    torch.cuda.synchronize()
    assert launches["group"] == before + 1
    for k, v in want_s.items():
        assert torch.equal(_gbits(got_s[k].cpu()), _gbits(v)), (name, mn, k)
    for a, b in zip(got_b, want_b):
        assert torch.equal(_gbits(a.cpu()), _gbits(b)), (name, mn)


def _group_graph(dev, arrays, mn):
    """group captured in a CUDA graph on static inputs: (graph, inputs,
    outputs)."""
    from headtrackr_tpu_torch.kernels.group import group
    static = [torch.as_tensor(a).to(dev) for a in arrays]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        group(*static, mn)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group(*static, mn)
    return graph, static, out


def test_group_replayed_twice_gives_the_same_bits(dev):
    """Two replays of a captured group (the hooking's atomics race in a
    different order each time) give the twin's bits."""
    from headtrackr_tpu_torch.kernels.group import group
    arrays = _group_cases()["clustered"]
    graph, _, (slots, best) = _group_graph(dev, arrays, 1)
    runs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append([_gbits(t.cpu()) for t in [*slots.values(), *best]])
    want_s, want_b = group(*(torch.as_tensor(a) for a in arrays), 1)
    want = [_gbits(t) for t in [*want_s.values(), *want_b]]
    for a, b, c in zip(*runs, want):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("mn", [0, 1])
@pytest.mark.parametrize("name", ["k = 1, 32, 33, 256", "clustered"])
def test_group_call_is_one_device_operation(dev, name, mn):
    """A group call is one device operation (the kernel reads the planes in
    place: no copy): the CUDA graph that captures it holds one node, a
    kernel, with warp 0 alone (k <= 32) and with the whole CTA."""
    from chip_smoke import graph_nodes
    from headtrackr_tpu_torch.kernels.group import group
    static = [torch.as_tensor(a).to(dev) for a in _group_cases()[name]]
    assert graph_nodes(lambda: group(*static, mn)) == ["kernel"]


def test_detect_best_in_a_graph_equals_eager(dev):
    """detect_best at 8 streams captured in a CUDA graph (no host read)
    and replayed equals the eager call."""
    from bench import build_pool
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.ops.imageproc import grayscale
    pool = build_pool(8, 240, 320, 2, 2, np.random.default_rng(0))
    gray = grayscale(torch.as_tensor(pool[1]).to(dev))
    tables = td.detector_tables(320, 240, frontalface(), 5, dev)
    want = td.detect_best(gray, tables)
    static = gray.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        td.detect_best(static, tables)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = td.detect_best(static, tables)
    static.zero_()
    graph.replay()
    static.copy_(gray)
    graph.replay()
    torch.cuda.synchronize()
    assert bool(want[0].any())
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, dict(band=(64, 96), bandHist=True)])
def test_bucket_graph_equals_eager_ticks(dev, kw):
    """step_auto through the serving program (the bucket and chunk ticks
    its bucket bodies) against the per-tick path run eagerly
    (``_Steps.scheduled`` off), 8 streams, bucket 2: every output of every
    tick bit-equal, through the lock, losses of one and of three streams
    and their relocks; one body a slot count."""
    H, W, n = 120, 160, 8
    clip = _serving_clip(H, W, n)
    clip = np.concatenate([clip, clip[-4:]])
    clip[-4, [1, 2, 5]] = (0, 0, 250)
    mk = lambda: BatchedTracker(n, (H, W), cascade=toy_cascade(),  # noqa: E731
                                device=dev, bucket=2, **kw)
    graph, eager = mk(), mk()
    eager._steps.scheduled = False
    before = dict(launches)
    for t, f in enumerate(clip):
        a = [v.cpu().numpy() for v in eager.step_auto(f)]
        b = [v.cpu().numpy() for v in graph.step_auto(f)]
        for name, x, y in zip(tft.StepOutput._fields, a, b):
            np.testing.assert_array_equal(y, x, err_msg=f"tick {t} {name}")
    slots = {s for (_, s) in graph._steps._graphs}
    assert {0, 2, 4} <= slots
    assert not eager._steps._graphs
    assert launches["cascade"] > before["cascade"]
    assert graph.modes.tolist() == [2] * n


def test_step_bucket_replays_on_the_card(dev):
    """make_batched_steps' step_bucket on the card (one launch of the
    serving program forced to its bucket body) against the same step on
    the CPU: integers exact, floats rtol
    1e-5 / atol 1e-4, ``pend_age`` kept, the caller's state untouched
    (donate=False)."""
    from headtrackr_tpu_torch.runtime.serving import make_batched_steps
    H, W, n = 120, 160, 8
    clip = _serving_clip(H, W, n)
    got = []
    for d in (dev, torch.device("cpu")):
        bt = BatchedTracker(n, (H, W), cascade=toy_cascade(), device=d,
                            bucket=2, band=None)
        for f in clip[:18]:
            bt.step_auto(f)
        _, _, step_bucket, _, _ = make_batched_steps(
            toy_cascade(), bt.config, (H, W), donate=False, device=d,
            bucket=2, band=None)
        mode = torch.full((n,), tft.MODE_CS, dtype=torch.int32)
        mode[[1, 5]] = tft.MODE_VJ
        state = bt.state._replace(mode=mode.to(d), pend_age=torch.arange(
            n, dtype=torch.int32, device=d))
        before = [t.clone() for t in _leaves(state)]
        new, out = step_bucket(state, clip[18], torch.tensor([1, 5]))
        for a, b in zip(before, _leaves(state)):
            assert torch.equal(a, b)
        assert new.pend_age.tolist() == list(range(n))
        got.append([t.cpu().numpy() for t in out])
    for name, a, b in zip(tft.StepOutput._fields, *got):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
    assert got[0][tft.StepOutput._fields.index("mode_after")][[1, 5]].tolist() \
        == [tft.MODE_CS] * 2


def _detect_frames(kind, n, shape):
    """Gray frames for the detector kernels: the bench pool's ("bench"),
    uniform random ("random"), or the synthetic face tiled every 26 px
    over the frame ("faces": windows around every face pass deep stages,
    so every warp of them holds deep survivors)."""
    import importlib
    import os
    from bench import build_pool
    from headtrackr_tpu_torch.ops.imageproc import grayscale
    H, W = shape
    if kind == "bench":
        pool = build_pool(n, H, W, 2, 1, np.random.default_rng(0))
        return grayscale(torch.as_tensor(pool[1]))
    if kind == "random":
        g = torch.Generator().manual_seed(5)
        return torch.randint(0, 256, (n, H, W), generator=g,
                             dtype=torch.uint8)
    tc = importlib.import_module("headtrackr_tpu_torch.cascade")
    face = np.load(os.path.join(tc.DATA_DIR, "synthface.npz"))["rgb"]
    rgb = np.full((H, W, 3), (120, 100, 90), np.uint8)
    for y in range(1, H - 24, 26):
        for x in range(1, W - 24, 26):
            rgb[y:y + 24, x:x + 24] = face
    gray = grayscale(torch.as_tensor(rgb))
    return gray[None].repeat(n, 1, 1).contiguous()


@pytest.mark.parametrize("kind,casc", [("bench", "real"), ("faces", "real"),
                                       ("random", "toy")])
@pytest.mark.parametrize("n", [1, 8, 256])
def test_detector_kernels_bit_equal_to_twins_at_serving_sizes(dev, kind,
                                                              casc, n):
    """pyramid and cascade (capacity 256) at N = 1, 8 (the relock bucket)
    and 256 (the cold start's full tick) against their twins run on the
    card, slot for slot: the bench pool, frames tiled with faces (deep
    survivors in every warp that holds a face) and the toy cascade on
    random frames (survivors beyond the capacity at every N)."""
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.kernels.cascade import cascade
    from headtrackr_tpu_torch.kernels.pyramid import pyramid
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.ops import detect as od
    from headtrackr_tpu_torch.ops.imageproc import pack_pyramid
    gray = _detect_frames(kind, n, (240, 320)).to(dev)
    tg = td.detector_tables(320, 240, toy_cascade() if casc == "toy"
                            else frontalface(), 5, dev)
    buf = pyramid(gray, tg)
    want_buf = pack_pyramid(gray, 5, tg.plane_keys, tg.geom_levels)
    assert torch.equal(buf, want_buf)
    got = cascade(buf, tg, 256)
    want = od.cascade_plain(want_buf, tg, 256)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if kind == "random":
        assert bool((got["overflow"] > 0).all())
    if kind == "faces":
        assert int(got["valid"].sum(1).min()) > 0


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n,shape", [(1, (240, 320)), (8, (240, 320)),
                                     (3, (57, 99)), (2, (480, 640))])
def test_pyramid_every_split_bit_equal_to_twin(dev, ctas, n, shape,
                                               monkeypatch):
    """The pyramid kernel at every cluster size (``split`` patched to give
    ``ctas``): levels held in shared memory and read across the cluster,
    and (480x640 at 1, 2 or 4 CTAs a chain) read back from the packed
    planes."""
    from headtrackr_tpu_torch.kernels import pyramid as kp
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.ops.imageproc import pack_pyramid
    H, W = shape
    g = torch.Generator().manual_seed(3)
    gray = torch.randint(0, 256, (n, H, W), generator=g,
                         dtype=torch.uint8).to(dev)
    tg = td.detector_tables(W, H, toy_cascade(), 5, dev)
    monkeypatch.setattr(kp, "split", lambda *a: ctas)
    got = kp.pyramid(gray, tg)
    torch.cuda.synchronize()
    assert torch.equal(got, pack_pyramid(gray, 5, tg.plane_keys,
                                         tg.geom_levels))


def test_cascade_graph_replays_twice_alike(dev):
    """cascade captured in a CUDA graph at the relock bucket's 8 streams
    and replayed twice in a row (the survivor count zeroed inside the
    captured work each time), then on other frames and back: every replay
    equals the eager call on the same planes."""
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.kernels.cascade import cascade
    from headtrackr_tpu_torch.kernels.pyramid import pyramid
    from headtrackr_tpu_torch.models import detector as td
    tg = td.detector_tables(320, 240, frontalface(), 5, dev)
    bufs = [pyramid(_detect_frames(k, 8, (240, 320)).to(dev), tg)
            for k in ("faces", "bench")]
    wants = [cascade(b, tg, 256) for b in bufs]
    static = bufs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cascade(static, tg, 256)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cascade(static, tg, 256)
    for i in (0, 0, 1, 0):
        static.copy_(bufs[i])
        graph.replay()
        torch.cuda.synchronize()
        for k, v in wants[i].items():
            assert torch.equal(got[k], v), (i, k)
    assert int(wants[0]["valid"].sum()) > 0


def test_relock_graph_real_cascade_equals_host_step(dev):
    """The real cascade at 320x240, 8 streams of the bench pool with 2 loss
    streams: step_auto (its bucket ticks, the redetects, the serving
    program's bucket bodies through pyramid, cascade's three kernels and
    group) against the
    eager step(sync=True) at sync_interval 1, tick for tick through the
    lock, the loss and the relock."""
    from bench import build_pool
    from headtrackr_tpu_torch.cascade import frontalface
    n, H, W = 8, 240, 320
    pool = build_pool(n, H, W, 16, 2, np.random.default_rng(0))
    clip = np.concatenate([pool, pool])
    mk = lambda **k: BatchedTracker(n, (H, W), cascade=frontalface(),  # noqa: E731
                                    device=dev, bucket=2, **k)
    host, auto = mk(sync_interval=1), mk()
    before = dict(launches)
    for t, f in enumerate(clip):
        want = [v.cpu().numpy() for v in host.step(f, sync=True)]
        got = [v.cpu().numpy() for v in auto.step_auto(f)]
        for name, a, b in zip(tft.StepOutput._fields, want, got):
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                           err_msg=f"tick {t} {name}")
    assert {s for (_, s) in auto._steps._graphs} >= {2}  # a bucket body
    assert launches["cascade"] > before["cascade"]
    assert auto.modes.tolist() == [2] * n


def _sched_vectors(n, g):
    """Random modes (WB, VJ, CS) and pend_age with many ties."""
    mode = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    age = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32)
    return mode, age


@pytest.mark.parametrize("n", [1, 3, 33, 256, 257, 4096, 4097, 10240,
                               65536])
def test_schedule_select_kernels_equal_twins(dev, n):
    """tick_select and escape_select against their twins on random
    vectors with ties (ages 0-3), every bucket, both overloads, the
    forced bucket of step_bucket, all-CS and all-WB batches, and escape
    counts of 0, 1, eb and more; one CTA up to 256 streams, a grid past
    it (a chunk cap of N merges past the shared keys at 65,536).  Every
    launch after the first reuses the kept scratch buffer, whose ticket
    the last CTA reset."""
    from headtrackr_tpu_torch.kernels import schedule as S
    g = torch.Generator().manual_seed(n)
    for trial in range(12):
        mode, age = _sched_vectors(n, g)
        if trial == 1:
            mode[:] = tft.MODE_CS
        if trial == 2:
            mode[:] = tft.MODE_WB
        if trial == 3:
            mode[:] = tft.MODE_VJ
        for kb in sorted({1, 4, 32, n} & set(range(1, n + 1))):
            cap = max(kb, (min(n, 4 * kb) // kb) * kb)
            for rotate in (False, True):
                for force in (0, 1 + kb) if trial == 4 else (0,):
                    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
                    params[S.P_FORCE] = force
                    params[S.P_K], params[S.P_FRAMES] = trial, 1 << 36
                    idx = torch.randint(0, n + 1, (cap,), generator=g)
                    want = S.tick_select_plain(mode, age, kb, cap, rotate,
                                               force, idx)
                    gp, gi, ga = params.to(dev), idx.to(dev), \
                        torch.empty(n, dtype=torch.int32, device=dev)
                    before = launches["tick_select"]
                    S.tick_select(mode.to(dev), age.to(dev), kb, cap, rotate,
                                  gi, ga, gp, frame_bytes=230400 + n)
                    torch.cuda.synchronize()
                    assert launches["tick_select"] == before + 1
                    where = f"n {n} trial {trial} kb {kb} rotate {rotate}"
                    assert int(gp[S.P_K]) == trial + 1, where
                    assert int(gp[S.P_FRAME_AT]) == \
                        (1 << 36) + trial * (230400 + n), where
                    assert int(gp[S.P_BRANCH]) == want[0], where
                    assert int(gp[S.P_RUNS + want[0]]) == 1, where
                    assert torch.equal(gi.cpu(), want[1]), where
                    assert torch.equal(ga.cpu(), want[2]), where
        for eb in (1, 2, 8):
            esc = torch.rand(n, generator=g) < [0.0, 0.02, 0.3][trial % 3]
            if trial == 5:
                esc[:] = False
                esc[torch.randperm(n, generator=g)[:eb]] = True
            params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
            sel, eidx = S.escape_select_plain(esc, eb)
            gp = params.to(dev)
            ge = torch.empty(eb, dtype=torch.int64, device=dev)
            S.escape_select(esc.to(dev), eb, ge, gp)
            torch.cuda.synchronize()
            assert int(gp[S.P_ESEL]) == sel
            assert int(gp[S.P_RUNS + S.ESCAPE_RUNS + sel]) == 1
            assert torch.equal(ge.cpu(), eidx)
            _escape_list_equals_twin(dev, esc, eb, 2 * eb, 8 * eb)


def _escape_list_equals_twin(dev, esc, eb, m, mb):
    """escape_select with a list of big chunks of mb and small ones of m
    against its twins: the selection and, on many, every escaped stream
    lowest first, padded with N, and the chunk plan (P_CHUNKS, P_TAIL,
    P_TAILS; else none, the list left), P_CHUNK 0."""
    from headtrackr_tpu_torch.kernels import schedule as S
    n = esc.shape[0]
    sel, eidx = S.escape_select_plain(esc, eb)
    want, plan = S.escape_list_plain(esc, m, mb)
    gp = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    gp[S.P_CHUNK] = 5
    gp = gp.to(dev)
    ge = torch.empty(eb, dtype=torch.int64, device=dev)
    gl = torch.full_like(want, -1, device=dev)
    S.escape_select(esc.to(dev), eb, ge, gp, gl, m, mb)
    torch.cuda.synchronize()
    where = f"n {n} eb {eb} m {m} mb {mb} escaped {int(esc.sum())}"
    assert int(gp[S.P_ESEL]) == sel and int(gp[S.P_CHUNK]) == 0, where
    assert torch.equal(ge.cpu(), eidx), where
    words = gp[[S.P_CHUNKS, S.P_TAIL, S.P_TAILS]].tolist()
    if sel == 2:
        assert torch.equal(gl.cpu(), want), where
        assert tuple(words) == plan, where
    else:
        assert (gl == -1).all() and words == [0, 0, 0], where


@pytest.mark.parametrize("n", [256, 10240, 70000])
def test_escape_list_equals_twin(dev, n):
    """escape_select's list for the many escape body against its twin at
    the headline's 256 streams, the 10,240 of one card and F32's 70,000
    (a grid of select CTAs whose last merges the list in order): random
    shares of escaped streams with the first and the last among them,
    every stream, and small and big chunks of 8 and 64, 32 and 256, 128
    and 128."""
    g = torch.Generator().manual_seed(n)
    for share in (0.001, 0.01, 0.3, 1.0):
        esc = torch.rand(n, generator=g) < share
        esc[[0, n - 1]] = True
        for m, mb in ((8, 64), (32, 256), (128, 128)):
            _escape_list_equals_twin(dev, esc, 8, m, mb)


def test_schedule_copy_kernels_equal_twins(dev):
    """scan_step copies tick k's frames from the address word tick_select
    writes (P_FRAME_AT: P_FRAMES + k frame bytes) into the buffer, whole
    and in rows mode (served slots with padding, repeats, every row; a
    buffer poisoned with 255), on aligned and odd sizes and a tick off the
    16-byte grid; each run and copy counted by mode.  scan_commit
    copies its segments whole and into row k of their packs, as their
    twins do."""
    from headtrackr_tpu_torch.kernels import schedule as S
    g = torch.Generator().manual_seed(7)
    for shape in [(3, 4, 24, 32, 3), (2, 3, 5, 7, 3), (2, 9, 240, 320, 3)]:
        seq = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
        n = shape[1]
        gseq = seq.to(dev)
        for offset in (0, 1):  # a scan staged off the 16-byte grid
            flat = torch.zeros(gseq.numel() + 16, dtype=torch.uint8,
                               device=dev)
            src = flat[offset:offset + gseq.numel()].view(shape)
            src.copy_(gseq)
            for k in range(shape[0]):
                params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
                params[S.P_K], params[S.P_TICKS] = k, shape[0]
                params[S.P_FRAMES] = src.data_ptr()
                gp = params.to(dev)
                mode = torch.full((n,), tft.MODE_CS, dtype=torch.int32,
                                  device=dev)
                S.tick_select(mode, torch.zeros_like(mode), 1, 1, False,
                              torch.empty(1, dtype=torch.int64, device=dev),
                              torch.empty_like(mode), gp,
                              frame_bytes=seq[0].numel())
                cases = [None, torch.tensor([n - 1, n, 0]),
                         torch.tensor([n, n]), torch.arange(n - 1, -1, -1),
                         torch.tensor([1, 1, n]), torch.tensor([0])]
                for rows in cases:
                    frames = torch.full(shape[1:], 255, dtype=torch.uint8,
                                        device=dev)
                    before = int(gp[S.P_STEPS])
                    S.scan_step(gp, frames,
                                None if rows is None else rows.to(dev))
                    want = torch.full(shape[1:], 255, dtype=torch.uint8)
                    S.scan_step_plain(seq[k], want, rows)
                    torch.cuda.synchronize()
                    where = f"{shape} offset {offset} k {k} rows {rows}"
                    assert torch.equal(frames.cpu(), want), where
                    assert int(gp[S.P_STEPS]) == before + 1, where
    for n in (5, 16, 256):  # rows of 5 bools, i32 and f32: off the grid
        _commit_equals_twin(dev, g, n)


def _commit_equals_twin(dev, g, n):
    """scan_commit against scan_commit_plain on four tables (two tick
    bodies', an empty one in the few body's place, the many body's) of
    state leaves (one of 4,096 floats a stream) and output rows of three
    dtypes: each table by index, the tick body's (TABLE_TICK: P_BRANCH's)
    and the program's pick (TABLE_PICK: none when P_ESEL is 1 or 2, an
    escape body's tick, which its IF graph commits; else P_BRANCH's), and
    the tick body's with held rows (the escaped flags of P_BRANCH's body:
    the rows of the leaves flagged held left, as ``Hold`` leaves them),
    into destinations poisoned first; one run counted in P_COMMITS and
    none where the pick is none (nothing written); CHUNK_NEXT advances
    P_CHUNK and counts in P_CHUNK_RUNS."""
    from headtrackr_tpu_torch.kernels import schedule as S
    K, k = 3, 1
    shapes = [((n, 7), torch.float32), ((n,), torch.int32),
              ((n,), torch.bool), ((n, 4096), torch.float32)]
    out_spec = [(torch.float32, 0, 0), (torch.float32, 0, 1),
                (torch.int32, 1, 0), (torch.bool, 2, 0)]

    def rand(shape, dtype):
        if dtype == torch.bool:
            return torch.rand(shape, generator=g) < 0.5
        return torch.randint(-9, 99, shape, generator=g).to(dtype)

    tables, cpu = [], []
    for t in range(4):
        srcs = [rand(sh, dt) for sh, dt in shapes][:0 if t == 2 else 4]
        outs = [rand((n,), dt) for dt, _, _ in out_spec][:0 if t == 2 else 4]
        cpu.append((srcs, outs))
        tables.append(([(x.to(dev), torch.full_like(x.to(dev), 7))
                        for x in srcs],
                       [(v.to(dev), slot, row) for v, (_, slot, row) in
                        zip(outs, out_spec)]))
    held = tuple(d for t in tables[:2] for _, d in t[0][:3])
    ct = S.segments(tables, dev, held)
    flags = [torch.rand(n, generator=g) < 0.3 for _ in range(2)]
    for f in flags:
        f[[0, n - 1]] = True
    gflags = [f.to(dev) for f in flags]
    esc_at = torch.tensor([f.data_ptr() for f in gflags], dtype=torch.int64,
                          device=dev)
    packs = [torch.full((2, K, n), 7, dtype=torch.float32, device=dev),
             torch.full((1, K, n), 7, dtype=torch.int32, device=dev),
             torch.ones((1, K, n), dtype=torch.bool, device=dev)]
    params = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
    params[S.P_K], params[S.P_TICKS] = k + 1, K  # row k = P_K - 1
    for j, pk in enumerate(packs):
        params[S.P_OUT + j] = pk.data_ptr()
    # (table, branch, esel, hold): by index; the tick body's; the
    # program's picks (esel 1 and 2 none); the tick body's with held rows
    pick, tick = S.TABLE_PICK, S.TABLE_TICK
    for table, branch, esel, hold in ((0, 0, 0, 0), (1, 0, 0, 0),
                                      (tick, 1, 1, 0), (tick, 0, 2, 0),
                                      (pick, 1, 0, 0), (pick, 0, 1, 0),
                                      (pick, 1, 2, 0), (tick, 0, 2, 1),
                                      (tick, 1, 2, 1), (2, 1, 2, 1)):
        want_t = table if table >= 0 else branch if (
            not esel or table == tick) else None
        for t in tables:
            for _, d in t[0]:
                d.fill_(7)
        for pk in packs:
            pk.fill_(7)
        gp = params.clone()
        gp[S.P_BRANCH], gp[S.P_ESEL] = branch, esel
        gp[S.P_CHUNK], gp[S.P_CHUNKS] = 2, 3
        gp = gp.to(dev)
        S.scan_commit(gp, ct, table, esc_at if hold else None,
                      S.CHUNK_NEXT if hold else 0)
        srcs, outs = cpu[2 if want_t is None else want_t]
        wdst = [torch.full_like(x, 7) for x in srcs]
        wpacks = [torch.full((2, K, n), 7, dtype=torch.float32),
                  torch.full((1, K, n), 7, dtype=torch.int32),
                  torch.ones((1, K, n), dtype=torch.bool)]
        dsts = [] if want_t is None else [d for _, d in tables[want_t][0]]
        S.scan_commit_plain(k, list(zip(srcs, wdst)),
                            [(v, wpacks[slot], row) for v, (_, slot, row) in
                             zip(outs, out_spec)],
                            hold=S.Hold(flags[branch], tuple(
                                w for w, d in zip(wdst, dsts)
                                if any(d is h for h in held)))
                            if hold else None)
        torch.cuda.synchronize()
        where = f"n {n} table {table} branch {branch} esel {esel} {hold}"
        if want_t is None:  # nothing written
            for t in tables:
                for _, d in t[0]:
                    assert torch.equal(d, torch.full_like(d, 7)), where
        for (_, d), w in zip([] if want_t is None else tables[want_t][0],
                             wdst):
            assert torch.equal(d.cpu(), w), where
        for pk, w in zip(packs, wpacks):
            assert torch.equal(pk.cpu(), w), where
        ran = 0 if want_t is None else 1
        assert int(gp[S.P_COMMITS]) == ran, where
        assert int(gp[S.P_CHUNK]) == 2 + ran * hold, where
        assert int(gp[S.P_CHUNK_RUNS]) == ran * hold, where


@pytest.mark.parametrize("overload", ["full", "rotate"])
@pytest.mark.parametrize("config", ["headline", "band", "full-frame"])
def test_program_equals_per_tick_path(dev, overload, config):
    """The serving program (one launch a step_auto or run_scan call)
    against the per-tick path run eagerly on the card, 8 streams, bucket
    1, escape_bucket 1, in three configurations (a 64x96 band with
    bandHist, the band with full-frame histograms, the full frame with
    hist4096), with the many escape body's list and chunk slots poisoned
    before each call and the bodies' frame buffer freed once they were
    captured (a frame reader left on the buffer where it should read the
    tick's frames in place would differ): every output of every tick and
    the final state bit-equal
    through wbtrack, full or the rotation, bucket and chunk ticks, and
    with a band escapes of one stream (few) and of two (many, in chunks
    of one stream); the per-tick path's host code is not reached; each
    body keeps its own results (the few body's tick commits the tick
    body's table and then its own rows; the many body's the tick body's
    with the escaped rows held, then a commit a chunk); scan_step runs
    on no tick, in every configuration."""
    from headtrackr_tpu_torch.kernels import launch as L
    H, W, n = 120, 160, 8
    clip = _serving_clip(H, W, n)
    clip[22:, 7] = clip[22:, 6]  # from tick 22 one stream escapes, not two
    kw = dict(bucket=1, escape_bucket=1, overload=overload,
              **{"headline": dict(band=(64, 96), bandHist=True),
                 "band": dict(band=(64, 96)),
                 "full-frame": dict(band=None, histKernel="pallas")}[config])
    mk = lambda: BatchedTracker(n, (H, W), cascade=toy_cascade(),  # noqa: E731
                                device=dev, **kw)
    eager, program = mk(), mk()
    eager._steps.scheduled = False
    program._steps.escape_chunk, program._steps.escape_tail = 4, 1
    program.warmup(scan_len=10)
    prog = program._steps._programs[n]
    band = config != "full-frame"
    assert (prog.many is not None) == band
    assert prog.bufs._frames is None  # freed once the bodies were captured

    def poison():
        for t in (prog.bufs.elist, prog.bufs.cidx, prog.bufs.tidx):
            t.fill_(0)

    want = [[v.cpu().numpy() for v in eager.step_auto(f)] for f in clip]
    L.reset_launches()
    got = []
    for f in clip[:4]:
        poison()
        got.append([v.cpu().numpy() for v in program.step_auto(f)])
    runs, chunks = np.zeros(16, int), 0
    for part in (clip[4:14], clip[14:]):
        poison()
        out = program.run_scan(part)
        runs += prog.runs
        chunks += prog.chunks
        got += [[v[k].cpu().numpy() for v in out] for k in range(len(part))]
    assert L.host_paths == dict.fromkeys(L.host_paths, 0)
    # the schedule kernels' counts, read back from the card: one a tick
    # (escape_select with a band), scan_commit's also one a few body's run
    # (its rows) and one a chunk of the many body's (its rows; the held
    # tick commit in place of the common one); scan_step's none: no body
    # copies a frame
    fields = tft.StepOutput._fields
    escaped = [int(t[fields.index("escaped")].sum()) for t in want]
    escaping = sum(e > 0 for e in escaped)
    assert escaping == runs[9] + runs[10]
    assert chunks == sum(e for e in escaped if e > 1)
    assert L.launches["tick_select"] == len(clip)
    assert L.launches["escape_select"] == (len(clip) if band else 0)
    assert L.launches["scan_commit"] == len(clip) + runs[9] + chunks
    copying = sum(program.branch(t[fields.index("detection")]) != "track"
                  for t in want)
    assert L.launches["scan_step"] == 0
    assert 0 < copying < len(clip)  # ticks that once copied ran
    assert escaping > 0 or not band
    for t, (a_t, b_t) in enumerate(zip(want, got)):
        for name, a, b in zip(tft.StepOutput._fields, a_t, b_t):
            np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
    for x, y in zip(_leaves(eager.state), _leaves(program.state)):
        assert torch.equal(x, y)
    if band:
        assert runs[9] > 0 and runs[10] > 0  # few and many escape bodies ran
    else:
        assert escaping == 0


def test_many_body_chunks_equal_per_tick_path(dev):
    """The many escape body over several chunks of each size: 16 streams,
    every odd one's face taller than the 64-row band (8 escapes a band
    tick), bandHist, escape_bucket 1, big chunks of 3 streams and small
    ones of 1, so that a band tick runs two big chunks and then two small
    ones (``schedule.chunk_plan``); the list and chunk slots poisoned
    before each call, the frame buffer freed.  Every output of every tick and the
    final state bit-equal to the per-tick path run eagerly on the card;
    the program's big and small chunks those of the plan."""
    from headtrackr_tpu_torch.kernels import schedule as S
    H, W, n = 120, 160, 16
    clip = _serving_clip(H, W, n, tall=2)
    mk = lambda: BatchedTracker(n, (H, W), cascade=toy_cascade(),  # noqa: E731
                                device=dev, bucket=1, escape_bucket=1,
                                band=(64, 96), bandHist=True)
    eager, program = mk(), mk()
    eager._steps.scheduled = False
    program._steps.escape_chunk, program._steps.escape_tail = 3, 1
    program.warmup(scan_len=10)
    prog = program._steps._programs[n]
    assert (prog.bufs.m, prog.bufs.ms) == (3, 1)
    want = [[v.cpu().numpy() for v in eager.step_auto(f)] for f in clip]
    got, big, chunks = [], 0, 0
    assert prog.bufs._frames is None
    for part in (clip[:10], clip[10:20], clip[20:]):
        for t in (prog.bufs.elist, prog.bufs.cidx, prog.bufs.tidx):
            t.fill_(0)
        out = program.run_scan(part)
        big += prog.big_chunks
        chunks += prog.chunks
        got += [[v[k].cpu().numpy() for v in out] for k in range(len(part))]
    fields = tft.StepOutput._fields
    escaped = [int(t[fields.index("escaped")].sum()) for t in want]
    plans = [S.chunk_plan(e, 1, 3) for e in escaped if e > 1]  # many
    plans = [(b, tails - tail0) for b, tail0, tails in plans]
    assert (2, 2) in plans  # 8 escapes: two big chunks, two small
    assert (big, chunks - big) == (sum(p[0] for p in plans),
                                   sum(p[1] for p in plans))
    for t, (a_t, b_t) in enumerate(zip(want, got)):
        for name, a, b in zip(fields, a_t, b_t):
            np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
    for x, y in zip(_leaves(eager.state), _leaves(program.state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [65535, 65536, 70000])
def test_kernels_past_the_grid_equal_twins(dev, n):
    """F32: every kernel whose grid's y dimension is the stream
    (hist4096, histpdf_band hist-only, pdf direct and through the address
    word, backproject over the frame and the band, hist_mma, pyramid,
    cascade) at n streams of 160x120 (tools/torch_f32_cases.py check):
    bit-equal to its twin, one launch a chunk of 65,535 streams; each
    launcher refuses 65,536 and kernels/launch.py's launch then raises."""
    from headtrackr_tpu_torch.kernels import launch as L
    cases = _tool("torch_f32_cases")
    res = cases.check(n, dev)
    assert set(res) >= {"hist4096", "histpdf_band", "histpdf_band in place",
                        "backproject", "backproject_rect", "hist_mma",
                        "pyramid", "cascade"}
    assert all(r["max_abs_err"] == 0.0 for r in res.values())
    assert res["hist4096"]["chunks"] == (1 if n <= 65535 else 2)
    assert cases.refusals() == []
    with pytest.raises(RuntimeError, match="hist4096 launch failed"):
        L.launch("hist4096", "hist4096_launch", 0, 0, 0, 65536, 120, 160, 1,
                 0, 0)


def test_program_past_the_grid_equals_per_tick_path(dev):
    """F32: step_auto and run_scan at 70,000 streams of 160x120 (the cold
    start's wbtrack ticks, the full tick on every stream, all-CS ticks, a
    run_scan of 2) bit-equal to the per-tick path, tick for tick, and the
    final state (tools/torch_f32_cases.py program_check)."""
    res = _tool("torch_f32_cases").program_check(70000, dev)
    assert res["locked"] > 0.99 * 70000
    assert res["runs"][0] > 0  # all-CS ticks ran


@pytest.mark.parametrize("n", [1, 8, 31, 32, 33, 63, 64, 65, 256, 70000])
def test_tick_epilogue_bit_equal_to_twin(dev, n):
    """tick_epilogue against its twin run on the card
    (tools/torch_epilogue_cases.py check): the finish alone, the "track"
    step's end with and without the band's flags, the supervision of each
    variant, under each of the 64 configurations of the flag grid, then
    8 of them on inputs whose rows lie far apart (staged a word an
    element); bit-equal (NaN-equal), the same leaves passed through, one
    launch a call; at the sizes around the kernel's 32-stream CTAs too."""
    cases = _tool("torch_epilogue_cases")
    res = cases.check(n, dev)
    assert res["launches"] == res["runs"] == (64 + 8) * len(cases.FORMS)
    if n >= 256:  # every branch taken
        assert all(res[k] for k in ("activations", "lost", "nan_angles",
                                    "escaped", "head_valid")), res


def test_every_program_body_runs_the_epilogue(dev):
    """Each body of the serving program (all-CS, the bucket at each slot
    count, wbtrack, full, few, many) launches tick_epilogue, and the
    all-CS body holds no PyTorch op of the epilogue or of the band's
    placement (the band kernels place it from the windows): at most 5
    graph nodes, its kernels histpdf_band, meanshift and tick_epilogue."""
    from chip_smoke import epilogue_bodies
    bt = BatchedTracker(16, (120, 160), cascade=toy_cascade(), device=dev,
                        band=(64, 96), bandHist=True, bucket=2)
    bt.warmup(scan_len=2)
    bodies = epilogue_bodies(bt)
    assert {"0", "2", "wbtrack", "full", "few", "many"} <= set(bodies)
    assert bodies["0"]["tick_epilogue"] == 1
    assert bodies["0"]["nodes"] <= 5, bodies["0"]


@pytest.mark.parametrize("n", [1, 8, 256, 70000])
def test_bucket_kernels_bit_equal_to_twins(dev, n):
    """frame_prep (K9), handoff (K7, both forms, the audit on and off) and
    slot_gather (S5) against their twins run on the card
    (tools/torch_bucket_cases.py check), bit-equal, one launch a call,
    over every stream and through slots padded with N."""
    res = _tool("torch_bucket_cases").check(n, dev)
    assert res["launches"] == {"frame_prep": 4, "handoff": 4,
                               "slot_gather": 1}, res
    if n >= 256:  # every branch taken
        assert all(res[k] for k in ("stable", "switched", "dirty", "clean",
                                    "kept")), res


@pytest.mark.parametrize("n", [1, 8, 256, 70000])
def test_bucket_kernels_bit_equal_to_twins_at_every_split(dev, n):
    """frame_prep (K9) and handoff (K7, the init form with the audit on
    and off, the handoff form with it) with their split forced to every P
    the launchers can pick (1, 2, 4, 8, 16), against their twins taking
    the same P (tools/torch_bucket_cases.py check_splits), bit-equal, one
    launch a call; a model-colored pixel just outside the band on a row
    where the audit's shares meet."""
    cases = _tool("torch_bucket_cases")
    res = cases.check_splits(n, dev)
    assert res["launches"] == {p: {"frame_prep": 4, "handoff": 3}
                               for p in cases.SPLITS}, res
    if n >= 256:
        assert res["dirty"] and res["clean"], res


@pytest.mark.parametrize("n", [8, 256])
def test_frame_prep_and_handoff_in_place_bit_equal_to_direct(dev, n):
    """frame_prep (gray and not, every stream and through slots) and
    handoff (the init form with the audit, the handoff form) reading tick
    2 of a 3-tick scan in place (launch.frames_at through a device word)
    against the same kernels reading that tick directly
    (tools/torch_bucket_cases.py check_in_place): bit-equal at 320x240
    and 57x99 (H W % 16 != 0, W % 16 != 0), the scan staged on a 16-byte
    boundary and 4 and 1 bytes past it; one launch a call; the buffer
    they were given untouched."""
    cases = _tool("torch_bucket_cases")
    res = cases.check_in_place(n, dev)
    calls = 8  # frame_prep x 4, handoff x 4
    shapes, offsets = len(cases.IN_PLACE_SHAPES), len(cases.IN_PLACE_OFFSETS)
    assert res["cases"] == shapes * offsets * calls, res
    assert res["launches"] == shapes * (1 + offsets) * calls, res


@pytest.mark.parametrize("overload", ["full", "rotate"])
def test_program_at_256_streams_equals_per_tick_path(dev, overload):
    """The headline configuration's serving program at 256 streams of
    120x160 (bucket 8, a 64x96 band with bandHist) against the per-tick
    path run eagerly on the card, over the cold start (wbtrack ticks,
    then the full tick or the rotation's burst of every stream pending), a
    relock and the band's escapes, the bodies' frame buffer freed once
    they were captured: every output of every tick and the final state
    bit-equal; scan_step runs on no tick."""
    from headtrackr_tpu_torch.kernels import launch as L
    H, W, n = 120, 160, 256
    clip = _serving_clip(H, W, n)
    mk = lambda: BatchedTracker(n, (H, W), cascade=toy_cascade(),  # noqa: E731
                                device=dev, bucket=8, band=(64, 96),
                                bandHist=True, overload=overload)
    eager, program = mk(), mk()
    eager._steps.scheduled = False
    program.warmup(scan_len=10)
    prog = program._steps._programs[n]
    assert prog.bufs._frames is None
    want = [[v.cpu().numpy() for v in eager.step_auto(f)] for f in clip]
    L.reset_launches()
    got, runs = [], np.zeros(16, int)
    for part in (clip[:10], clip[10:20], clip[20:]):
        out = program.run_scan(part)
        runs += prog.runs
        got += [[v[k].cpu().numpy() for v in out] for k in range(len(part))]
    assert L.launches["scan_step"] == 0
    keys = program._steps.body_keys(n)
    ran = {keys[b] for b in range(len(keys)) if runs[b]}
    assert {0, "wbtrack"} <= ran, ran
    assert ("full" in ran) == (overload == "full"), ran
    assert ran & set(range(1, 33)), ran  # bucket ticks: the rotation, a relock
    for t, (a_t, b_t) in enumerate(zip(want, got)):
        for name, a, b in zip(tft.StepOutput._fields, a_t, b_t):
            np.testing.assert_array_equal(b, a, err_msg=f"tick {t} {name}")
    for x, y in zip(_leaves(eager.state), _leaves(program.state)):
        assert torch.equal(x, y)


def test_bucket_split_picks(dev):
    """The launchers' split on this card: a power of two <= 16, 16 at the
    relock bucket's 8 slots, 1 at 256 streams and past; the streams times
    the split stay on the grid's x."""
    from headtrackr_tpu_torch.kernels import frameprep, handoff
    from headtrackr_tpu_torch.kernels.launch import sm_count
    sms = sm_count(dev)
    for mod in (frameprep, handoff):
        assert mod.pick_split(8, sms) == 16
        assert mod.pick_split(256, sms) == 1
        assert mod.pick_split(70000, sms) == 1


def test_bucket_body_runs_its_kernels_and_commits_rows(dev):
    """The headline's bucket body (256 streams of 320x240, bucket 8)
    launches slot_gather, frame_prep and handoff once a run (and
    tick_epilogue twice: its track pass's and its "pending" step's) and no
    PyTorch op over the whole state: at most 70 graph nodes; its commit
    table moves under 0.25 MB (the track pass's changed leaves and the 8
    served rows), the model histograms by their served rows alone."""
    from chip_smoke import node_kinds
    from headtrackr_tpu_torch.kernels import schedule as S
    bt = BatchedTracker(256, (240, 320), cascade=toy_cascade(), device=dev,
                        band=(96, 128), bandHist=True, bucket=8)
    bt.warmup(scan_len=2)
    prog = bt._steps.program(bt.state)
    body = prog.bodies[1]
    assert body.merge is not None
    for k, runs in (("slot_gather", 1), ("frame_prep", 1), ("handoff", 1),
                    ("tick_epilogue", 2)):
        assert body.launches[k] == runs, (k, body.launches)
    assert len(node_kinds(body.graph)) <= 70
    first, count = prog._commit.tables[1, :2].tolist()
    moved = int(prog._commit.segs[first:first + count, 2].sum())
    assert moved < 250_000, moved
    kinds = prog._commit.merges[first:first + count, 3].tolist()
    assert S.MERGE_ROWS in kinds and S.MERGED in kinds


@pytest.mark.parametrize("n", [1, 8, 256, 70000])
def test_slot_gather_bit_equal_at_every_slot_count(dev, n):
    """slot_gather (S5) against its twin run on the card
    (tools/torch_bucket_cases.py check_gather): every slot count from 1 to
    the chunk cap and at escape_bucket, under the bucket's and the
    escape's keep rules, 1-D strided f32 and bool leaves, the frames as an
    extra leaf; bit-equal, one launch a call, the launcher's grid equal to
    gather_ctas."""
    res = _tool("torch_bucket_cases").check_gather(n, dev)
    assert res["launches"] == res["calls"], res
    if n >= 8:
        assert res["kept escape"] > res["kept bucket"] > 0, res


def test_few_body_gathers_once_and_commits_rows(dev):
    """The headline's few escape body (256 streams of 320x240, bucket 8,
    escape_bucket 8) launches slot_gather once and then the full-frame
    "track" step, in at most the step's own graph nodes + 2, and keeps its
    sub-batch alone: its commit table holds rows alone (the changed leaves'
    and the outputs' kept rows), under 0.15 MB, no leaf whole."""
    import collections
    from chip_smoke import graph_nodes, node_kinds
    from headtrackr_tpu_torch.kernels import schedule as S
    from headtrackr_tpu_torch.models import facetracker as ft
    bt = BatchedTracker(256, (240, 320), cascade=toy_cascade(), device=dev,
                        band=(96, 128), bandHist=True, bucket=8)
    bt.warmup(scan_len=2)
    steps = bt._steps
    prog = steps.program(bt.state)
    few = prog.few
    assert few.merge is not None and few.state is None
    assert few.launches["slot_gather"] == 1, few.launches
    idx = torch.arange(steps.escape_bucket, device=dev)
    sub = ft.tree_index(prog.bufs.state_in, idx)
    rows = torch.zeros((idx.numel(),) + prog.bufs.frames_shape[1:],
                       dtype=torch.uint8, device=dev)
    alone = graph_nodes(lambda: steps._track_plain(sub, rows))
    kinds = collections.Counter(node_kinds(few.graph))
    assert sum(kinds.values()) <= len(alone) + 2, (kinds, alone)
    first, count = prog._commit.tables[len(prog.bodies), :2].tolist()
    moved = int(prog._commit.segs[first:first + count, 2].sum())
    assert 0 < moved < 150_000, moved
    assert set(prog._commit.merges[first:first + count, 3].tolist()) == \
        {S.MERGE_ROWS}


def test_many_body_gathers_chunks_and_commits_rows(dev):
    """The headline's many escape body (256 streams of 320x240, bucket 8,
    escape_bucket 8): each chunk body (big and small) launches
    slot_gather once (a chunk of escape_select's list, the tick's frames
    read in place: no copy) and then the full-frame "track" step, its
    graph nothing but launches of the package's hand-written kernels (no
    PyTorch operation, memcpy or memset: no leaf copied whole); each
    commit table holds rows alone, the chunk's kept rows, as many bytes a
    row as the few body's table (the step passes the model histograms
    through); the tick bodies' tables flag every carried state leaf but
    pend_age held."""
    import pathlib
    import chip_smoke
    from headtrackr_tpu_torch.kernels import schedule as S
    root = pathlib.Path(__file__).resolve().parent.parent
    bt = BatchedTracker(256, (240, 320), cascade=toy_cascade(), device=dev,
                        band=(96, 128), bandHist=True, bucket=8)
    bt.warmup(scan_len=2)
    prog = bt._steps.program(bt.state)
    m, ms = prog.bufs.m, prog.bufs.ms
    assert m % ms == 0 and ms % 8 == 0
    for body in (prog.many, prog.tail):
        assert body.merge is not None and body.state is None
        assert body.launches["slot_gather"] == 1, body.launches
        names = chip_smoke.node_names(body.graph)
        assert chip_smoke.foreign_nodes(body.graph, str(root)) == [], names
        assert set(chip_smoke.node_kinds(body.graph)) == {"kernel"}, names
    ct = prog._commit
    moved = [int(ct.segs[f:f + c, 2].sum())
             for f, c, _, _ in ct.tables[len(prog.bodies):].tolist()]
    assert 0 < moved[1] * prog.eb == moved[0] * m < 1000 * m * prog.eb, moved
    assert moved[2] * prog.eb == moved[0] * ms, moved
    first, count = ct.tables[len(prog.bodies) + 1, :2].tolist()
    assert set(ct.merges[first:first + count, 3].tolist()) == {S.MERGE_ROWS}
    age = prog.bufs.state_in.pend_age.data_ptr()
    first, count = ct.tables[0, :2].tolist()
    for (src, dst, *_), (_, _, _, kind) in zip(
            ct.segs[first:first + count].tolist(),
            ct.merges[first:first + count].tolist()):
        if dst and src:  # a carried state leaf
            assert bool(kind & S.MERGE_HOLD) == (dst != age), (dst, kind)


def _tool(name):
    """tools/<name>.py (a script, loaded by path)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _every_bin_frames(n, shape, dev, g):
    """(n, H, W, 3) u8 on ``dev`` whose pixels take every one of the 4,096
    bins, each stream in its own random order (H W a multiple of 4096),
    the low 4 bits of each byte random."""
    H, W = shape
    perm = torch.argsort(torch.rand((n, H * W // 4096, 4096), generator=g,
                                    device=dev), -1).view(n, H, W)
    rgb = torch.stack([(perm >> 8) << 4, ((perm >> 4) & 15) << 4,
                       (perm & 15) << 4], -1)
    low = torch.randint(0, 16, rgb.shape, generator=g, device=dev)
    return (rgb | low).to(torch.uint8)


def _ratio_tables(n, dev, g):
    """(model, cur) (n, 4096) f32 on ``dev`` hitting every case of the
    ratio weight: cur == 0 with a model bin absent from the frame (model >
    0) and without, model > cur (clamped to 1), model == cur, model 0,
    fractional and denormal counts, an infinite model."""
    cur = torch.randint(0, 6, (n, 4096), generator=g, device=dev).float()
    model = torch.randint(0, 12, (n, 4096), generator=g, device=dev).float()
    cur[:, 0::7] = 0
    model[:, 1::11] = cur[:, 1::11]
    cur[:, 2::13] = 1e-40
    model[:, 3::17] = 0.75
    cur[:, 3::17] = 3.0
    model[:, 5::19] = float("inf")
    cur[:, 6::23] = -0.0
    return model, cur


@pytest.mark.parametrize("n", [1, 8, 256, 70000])
def test_backproject_ratio_bit_equal_to_twin_on_the_card(dev, n):
    """backproject_ratio over the frame and over the band (the kernels
    forming min(model / cur, 1), 0 where cur == 0, as they stage their
    tables) bit-equal to their twins run on the card
    (ops/histogram.py backproject_ratio_plain: backprojection_weights,
    then the lookup), on frames whose pixels take every bin, so that each
    weight is looked up and equals backprojection_weights' on the card;
    one launch a chunk of 65,535 streams (F32)."""
    from headtrackr_tpu_torch.kernels.histbins import row_chunks
    g = torch.Generator(device=dev).manual_seed(n)
    shape, band = (64, 64), (40, 48)
    frames = _every_bin_frames(n, shape, dev, g)
    model, cur = _ratio_tables(n, dev, g)
    wins = torch.cat([torch.randint(-20, 70, (n, 2), generator=g,
                                    device=dev),
                      torch.randint(-5, 60, (n, 2), generator=g,
                                    device=dev)], 1).int()
    chunks = len(row_chunks(n))
    for windows, key in ((None, "backproject_ratio"),
                         (wins, "backproject_rect_ratio")):
        b = None if windows is None else band
        before = launches[key]
        got = K.backproject_ratio(frames, model, cur, windows, b)
        torch.cuda.synchronize()
        assert launches[key] == before + chunks
        rects = None if windows is None else _placed(windows, band, shape)
        want = hg.backproject_ratio_plain(frames, model, cur, rects, b)
        assert torch.equal(got, want), key
        if windows is None:
            weights = hg.backprojection_weights(model, cur)
            bins = hg.rgb_bins(frames).view(n, -1).long()
            assert torch.equal(got.view(n, -1),
                               torch.gather(weights, 1, bins))
        del got, want


@pytest.mark.parametrize("n", [1, 3, 256])
@pytest.mark.parametrize("shape", [(240, 320), (57, 99)])
def test_frame_readers_in_place_equal_direct(dev, shape, n):
    """The camshift step's frame readers reading their frames in place
    (under launch.frames_at: a buffer poisoned with 255, the frames at the
    address an i64 word holds, as the serving program's tick_select sets
    it): hist4096 and hist_mma over the whole frame (no rects),
    backproject_ratio over the frame and the band, and backproject's
    weight forms, each bit-equal to its direct read of the same frames, on
    three ticks of a scan staged on and off the 16-byte grid (hist_mma:
    its bulk copies where the address it loads is aligned and H W % 16 ==
    0, else its per-thread loads), eagerly and replayed from one captured
    graph, the word changed between replays; a direct read of the buffer
    is not redirected."""
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.kernels.histmma import hist_mma
    g = torch.Generator().manual_seed(83 + n)
    H, W = shape
    band = (min(96, H), min(128, W))
    seq = torch.stack([_hist_frames("bench" if k == 1 else "random", n,
                                    shape, g) for k in range(3)])
    model = torch.randint(0, 200, (n, 4096), generator=g).float().to(dev)
    cur = torch.randint(0, 50, (n, 4096), generator=g).float().to(dev)
    w = torch.rand((n, 4096), generator=g).to(dev)
    wins = torch.cat([torch.randint(-20, W, (n, 2), generator=g),
                      torch.randint(0, 90, (n, 2), generator=g)],
                     1).int().to(dev)
    readers = {
        "hist4096": lambda f: K.hist4096(f),
        "hist_mma": lambda f: hist_mma(f),
        "backproject_ratio": lambda f: K.backproject_ratio(f, model, cur),
        "backproject_rect_ratio": lambda f: K.backproject_ratio(
            f, model, cur, wins, band),
        "backproject": lambda f: K.backproject(f, w),
        "backproject_rect": lambda f: K.backproject(f, w, wins, band)}
    buf = torch.full(seq.shape[1:], 255, dtype=torch.uint8, device=dev)
    word = torch.zeros(1, dtype=torch.int64, device=dev)
    for offset in (0, 5):
        flat = torch.zeros(seq.numel() + 16, dtype=torch.uint8, device=dev)
        staged = flat[offset:offset + seq.numel()].view(seq.shape)
        staged.copy_(seq.to(dev))
        for key, read in readers.items():
            want = [read(staged[k]) for k in range(3)]
            for k in range(3):
                word.fill_(staged[k].data_ptr())
                before = launches[key]
                with L.frames_at(buf, word):
                    got = read(buf)
                torch.cuda.synchronize()
                assert launches[key] == before + 1, key
                assert torch.equal(got, want[k]), (key, offset, k)
            assert not torch.equal(read(buf), want[0]), key
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), L.frames_at(buf, word):
                read(buf)
            torch.cuda.current_stream().wait_stream(side)
            with L.frames_at(buf, word), torch.cuda.graph(graph):
                out = read(buf)
            for k in (2, 0, 1):
                word.fill_(staged[k].data_ptr())
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, want[k]), (key, offset, k, "graph")


@pytest.mark.parametrize("kw", [dict(band=(64, 96)), {},
                                dict(histKernel="pallas"),
                                dict(band=(64, 96), bandHist=True)])
def test_all_cs_body_holds_only_hand_written_kernels(dev, kw):
    """The all-CS body of every configuration copies none of the tick's
    frames, and its graph holds no node but launches of the package's
    hand-written kernels (chip_smoke.py foreign_nodes: each kernel node's
    function named in csrc/*.cu): no PyTorch operation, memcpy or
    memset."""
    import pathlib
    import chip_smoke
    root = pathlib.Path(__file__).resolve().parent.parent
    bt = BatchedTracker(3, (120, 160), cascade=toy_cascade(), device=dev,
                        **kw)
    body = bt._steps.captured(bt.state, 0)
    assert bt._steps.copy_mode(0) == "none"
    names = chip_smoke.node_names(body.graph)
    assert chip_smoke.foreign_nodes(body.graph, str(root)) == [], names
    assert len(names) == (3 if kw.get("bandHist") else
                          5 if kw.get("histKernel") is None else 4), names
