"""The ratio weights folded into the backprojection kernels (K11) and the
frame readers over the whole frame, on the CPU against the reference
package.

``backproject_ratio`` forms min(model / cur, 1), 0 where cur == 0, as
its kernel stages its table, and looks it up over the frame or over the
band placed around each window; its twin (``ops/histogram.py``
``backproject_ratio_plain``) is the reference's ``backprojection_weights``
then ``pdf_pallas``, here on tables with zero counts, clamped and equal
bins and model bins absent from the frame.  ``hist4096`` and ``hist_mma``
without rects count the whole frame (``histogram_full`` makes no rect).
``shift`` and ``shift_band`` (without bandHist) equal the reference's
jitted ``track`` / ``track_band`` (kernel="pallas") and dispatch no
PyTorch operation between their kernels.  The serving program copies no
tick's frames before any body (``_Steps.copy_mode``) in any configuration,
and no body reads the bodies' frame buffer.  (The band and full-frame programs against the reference's
``step_auto``, with the frame buffer poisoned, are in
tests/test_torch_slots.py and tests/test_torch_pipeline.py, beside the
fixtures that compile the reference.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from headtrackr_tpu.kernels.histpdf import pdf_pallas
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.ops import histogram as jhg
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import toy_cascade
from headtrackr_tpu_torch.kernels import histmma as KM
from headtrackr_tpu_torch.kernels import histpdf as K
from headtrackr_tpu_torch.kernels import launch as L
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.ops import histogram as thg
from headtrackr_tpu_torch.ops.meanshift import MOMENTS

torch.set_num_threads(2)

H, W = 40, 56
N = 4
BAND = (24, 32)
FACE = (200, 80, 60)
FACE_BIN = 256 * 12 + 16 * 5 + 3


def _frames(rng, n=N):
    f = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    f[:, 10:28, 14:34] = FACE
    f[0, :, :] = (16, 16, 16)  # one stream of one bin
    return f


def _tables(rng, frames):
    """(model, cur) f32 of each case of the ratio weight: cur the frames'
    own counts (zero where a bin is absent), the model random integers
    with bins absent from the frame (model > 0, cur == 0), clamped (model
    > cur), equal (model == cur) and zero."""
    cur = thg.hist4096_plain(torch.as_tensor(frames),
                             thg.full_rects(len(frames), (H, W), "cpu"))
    cur = cur.float().numpy()
    model = rng.integers(0, 6, cur.shape).astype(np.float32)
    model[:, FACE_BIN] = 400  # clamped: the face's bin
    model[:, 1::7] = cur[:, 1::7]  # equal
    model[:, 2::9] = 0
    model[:, 3::5] = 2 * cur[:, 3::5] + 1  # clamped
    absent = (cur == 0) & (model > 0)
    assert absent.any() and (cur == 0).any() and (model == cur).any()
    return model, cur


def _windows(rng, n=N):
    w = np.stack([rng.integers(-20, W + 10, n), rng.integers(-20, H + 10, n),
                  rng.integers(-5, 60, n), rng.integers(-5, 50, n)], 1)
    w[1] = (14, 10, 20, 18)  # the face
    return w.astype(np.int32)


@pytest.mark.parametrize("where", ["frame", "band"])
def test_ratio_twin_matches_reference_weights_and_pdf_pallas(rng, where):
    """backproject_ratio's CPU path (the twin) over the frame and over the
    band placed around each window equals the reference's
    backprojection_weights then pdf_pallas (interpret mode) over the same
    bins, to the bit."""
    frames = _frames(rng)
    model, cur = _tables(rng, frames)
    weights = jax.vmap(jhg.backprojection_weights)(jnp.asarray(model),
                                                   jnp.asarray(cur))
    bins = np.asarray(jax.vmap(jhg.rgb_bins)(jnp.asarray(frames)))
    t = [torch.as_tensor(a) for a in (frames, model, cur)]
    if where == "frame":
        want = np.asarray(jax.vmap(pdf_pallas)(jnp.asarray(bins), weights))
        got = K.backproject_ratio(*t)
    else:
        wins = _windows(rng)
        want = []
        for s in range(N):
            ry, rx, bh, bw = jcs.band_rect(jnp.asarray(wins[s]), BAND,
                                           (H, W))
            ry, rx = int(ry), int(rx)
            want.append(np.asarray(pdf_pallas(
                jnp.asarray(bins[s, ry:ry + bh, rx:rx + bw]), weights[s])))
        want = np.stack(want)
        got = K.backproject_ratio(*t, torch.as_tensor(wins), BAND)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 1).any() and (want == 0).any()


@pytest.mark.parametrize("hist", ["hist4096", "hist_mma"])
def test_whole_frame_histogram_equals_full_rects(rng, hist):
    """hist4096 and hist_mma without rects (the kernel reads none on the
    card) equal their full-frame-rect form; histogram_full passes none."""
    frames = torch.as_tensor(_frames(rng))
    fn = K.hist4096 if hist == "hist4096" else KM.hist_mma
    want = fn(frames, thg.full_rects(N, (H, W), "cpu"))
    assert torch.equal(fn(frames), want)
    assert torch.equal(fn(frames, None), want)
    kernel = "pallas" if hist == "hist4096" else None
    assert torch.equal(thg.histogram_full(frames, kernel), want)


def test_frames_at_redirects_every_reader_on_the_cpu(rng):
    """Under launch.frames_at(buffer, source) each frame reader's twin
    reads source, not the buffer: hist4096, hist_mma, backproject in both
    forms and backproject_ratio over the frame and the band."""
    frames = torch.as_tensor(_frames(rng))
    model, cur = (torch.as_tensor(a) for a in _tables(rng, _frames(rng)))
    wins = torch.as_tensor(_windows(rng))
    buf = torch.full_like(frames, 255)
    readers = [lambda f: K.hist4096(f), lambda f: KM.hist_mma(f),
               lambda f: K.backproject(f, model),
               lambda f: K.backproject(f, model, wins, BAND),
               lambda f: K.backproject_ratio(f, model, cur),
               lambda f: K.backproject_ratio(f, model, cur, wins, BAND)]
    for read in readers:
        with L.frames_at(buf, frames):
            got = read(buf)
            sub = read(buf[:N])  # a view is not redirected
        assert torch.equal(got, read(frames))
        assert torch.equal(sub, read(buf))
    with pytest.raises(ValueError), L.frames_at(buf, frames[:2]):
        K.hist4096(buf)


def _jax_state(model, wins):
    n = len(wins)
    zi = jnp.zeros(n, jnp.int32)
    return jcs.CamshiftState(
        model_hist=jnp.asarray(model), window=jnp.asarray(wins),
        track_x=zi, track_y=zi, track_w=zi, track_h=zi,
        track_angle=jnp.zeros(n, jnp.float32), model_bins=None,
        model_counts=None, model_overflow=None)


def _assert_state(tnew, jnew):
    np.testing.assert_array_equal(tnew.window.numpy(),
                                  np.asarray(jnew.window))
    for k in ("track_x", "track_y", "track_w", "track_h"):
        np.testing.assert_array_equal(getattr(tnew, k).numpy(),
                                      np.asarray(getattr(jnew, k)), k)
    np.testing.assert_allclose(tnew.track_angle.numpy(),
                               np.asarray(jnew.track_angle), rtol=0,
                               atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("kernel", [None, "pallas"])
def test_track_matches_reference(rng, kernel):
    """track (shift: the whole-frame histogram by either histKernel's
    kernel, then backproject_ratio, then the mean shift) equals the
    reference's jitted track with kernel="pallas": windows and boxes
    exact, the angle within 1e-5 (F11), the pdf to the bit."""
    frames = _frames(rng)
    model, _ = _tables(rng, frames)
    wins = _windows(rng)
    step = jax.jit(jax.vmap(lambda s, f: jcs.track(s, f, True,
                                                   kernel="pallas")))
    jnew, jpdf = step(_jax_state(model, wins), jnp.asarray(frames))
    state = tcs.init_state(N, device="cpu")._replace(
        model_hist=torch.as_tensor(model), window=torch.as_tensor(wins))
    tnew, tpdf = tcs.track(state, torch.as_tensor(frames), True,
                           kernel=kernel)
    _assert_state(tnew, jnew)
    np.testing.assert_array_equal(tpdf.numpy(), np.asarray(jpdf))


def test_track_band_matches_reference(rng):
    """track_band without bandHist (shift_band: the whole-frame
    histogram, then backproject_ratio over the band placed around each
    window, then the mean shift) equals the reference's jitted track_band
    (kernel="pallas"): escapes, windows and boxes exact, the angle within
    1e-5."""
    frames = _frames(rng, 6)
    frames[5, 4:38, 6:52] = FACE  # a face taller than the band: escapes
    model, _ = _tables(rng, frames)
    wins = np.concatenate([_windows(rng), [[14, 10, 20, 18],
                                           [6, 4, 46, 34]]]).astype(np.int32)
    step = jax.jit(jax.vmap(lambda s, f: jcs.track_band(
        s, f, True, band=BAND, kernel="pallas", band_hist=False)))
    jnew, jesc = step(_jax_state(model, wins), jnp.asarray(frames))
    state = tcs.init_state(6, device="cpu")._replace(
        model_hist=torch.as_tensor(model), window=torch.as_tensor(wins))
    tnew, tesc = tcs.track_band(state, torch.as_tensor(frames), True,
                                band=BAND, band_hist=False)
    np.testing.assert_array_equal(tesc.numpy(), np.asarray(jesc))
    _assert_state(tnew, jnew)
    assert tesc.any() and not tesc.all()


class _Ops(TorchDispatchMode):
    """Records the ATen operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("where", ["shift", "shift_band"])
def test_shift_dispatches_no_op_between_its_kernels(rng, monkeypatch, where):
    """With the frame readers and the mean shift stubbed, shift and
    shift_band (without bandHist) dispatch no PyTorch operation: no rect
    is made for the whole-frame histogram (the kernels get None) and no
    weight is formed outside backproject_ratio, which gets the state's
    model histogram and the counts as they are."""
    state = tcs.init_state(N, device="cpu")._replace(
        window=torch.as_tensor(_windows(rng)))
    frames = torch.as_tensor(_frames(rng))
    cur = torch.zeros((N, 4096))
    pdf = torch.zeros((N, H, W) if where == "shift" else (N,) + BAND)
    seen = {}
    outs = (state.window, {k: torch.zeros(N) for k in MOMENTS},
            torch.zeros(N, dtype=torch.bool), torch.zeros(N, dtype=torch.bool))

    def fake(name, result):
        def call(*args):
            seen[name] = args
            return result
        return call

    # the histogram kernels behind ops/histogram.py histogram_full
    monkeypatch.setattr(KM, "hist_mma", fake("hist_mma", cur))
    monkeypatch.setattr(K, "hist4096", fake("hist4096", cur))
    monkeypatch.setattr(tcs, "backproject_ratio",
                        fake("backproject_ratio", pdf))
    monkeypatch.setattr(tcs._ms, "mean_shift", fake("mean_shift", outs))
    with _Ops() as mode:
        if where == "shift":
            got = tcs.shift(state, frames, "pallas")
        else:
            got = tcs.shift_band(state, frames, BAND, band_hist=False)
    assert mode.ops == []
    hist = "hist4096" if where == "shift" else "hist_mma"
    assert seen[hist] == (frames, None)
    args = seen["backproject_ratio"]
    assert args[0] is frames and args[1] is state.model_hist
    assert args[2] is cur
    if where == "shift_band":
        assert args[3] is state.window and args[4] == BAND
    assert seen["mean_shift"][0] is pdf
    assert got[0] is state.window


CONFIGS = {"headline": dict(band=(24, 32), bandHist=True),
           "band": dict(band=(24, 32), bandHist=False),
           "full-frame": dict(band=None, histKernel="pallas"),
           "full-frame mma": dict(band=None)}


def _tensors(tree):
    """The tensors of a body's results (NamedTuples of tensors and None)."""
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.mark.parametrize("config", list(CONFIGS))
def test_copy_mode_is_one_table_in_every_configuration(config):
    """What the serving program copies of a tick's frames before each
    body, every configuration x every body key: none.  Each body (its
    twin, run as the program's CPU twin runs it: under launch.frames_at,
    its frames the tick's) gives the same results with the bodies' frame
    buffer filled with 255 as with the buffer holding the tick's frames:
    no frame reader of any body (the camshift step's, frame_prep,
    handoff, slot_gather) reads the buffer."""
    n = 12
    tb = pt.BatchedTracker(n, (H, W), cascade=toy_cascade(), device="cpu",
                           bucket=2, escape_bucket=4, **CONFIGS[config])
    steps = tb._steps
    keys = steps.body_keys(n)
    assert keys[0] == 0 and keys[-2:] == ["wbtrack", "full"]
    assert len(keys) > 4  # bucket bodies at several slot counts
    if CONFIGS[config]["band"] is not None:
        keys += ["few", "many"]
    rng = np.random.default_rng(5)
    tick = torch.as_tensor(_frames(rng, n))
    state = tb.state._replace(mode=torch.as_tensor(
        np.arange(n) % 3, dtype=torch.int32))  # WB, VJ and CS streams
    bufs = steps.buffers(state)
    for t, v in zip(_tensors(bufs.state_in), _tensors(state)):
        t.copy_(v)
    bufs.idx.copy_(torch.arange(bufs.idx.numel()) * 2 % (n + 1))
    for key in keys:
        body = steps.captured(state, key)
        assert steps.copy_mode(key) == "none", key
        assert not hasattr(body, "rows") and not hasattr(body, "copy"), key
        got = []
        for fill in (None, 255):
            if fill is None:
                bufs.frames.copy_(tick)
            else:
                bufs.frames.fill_(fill)
            got.append(_tensors(body.run(tick)))
        assert len(got[0]) == len(got[1]) > 0, key
        for a, b in zip(*got):
            np.testing.assert_array_equal(b.numpy(), a.numpy(),
                                          err_msg=str(key))
