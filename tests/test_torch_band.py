"""The port's band-local camshift pieces against the reference package.

  * band placement (band_rect), band_for, parse_band;
  * track_band (bandHist on and off) against the reference's
    ``track_band(kernel="pallas")`` (interpret mode on the CPU) on blob
    clips: windows, track_x/y/w/h and escaped exact, the angle by the rule
    of tests/test_torch_camshift.py; a band too small for the window
    escapes;
  * the kernels' plain twins: histpdf_band (pdf mode, the band placed
    from each search window) against hist_pallas + backprojection_weights
    + pdf_pallas on the band's bins, hist-only mode against
    histogram_rect, the band backprojection against pdf_pallas, exact;
  * handoff_band_audit, clean and dirty;
  * the "wbtrack" step with a band on a WB / VJ / CS batch;
  * no silent CPU fallback: without a card, device=None raises in
    BatchedTracker, state_from_numpy, init_state, make_step and
    detector_tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.cascade import toy_cascade as j_toy
from headtrackr_tpu.kernels.histpdf import hist_pallas, pdf_pallas
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu.ops import histogram as jhg
from headtrackr_tpu.oracle.camshift import CamshiftTracker
from headtrackr_tpu_torch import BatchedTracker, TrackerConfig, convert
from headtrackr_tpu_torch import toy_cascade
from headtrackr_tpu_torch.kernels import histpdf as K
from headtrackr_tpu_torch.kernels.launch import launches
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.models.detector import detector_tables
from headtrackr_tpu_torch.ops import histogram as thg

from test_torch_camshift import _check

torch.set_num_threads(2)

H, W = 72, 96
BAND = (48, 64)


def _blob_frame(rng, cx, cy, hw=6, hh=8):
    f = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
    y0, y1 = max(0, cy - hh), min(H, cy + hh)
    x0, x1 = max(0, cx - hw), min(W, cx + hw)
    f[y0:y1, x0:x1, 0] = 200 + rng.integers(0, 30, (y1 - y0, x1 - x0))
    f[y0:y1, x0:x1, 1] = 80
    f[y0:y1, x0:x1, 2] = 60
    return f


def _start(frames0, rects):
    """Reference handoff states -> (jax states, the port's CamshiftState)."""
    js = [jcs.init_tracker(jnp.asarray(f), jnp.asarray(r, jnp.int32))
          for f, r in zip(frames0, rects)]
    batch = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (len(js),) + x.shape), jft.init_state())
    batch = batch._replace(
        cs=jax.tree_util.tree_map(lambda *a: jnp.stack(a), *js))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(batch)]
    return js, convert.state_from_numpy(leaves, device="cpu").cs


def test_band_placement_and_sizing_match_reference(rng):
    wins = np.concatenate([rng.integers(-30, 200, (64, 2)),
                           rng.integers(0, 120, (64, 2))], 1).astype(np.int32)
    for band in ((48, 64), (128, 192), (96, 400), (7, 13)):
        for shape in ((240, 320), (72, 96)):
            ry, rx, bh, bw = tcs.band_rect(torch.as_tensor(wins), band, shape)
            for i, w in enumerate(wins):
                jry, jrx, jbh, jbw = jcs.band_rect(jnp.asarray(w), band, shape)
                assert (int(ry[i]), int(rx[i]), bh, bw) == \
                    (int(jry), int(jrx), jbh, jbw), (band, shape, w)
    for win in ((40, 40), (60, 100), (500, 500), (0, 1)):
        for shape in ((240, 320), (120, 160)):
            assert tcs.band_for(win, shape) == jcs.band_for(win, shape)
    for tok in ("auto", "none", "96x128", "128x192"):
        assert tcs.parse_band(tok) == jcs.parse_band(tok)
    with pytest.raises(ValueError, match="band"):
        tcs.parse_band("96by128")
    assert (tcs.DEFAULT_BAND, tcs.BAND_SLACK) == (jcs.DEFAULT_BAND,
                                                  jcs.BAND_SLACK)


def _diag_frame(rng, cx, cy, half_len, half_wid, flip=False):
    """A blob elongated along a diagonal: its cross moment keeps the angle
    far from the atan2 cancellation and the 0/pi wrap (ROADMAP F11)."""
    f = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
    v, u = np.mgrid[:H, :W]
    u, v = u - cx, (v - cy) * (-1 if flip else 1)
    inside = (np.abs(u - v) <= half_wid) & (np.abs(u + v) <= half_len)
    f[inside, 0] = 200 + rng.integers(0, 30, int(inside.sum()))
    f[inside, 1] = 80
    f[inside, 2] = 60
    return f


@pytest.mark.parametrize("band_hist", [False, True])
def test_track_band_parity_blob_clips(rng, band_hist):
    T = 16
    clips = np.stack([
        np.stack([_diag_frame(rng, 30 + t // 2, 25 + t // 3, 16, 4)
                  for t in range(T)]),
        np.stack([_diag_frame(rng, 65 - t // 2, 45 - t // 3, 16, 4, True)
                  for t in range(T)]),
        np.stack([_diag_frame(rng, 48, 36, 24, 6) for t in range(T)]),
    ], axis=1)                                            # (T, 3, H, W, 3)
    rects = np.array([[22, 17, 16, 16], [57, 37, 16, 16], [36, 24, 24, 24]],
                     np.int32)
    js, ts = _start(clips[0], rects)
    oracles = [CamshiftTracker(calc_angles=True) for _ in rects]
    for o, f, r in zip(oracles, clips[0], rects):
        o.init_tracker(f, tuple(int(v) for v in r))
    step = jax.jit(lambda s, f: jcs.track_band(
        s, f, True, band=BAND, kernel="pallas", band_hist=band_hist))
    n_esc = 0
    for t in range(1, T):
        got = tcs.track_band(ts, torch.as_tensor(clips[t]), True, band=BAND,
                             band_hist=band_hist)
        ref = [step(s, jnp.asarray(f)) for s, f in zip(js, clips[t])]
        esc = got[1].numpy()
        assert esc.tolist() == [bool(e) for _, e in ref], t
        n_esc += int(esc.sum())
        # an escaped stream's band result is invalid: both sides carry on
        # from their own (equal) full-frame recompute
        js = [jcs.track(s, jnp.asarray(f), True, kernel="pallas")[0] if e
              else r for s, f, (r, e) in zip(js, clips[t], ref)]
        full, _ = tcs.track(ts, torch.as_tensor(clips[t]), True)
        ts = tft._where(got[1], full, got[0])
        _check(js, ts, [o.track(f)["angle"] for o, f in zip(oracles, clips[t])])
    assert n_esc < 3 * (T - 1)  # most band ticks are served by the band


def test_band_too_small_escapes(rng):
    f0 = np.stack([_blob_frame(rng, 48, 36, 14, 18)] * 2)
    js, ts = _start(f0, np.array([[34, 18, 28, 36], [42, 30, 12, 12]],
                                 np.int32))
    small = (16, 16)
    new, esc = tcs.track_band(ts, torch.as_tensor(f0), True, band=small)
    ref = [jcs.track_band(s, jnp.asarray(f), True, band=small,
                          kernel="pallas") for s, f in zip(js, f0)]
    assert esc.tolist() == [bool(e) for _, e in ref]
    assert bool(esc[0])  # a 36-row window cannot stay in a 16-row band


def _band_bins(rgb, rects, band):
    bins = np.asarray(jax.vmap(jhg.rgb_bins)(jnp.asarray(rgb)))
    return np.stack([b[r[1]:r[1] + band[0], r[0]:r[0] + band[1]]
                     for b, r in zip(bins, rects)])


@pytest.mark.parametrize("shape,band", [((240, 320), (96, 128)),
                                        ((72, 96), (48, 64)),
                                        ((240, 320), (240, 320))])
def test_histpdf_band_twin_matches_pallas(rng, shape, band):
    """The pdf mode and the band backprojection take search windows and
    place each band by the reference's ``band_rect``; the pixels then equal
    the reference's Pallas kernels on that band's bins."""
    N = 3
    rgb = rng.integers(0, 256, (N,) + shape + (3,), np.uint8)
    rgb[0, : shape[0] // 2] = (120, 100, 90)  # a flat region: one hot bin
    model = rng.integers(0, 200, (N, 4096)).astype(np.float32)
    wins = np.stack([rng.integers(-20, shape[1] + 20, N),
                     rng.integers(-20, shape[0] + 20, N),
                     rng.integers(-5, 80, N), rng.integers(-5, 80, N)],
                    1).astype(np.int32)
    placed = [jcs.band_rect(jnp.asarray(w), band, shape) for w in wins]
    rects = np.array([[int(rx), int(ry), bw, bh] for ry, rx, bh, bw in placed],
                     np.int32)
    bb = jnp.asarray(_band_bins(rgb, rects, band))
    want_cur = np.asarray(jax.vmap(hist_pallas)(bb))
    want_w = jax.vmap(jhg.backprojection_weights)(jnp.asarray(model),
                                                  jnp.asarray(want_cur))
    want_pdf = np.asarray(jax.vmap(pdf_pallas)(bb, want_w))

    frames, tw = torch.as_tensor(rgb), torch.as_tensor(wins)
    cur, pdf = K.histpdf_band(frames, tw, torch.as_tensor(model), band)
    np.testing.assert_array_equal(cur.numpy(), want_cur)
    np.testing.assert_array_equal(pdf.numpy(), want_pdf)
    w = torch.as_tensor(np.array(want_w))
    np.testing.assert_array_equal(
        K.backproject(frames, w, tw, band).numpy(),
        np.asarray(jax.vmap(pdf_pallas)(bb, want_w)))
    # a window outside the frame places its band inside it
    off = tw.clone()
    off[:, 0] = shape[1] + 40
    off[:, 1] = -25
    _, pdf_off = K.histpdf_band(frames, off, torch.as_tensor(model), band)
    assert pdf_off.shape == (N,) + band


def test_histpdf_band_hist_only_matches_histogram_rect(rng):
    rgb = rng.integers(0, 256, (5, H, W, 3), np.uint8)
    rects = np.array([[5, 7, 12, 9], [-3, -2, 20, 10], [80, 40, 40, 40],
                      [0, 0, 0, 5], [0, 0, W, H]], np.int32)
    want = np.stack([np.asarray(jhg.histogram_rect(
        jhg.rgb_bins(jnp.asarray(f)), *map(int, r))) for f, r in zip(rgb, rects)])
    got = K.histpdf_band(torch.as_tensor(rgb), torch.as_tensor(rects))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_band_wrappers_check_inputs():
    frames = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    rects = thg.full_rects(2, (8, 8), "cpu")
    model = torch.zeros((2, 4096))
    before = dict(launches)
    K.histpdf_band(frames, rects)
    K.histpdf_band(frames, rects, model, (4, 4))
    K.backproject(frames, model, rects, (4, 4))
    assert launches == before  # the CPU twin is not a kernel launch
    with pytest.raises(ValueError):  # band larger than the frame
        K.histpdf_band(frames, rects, model, (9, 4))
    with pytest.raises(ValueError):
        K.backproject(frames, model, rects, (0, 4))
    with pytest.raises(ValueError):
        K.histpdf_band(frames, rects[:1])
    with pytest.raises(ValueError):
        K.histpdf_band(frames, rects, model[:, :10], (4, 4))


def test_handoff_band_audit_clean_and_dirty():
    def blob(extra=None):
        f = np.full((120, 160, 3), 40, np.uint8)
        f[38:62, 48:72] = (230, 80, 60)
        if extra is not None:
            y, x = extra
            f[y:y + 3, x:x + 3] = (230, 80, 60)  # model color, far away
        return f
    frames = np.stack([blob(), blob((5, 150)), blob()])
    rects = np.array([[50, 40, 20, 20], [50, 40, 20, 20], [44, 34, 32, 32]],
                     np.int32)  # inside the blob, same + a patch, with bg
    band = (64, 96)
    tf, tr = torch.as_tensor(frames), torch.as_tensor(rects)
    model = thg.histogram_rects(tf, tr)
    got = tcs.handoff_band_audit(thg.rgb_bins(tf), model, tr, band)
    want = [bool(jcs.handoff_band_audit(
        jhg.rgb_bins(jnp.asarray(f)), jnp.asarray(m.numpy()),
        jnp.asarray(r), band)) for f, m, r in zip(frames, model, rects)]
    assert got.tolist() == want == [False, True, True]
    st = tcs.init_tracker(tf, tr, audit_band=band)
    assert st.band_dirty.tolist() == want
    assert tcs.init_tracker(tf, tr).band_dirty is None


def test_wbtrack_step_matches_reference(rng):
    """One WB, one VJ (frozen), two CS streams through the banded
    "wbtrack" step on both sides."""
    Hs, Ws = 120, 160
    f = np.full((4, Hs, Ws, 3), 40, np.uint8)
    f[:, 38:62, 48:72] = (230, 80, 60)
    f[3] = np.roll(f[3], 30, axis=1)
    band = (64, 96)
    cfg = dict(bandHist=True, smoothing=True)
    js1 = jft.init_state(band_audit=True)
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (4,) + x.shape).copy(), js1)
    rect = jnp.asarray([46, 36, 28, 28], jnp.int32)
    hand = [jcs.init_tracker(jnp.asarray(f[i]), rect, audit_band=band)
            for i in (2, 3)]
    cs = jax.tree_util.tree_map(
        lambda b, x, y: b.at[2].set(x).at[3].set(y), jstate.cs, *hand)
    jstate = jstate._replace(cs=cs, mode=jnp.asarray([0, 1, 2, 2], jnp.int32))
    jstep = jax.jit(jax.vmap(jft.make_step(
        j_toy(), JConfig(histKernel="pallas", **cfg), (Hs, Ws), "wbtrack",
        band=band)))
    tstep = tft.make_step(toy_cascade(), TrackerConfig(**cfg), (Hs, Ws),
                          "wbtrack", band=band, device="cpu")
    tstate = convert.state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)],
        device="cpu")
    frames = torch.as_tensor(f)
    for _ in range(3):
        jstate, jout, jesc = jstep(jstate, jnp.asarray(f))
        tstate, tout, tesc = tstep(tstate, frames)
        assert tesc.tolist() == np.asarray(jesc).tolist()
        for name, a, b in zip(tft.StepOutput._fields, jout, tout):
            if name == "escaped":
                continue  # filled by the serving tick after its merge
            a, b = np.asarray(a), b.numpy()
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                           err_msg=name)
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    convert.state_to_numpy(tstate)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-4)
    assert tstate.mode.tolist()[1] == tft.MODE_VJ  # frozen


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedTracker(2, (40, 40), cascade=toy_cascade())
    leaves = convert.state_to_numpy(tft.init_state(2, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(leaves)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.init_state(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.make_step(toy_cascade(), TrackerConfig(), (40, 40), "track")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detector_tables(40, 40, toy_cascade())
    bt = BatchedTracker(2, (40, 40), cascade=toy_cascade(), device="cpu")
    assert bt.device.type == "cpu"


def test_serving_knobs_checked():
    with pytest.raises(ValueError, match="overload"):
        BatchedTracker(2, (40, 40), cascade=toy_cascade(), device="cpu",
                       overload="bogus")
    with pytest.raises(ValueError, match="band requires"):
        tft.make_step(toy_cascade(), TrackerConfig(), (120, 160), "full",
                      band=(64, 96), device="cpu")
    with pytest.raises(ValueError, match="bandHistAuditAction"):
        BatchedTracker(2, (120, 160), cascade=toy_cascade(), device="cpu",
                       band=(64, 96), bandHist=True,
                       bandHistAuditAction="bogus")
    bt = BatchedTracker(2, (240, 320), cascade=toy_cascade(), device="cpu",
                        bandHist=True)
    assert bt.band == tcs.DEFAULT_BAND and bt.state.cs.band_dirty is not None
    assert BatchedTracker(2, (120, 160), cascade=toy_cascade(),
                          device="cpu").band is None  # band covers the frame
    with pytest.raises(ValueError, match="band"):
        BatchedTracker(2, (120, 160), cascade=toy_cascade(), device="cpu",
                       band=None).band_hist_divergence(
            np.zeros((2, 120, 160, 3), np.uint8))
