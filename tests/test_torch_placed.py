"""The band placed inside the band kernels, against the rects form and the
reference package.

The band kernels (``histpdf_band``'s pdf mode, ``backproject`` with a
band, ``mean_shift`` with a frame shape) take each stream's search window
and place its band themselves (``csrc/band.cuh`` ``place_band``); on the
CPU their twins place it with ``models/camshift.py`` ``band_rect``.  Here,
at windows that hit every clip of the placement (x or y below 0, past the
right or bottom edge, a band as wide as the frame, negative and odd sizes):

  * ``band_rect`` equals the reference's ``band_rect``;
  * each placed twin equals its rects / origins form at ``band_rect``'s
    placement, to the bit;
  * ``shift_band`` runs no PyTorch operation of the band: with the kernels
    stubbed, it dispatches none at all;
  * ``track_band`` through the placed entries equals the reference's
    jitted ``track_band`` (bandHist): windows, track boxes and escapes
    exact, the angle within F11's 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu_torch.kernels import histpdf as K
from headtrackr_tpu_torch.kernels import meanshift as kms
from headtrackr_tpu_torch.models import camshift as tcs
from headtrackr_tpu_torch.ops import histogram as thg
from headtrackr_tpu_torch.ops.meanshift import MOMENTS, mean_shift_plain

torch.set_num_threads(2)

H, W = 40, 56
BANDS = [(24, 32), (17, 23), (40, 56), (16, 56), (40, 8)]


def _windows(rng, n=24):
    """Search windows over the (H, W) frame at every clip of the
    placement, then random ones (sizes negative and odd among them)."""
    fixed = np.array([
        [-30, -25, 7, 9],           # x and y below 0
        [W + 9, H + 11, -3, -5],    # past both edges, negative odd sizes
        [W - 3, 4, 41, 17],         # past the right edge
        [5, H - 2, -7, 33],         # past the bottom edge
        [-1, -1, -1, -1],           # floor(-1 / 2) = -1
        [0, 0, W, H],               # the whole frame
        [W, H, 0, 0],               # the far corner
        [-W, -H, 2 * W + 1, 2 * H + 1],
        [13, 9, 5, 3]], np.int32)
    rand = np.stack([rng.integers(-40, W + 40, n), rng.integers(-40, H + 40, n),
                     rng.integers(-41, 90, n), rng.integers(-41, 90, n)],
                    1).astype(np.int32)
    return np.concatenate([fixed, rand])


def _frames(rng, n):
    f = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    f[::2, 8:30, 10:40] = (200, 80, 60)  # a hot bin on half the streams
    return f


@pytest.mark.parametrize("band", BANDS)
def test_band_rect_matches_reference_at_every_clip(rng, band):
    wins = _windows(rng)
    ry, rx, bh, bw = tcs.band_rect(torch.as_tensor(wins), band, (H, W))
    jry, jrx, jbh, jbw = jax.vmap(
        lambda w: jcs.band_rect(w, band, (H, W)),
        out_axes=(0, 0, None, None))(jnp.asarray(wins))
    np.testing.assert_array_equal(ry.numpy(), np.asarray(jry))
    np.testing.assert_array_equal(rx.numpy(), np.asarray(jrx))
    assert (bh, bw) == (jbh, jbw) == (min(band[0], H), min(band[1], W))
    # every band lies in the frame, x on the 8-pixel grid unless clipped
    assert ((ry >= 0) & (ry + bh <= H) & (rx >= 0) & (rx + bw <= W)).all()
    assert ((rx % 8 == 0) | (rx == W - bw)).all()


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("kernel", ["histpdf_band", "backproject",
                                    "meanshift"])
def test_placed_twin_equals_rects_form(rng, kernel, band):
    """The wrapper given windows (its CPU twin, placing by band_rect) is
    bit-equal to the twin's rects / origins form at band_rect's rects."""
    wins = torch.as_tensor(_windows(rng))
    n = wins.shape[0]
    frames = torch.as_tensor(_frames(rng, n))
    b = (min(band[0], H), min(band[1], W))
    ry, rx, _, _ = tcs.band_rect(wins, band, (H, W))
    rects = tcs.band_rects(ry, rx, *b)
    if kernel == "histpdf_band":
        model = torch.as_tensor(rng.integers(0, 200, (n, 4096))
                                .astype(np.float32))
        got = K.histpdf_band(frames, wins, model, b)
        want = thg.histpdf_band_plain(frames, rects, model, b)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    elif kernel == "backproject":
        weights = torch.as_tensor(rng.random((n, 4096), np.float32))
        assert torch.equal(K.backproject(frames, weights, wins, b),
                           thg.backproject_plain(frames, weights, rects, b))
    else:
        pdf = torch.as_tensor(rng.random((n,) + b, np.float32))
        pdf[pdf < 0.3] = 0
        pdf[1] = 0  # zero mass
        got = kms.mean_shift(pdf, wins, (H, W))
        want = mean_shift_plain(pdf, wins, ry, rx, (H, W))
        for i in (0, 2, 3):
            assert torch.equal(got[i], want[i]), i
        for k in MOMENTS:
            a, w = got[1][k], want[1][k]
            assert torch.equal(torch.isnan(a), torch.isnan(w)), k
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(w)), k


class _Ops(TorchDispatchMode):
    """Records the ATen operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("band_hist", [True, False])
def test_shift_band_runs_no_band_op(rng, monkeypatch, band_hist):
    """With its kernels and the full-frame histogram stubbed, shift_band
    dispatches no PyTorch operation: the band is placed inside the
    kernels, which get the state's windows as they are."""
    n = 4
    state = tcs.init_state(n, band_audit=True, device="cpu")
    state = state._replace(window=torch.as_tensor(_windows(rng)[:n]))
    frames = torch.as_tensor(_frames(rng, n))
    seen = {}
    pdf = torch.zeros((n, 24, 32))
    outs = (state.window, {k: torch.zeros(n) for k in MOMENTS},
            torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool))

    def fake(name, result):
        def call(*args):
            seen[name] = args
            return result
        return call

    monkeypatch.setattr(tcs, "histpdf_band", fake("histpdf_band",
                                                  (None, pdf)))
    monkeypatch.setattr(tcs, "backproject_ratio",
                        fake("backproject_ratio", pdf))
    monkeypatch.setattr(tcs, "histogram_full", fake("histogram_full", None))
    monkeypatch.setattr(tcs._ms, "mean_shift", fake("mean_shift", outs))
    with _Ops() as mode:
        got = tcs.shift_band(state, frames, (24, 32), band_hist=band_hist)
    assert mode.ops == []
    kernel = "histpdf_band" if band_hist else "backproject_ratio"
    assert seen[kernel][1 if band_hist else 3] is state.window
    assert seen[kernel][-1] == (24, 32)
    ms = seen["mean_shift"]
    assert ms[0] is pdf and ms[1] is state.window and ms[2] == (H, W)
    assert all(a is b for a, b in zip(got[:4], outs))


def test_track_band_placed_matches_reference_at_clips(rng):
    """track_band (bandHist) through the placed kernels' twins from windows
    at every clip equals the reference's track_band, one jitted and
    vmapped call: windows, track boxes and escapes exact, the angle within
    1e-5 (F11), NaN where the reference's is."""
    band = (24, 32)
    wins = _windows(rng, n=7)
    n = wins.shape[0]
    frames = _frames(rng, n)
    model = rng.integers(0, 30, (n, 4096)).astype(np.float32)
    model[:, 256 * 12 + 16 * 5 + 3] = 400  # (200, 80, 60)'s bin
    zi = np.zeros(n, np.int32)
    jstate = jcs.CamshiftState(
        model_hist=jnp.asarray(model), window=jnp.asarray(wins),
        track_x=jnp.asarray(zi), track_y=jnp.asarray(zi),
        track_w=jnp.asarray(zi), track_h=jnp.asarray(zi),
        track_angle=jnp.zeros(n, jnp.float32), model_bins=None,
        model_counts=None, model_overflow=None)
    step = jax.jit(jax.vmap(lambda s, f: jcs.track_band(
        s, f, True, band=band, kernel="pallas", band_hist=True)))
    jnew, jesc = step(jstate, jnp.asarray(frames))
    tstate = tcs.init_state(n, device="cpu")._replace(
        model_hist=torch.as_tensor(model), window=torch.as_tensor(wins))
    tnew, tesc = tcs.track_band(tstate, torch.as_tensor(frames), True,
                                band=band, band_hist=True)
    np.testing.assert_array_equal(tesc.numpy(), np.asarray(jesc))
    np.testing.assert_array_equal(tnew.window.numpy(),
                                  np.asarray(jnew.window))
    for k in ("track_x", "track_y", "track_w", "track_h"):
        np.testing.assert_array_equal(getattr(tnew, k).numpy(),
                                      np.asarray(getattr(jnew, k)), k)
    np.testing.assert_allclose(tnew.track_angle.numpy(),
                               np.asarray(jnew.track_angle), rtol=0,
                               atol=1e-5, equal_nan=True)
    assert tesc.any() and not tesc.all()
