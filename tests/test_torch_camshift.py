"""The port's camshift (init_tracker + track, batched) against the reference
package's ``camshift.track(kernel="pallas")`` on the blob clips of
tests/test_camshift.py: windows, track_x/y/w/h and zero-mass loss exact.
Both sides start from the same state, carried across with convert.py.

Angle: within 1e-5 of the reference, or no farther from the f64 oracle than
the reference is, plus 1e-5.  The angle is atan2 of differences of f32
moments; on near-round blobs that cancellation leaves the reference itself
up to ~2e-4 from the oracle, so two f32 implementations that sum in
different orders cannot promise 1e-5 to each other there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu.oracle.camshift import CamshiftTracker
from headtrackr_tpu_torch import convert
from headtrackr_tpu_torch.kernels import meanshift as kms
from headtrackr_tpu_torch.models import camshift as tcs

torch.set_num_threads(2)

H, W = 60, 80


def _blob_frame(rng, cx, cy):
    f = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
    y0, y1 = max(0, cy - 8), min(H, cy + 8)
    x0, x1 = max(0, cx - 6), min(W, cx + 6)
    f[y0:y1, x0:x1, 0] = 200 + rng.integers(0, 30, (y1 - y0, x1 - x0))
    f[y0:y1, x0:x1, 1] = 80
    f[y0:y1, x0:x1, 2] = 60
    return f


def _start(frames0, rects):
    """Reference handoff states for each stream -> (jax states, the port's
    batched CamshiftState via convert.py)."""
    js = [jcs.init_tracker(jnp.asarray(f), jnp.asarray(r, jnp.int32))
          for f, r in zip(frames0, rects)]
    batch = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (len(js),) + x.shape), jft.init_state())
    batch = batch._replace(
        cs=jax.tree_util.tree_map(lambda *a: jnp.stack(a), *js))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(batch)]
    return js, convert.state_from_numpy(leaves, device="cpu").cs


def _check(js, ts, oracle_angles=None):
    for n, s in enumerate(js):
        assert ts.window[n].tolist() == np.asarray(s.window).tolist(), n
        for k in ("track_x", "track_y", "track_w", "track_h"):
            assert int(getattr(ts, k)[n]) == int(getattr(s, k)), (n, k)
        a, b = float(ts.track_angle[n]), float(s.track_angle)
        if np.isnan(b):
            assert np.isnan(a)
        elif abs(a - b) > 1e-5:
            o = oracle_angles[n]
            assert abs(a - o) <= abs(b - o) + 1e-5, (n, a, b, o)


def test_init_tracker_model_histogram(rng):
    frames = np.stack([_blob_frame(rng, 30, 25), _blob_frame(rng, 50, 30)])
    rects = np.array([[24, 17, 12, 16], [40, 20, 30, 50]], np.int32)
    js, ts = _start(frames, rects)
    got = tcs.init_tracker(torch.as_tensor(frames), torch.as_tensor(rects))
    np.testing.assert_array_equal(got.model_hist.numpy(), ts.model_hist.numpy())
    np.testing.assert_array_equal(got.window.numpy(), rects)


def test_track_parity_blob_clips(rng):
    T = 20
    clips = np.stack([
        np.stack([_blob_frame(rng, 30 + t, 25 + t // 2) for t in range(T)]),
        np.stack([_blob_frame(rng, 55 - t, 35 - t // 3) for t in range(T)]),
    ], axis=1)                                            # (T, 2, H, W, 3)
    rects = np.array([[24, 17, 12, 16], [49, 27, 12, 16]], np.int32)
    js, ts = _start(clips[0], rects)
    oracles = [CamshiftTracker(calc_angles=True) for _ in rects]
    for o, f, r in zip(oracles, clips[0], rects):
        o.init_tracker(f, tuple(int(v) for v in r))
    step = jax.jit(lambda s, f: jcs.track(s, f, True, kernel="pallas")[0])
    for t in range(1, T):
        js = [step(s, jnp.asarray(f)) for s, f in zip(js, clips[t])]
        ts, pdf = tcs.track(ts, torch.as_tensor(clips[t]), True)
        assert pdf.shape == (2, H, W)
        _check(js, ts, [o.track(f)["angle"] for o, f in zip(oracles, clips[t])])


def test_zero_mass_loss_and_calc_angles_off(rng):
    f0 = np.stack([_blob_frame(rng, 30, 25)] * 2)
    js, ts = _start(f0, np.array([[24, 17, 12, 16]] * 2, np.int32))
    blue = np.zeros((H, W, 3), np.uint8)
    blue[..., 2] = 250
    frames = np.stack([blue, _blob_frame(rng, 32, 26)])
    js = [jcs.track(s, jnp.asarray(f), False, kernel="pallas")[0]
          for s, f in zip(js, frames)]
    ts, _ = tcs.track(ts, torch.as_tensor(frames), False)
    _check(js, ts)
    assert int(ts.track_w[0]) == 0 and int(ts.track_h[0]) == 0
    assert float(ts.track_angle[1]) == float(np.float32(np.pi / 2))
    # with angles on, the zero-mass tick reports the JS NaN angle
    ts2, _ = tcs.track(tcs.init_tracker(torch.as_tensor(f0), ts.window),
                       torch.as_tensor(np.stack([blue, blue])), True)
    assert torch.isnan(ts2.track_angle).all()
    assert (ts2.track_w == 0).all() and (ts2.track_h == 0).all()


def test_take_along_twin_matches_take_along_axis(rng):
    """The take_along kernel's plain twin (the wrapper on CPU tensors)
    against jnp.take_along_axis, X8's kernel body: X8's own (8, 128) lane
    gather, and mean shift's line selections on 6-stream band and frame
    prefix-sum planes (broadcast indices)."""
    from headtrackr_tpu_torch.kernels.gather import take_along

    src = rng.random((8, 128), dtype=np.float32)
    idx = rng.integers(0, 128, (8, 128)).astype(np.int32)
    got = take_along(torch.as_tensor(src)[None], torch.as_tensor(idx)[None], 2)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(src), jnp.asarray(idx),
                                          axis=1))
    np.testing.assert_array_equal(got[0].numpy(), want)
    for s, l in ((65, 96), (121, 160)):
        plane = rng.random((6, s, l), dtype=np.float32)
        for dim, shape, hi in ((1, (6, 2, 1), s), (2, (6, s, 2), l),
                               (2, (6, 1, 2), l), (1, (6, 3, l), s)):
            idx = rng.integers(0, hi, shape).astype(np.int32)
            got = take_along(torch.as_tensor(plane), torch.as_tensor(idx), dim)
            want = np.asarray(jnp.take_along_axis(
                jnp.asarray(plane), jnp.asarray(idx), axis=dim))
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="idx"):
        take_along(torch.zeros((2, 4, 5)), torch.zeros((2, 3, 2),
                                                      dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="dim"):
        take_along(torch.zeros((2, 4, 5)), torch.zeros((2, 4, 1),
                                                      dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="src"):
        take_along(torch.zeros((2, 4, 5), dtype=torch.float64),
                   torch.zeros((2, 4, 1), dtype=torch.int32), 2)


@pytest.mark.parametrize("band", [None, (40, 56)])
def test_mean_shift_matches_reference_core(rng, band):
    """mean_shift (on CPU tensors, the meanshift kernel's twin) against
    the JAX package's _mean_shift_core on pdfs of quarter steps (every sum
    exact in f32, whatever the order): windows, escapes, zero mass and
    moments equal to the bit."""
    n = 6
    pdf = np.zeros((n, H, W), np.float32)
    for k in range(n):
        cy, cx = rng.integers(15, H - 15), rng.integers(15, W - 15)
        pdf[k, cy - 9:cy + 9, cx - 7:cx + 7] = rng.integers(
            0, 5, (18, 14)) / 4
    pdf[5] = 0  # a zero-mass stream
    win = np.stack([rng.integers(0, W - 20, n), rng.integers(0, H - 20, n),
                    rng.integers(8, 30, n), rng.integers(8, 30, n)],
                   1).astype(np.int32)
    if band is None:
        ry = rx = np.zeros(n, np.int32)
        part = pdf
    else:
        ry, rx, _, _ = tcs.band_rect(torch.as_tensor(win), band, (H, W))
        ry, rx = ry.numpy(), rx.numpy()
        part = np.stack([p[y:y + band[0], x:x + band[1]]
                         for p, y, x in zip(pdf, ry, rx)])
    core = jax.vmap(lambda p, w, y, x: jcs._mean_shift_core(
        p, w, True, y, x, H, W))
    jwin, jm, jzero, jesc = core(jnp.asarray(part), jnp.asarray(win),
                                 jnp.asarray(ry), jnp.asarray(rx))
    # the wrapper places the band from each window (band_rect's rule)
    offs = {} if band is None else dict(frame_shape=(H, W))
    twin, tm, tzero, tesc = kms.mean_shift(torch.as_tensor(part),
                                           torch.as_tensor(win), **offs)
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(tzero.numpy(), np.asarray(jzero))
    np.testing.assert_array_equal(tesc.numpy(), np.asarray(jesc))
    for k in ("m00", "m10", "m01", "m11", "m20", "m02"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), k)
    assert tzero[5] and not tzero[:5].all()
