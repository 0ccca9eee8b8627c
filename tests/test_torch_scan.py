"""``run_scan``: the port against the reference package's ``run_scan``
(histKernel="pallas", interpret mode on the CPU), split 13 + 13 as in the
reference's test_device_scheduler_matches_host_scheduler, band + bandHist
and full frame.

Six streams at 120x160 with the toy cascade and bucket 1 (chunk_cap 4).
Each stream's whitebalance settles at its own tick, so the 26 ticks take
wbtrack, full (more than four pending), chunk and bucket ticks, all-CS
ticks, and a loss with its relock; stream 3's face outgrows the band rows
(an escape every band tick).  Integer and bool fields exact, floats to
rtol 1e-5 / atol 1e-4 (f32 sums in another order).  Off the band, the
port's own host scheduler at sync_interval 1 equals its run_scan exactly."""

import numpy as np
import pytest
import torch

import jax

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import convert, toy_cascade
from headtrackr_tpu_torch.models import facetracker as tft

torch.set_num_threads(2)

H, W = 120, 160
N = 6
TICKS = 26
WOBBLE = [0, 2, 2, 4, 6, 6]    # the tick each stream's background settles
BLUE = (0, 23)                 # (stream, tick) of the loss frame
FACES = [(50, 45), (110, 50), (60, 70), (80, 60), (100, 80), (40, 60)]


def _frame(s, t):
    f = np.full((H, W, 3), 40 + (8 if t < WOBBLE[s] and t % 2 else 0),
                np.uint8)
    if (s, t) == BLUE:
        f[...] = (0, 0, 250)
        return f
    cx, cy = FACES[s]
    cx += t % 5
    half = 26 if s == 3 else 12
    f[cy - half:cy + half, cx - half:cx + half] = (230, 80, 60)
    return f


def _clip():
    return np.stack([np.stack([_frame(s, t) for s in range(N)])
                     for t in range(TICKS)])


def _assert_same(ref, got, where, exact=False):
    for name, a, b in zip(tft.StepOutput._fields, ref, got):
        a, b = np.asarray(a), b.numpy()
        a = np.broadcast_to(a, b.shape)
        if exact or a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{where} {name}")


@pytest.mark.parametrize("band", [(64, 96), None])
def test_run_scan_matches_reference(band):
    kw = dict(bucket=1, band=band, bandHist=band is not None)
    clip = _clip()
    jb = ht.BatchedTracker(N, (H, W), cascade=ht.toy_cascade(),
                           histKernel="pallas", **kw)
    tb = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(), device="cpu",
                           **kw)
    entry = []
    for k0, part in ((0, clip[:13]), (13, clip[13:])):
        ref = jb.run_scan(part)
        got = tb.run_scan(torch.as_tensor(part))
        assert got.mode_after.shape == (len(part), N)
        for k in range(len(part)):
            _assert_same([np.asarray(v)[k] for v in ref],
                         [v[k] for v in got], f"tick {k0 + k}")
        assert tb.modes.tolist() == jb.modes.tolist()
        entry += got.detection.tolist()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jb.state)]
    for a, b in zip(want, convert.state_to_numpy(tb.state)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    # the clip takes every branch of the device scheduler, and the loss
    # stream redetects and relocks
    assert {tb.branch(np.asarray(m)) for m in entry} == {
        "wbtrack", "full", "bucket", "track"}
    s, t = BLUE
    assert got.status[t - 13, s] & tft.STATUS_REDETECTING
    assert entry[-1] == [tft.MODE_CS] * N
    if band is None:
        # off the band the host scheduler at sync_interval 1 serves every
        # stream with the same per-stream math: equal to the bit
        hb = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(),
                               device="cpu", sync_interval=1, **kw)
        tb2 = pt.BatchedTracker(N, (H, W), cascade=toy_cascade(),
                                device="cpu", **kw)
        got = tb2.run_scan(clip)
        for k, f in enumerate(clip):
            _assert_same([v.numpy() for v in hb.step(f, sync=True)],
                         [v[k] for v in got], f"host tick {k}", exact=True)


def test_run_scan_needs_a_tick():
    tb = pt.BatchedTracker(2, (H, W), cascade=toy_cascade(), device="cpu")
    with pytest.raises(ValueError, match="at least one tick"):
        tb.run_scan(np.zeros((0, 2, H, W, 3), np.uint8))
    with pytest.raises(ValueError, match="frames must be"):
        tb.run_scan(np.zeros((3, 2, H, W), np.uint8))
    with pytest.raises(ValueError, match="at least one tick"):
        ht.BatchedTracker(2, (H, W), cascade=ht.toy_cascade()).run_scan(
            np.zeros((0, 2, H, W, 3), np.uint8))
