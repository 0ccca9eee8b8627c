"""The band-local slice as a whole: the port's BatchedTracker(band=B,
bandHist=True, bucket=1) against the reference package's BatchedTracker
with the same knobs and histKernel="pallas" (interpret mode on the CPU),
``step_auto`` on every tick, under both bandHist audit actions.

Six streams at 120x160 with the toy cascade.  Each stream's whitebalance
settles at its own tick (a brightness wobble), so with bucket=1
(chunk_cap 4) the clip takes every branch of the reference scheduler: the
all-WB cold start and whitebalance beside trackers (wbtrack), a full tick
with one stream already tracking, chunk ticks (2-4 pending), bucket ticks
(1 pending: a late lock and a relock after a blue frame), and all-tracking
ticks.  Stream 3's face is larger than the band rows (it escapes every band
tick); stream 2 sits on a ring of its own background color, so its handoff
audits clean, while every toy-cascade handoff on the flat background audits
dirty (its rect carries background bins that also lie outside the band).

Every StepOutput field on every tick: integer and bool fields exact, float
fields to rtol 1e-5 / atol 1e-4 (f32 sums in another order).  Also the
convert.py round trip with the band_dirty leaf, stream_info,
band_hist_divergence and reset_stream."""

import numpy as np
import pytest
import torch

import jax

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch import convert
from headtrackr_tpu_torch.models import facetracker as tft

torch.set_num_threads(2)

H, W = 120, 160
BAND = (64, 96)
N = 6
TICKS = 36
WOBBLE = [0, 3, 7, 7, 12, 9]   # the tick each stream's brightness settles
BLUE = (0, 31)                 # (stream, tick) of the loss frame
FACES = [(50, 45), (110, 50), (60, 70), (80, 60), (100, 80), (40, 60)]


def _frame(s, t):
    cx, cy = FACES[s]
    cx += t % 5
    bg = 40 + (8 if t < WOBBLE[s] and t % 2 else 0)
    f = np.full((H, W, 3), bg, np.uint8)
    if (s, t) == BLUE:
        f[...] = (0, 0, 250)
        return f
    if s == 2:  # clean: no model color outside the band
        f[..., 2] = bg + 16
        f[cy - 24:cy + 24, cx - 24:cx + 24] = bg
    half = 26 if s == 3 else 12
    f[cy - half:cy + half, cx - half:cx + half] = (230, 80, 60)
    return f


def _clip():
    return np.stack([np.stack([_frame(s, t) for s in range(N)])
                     for t in range(TICKS)])


def _run(action):
    kw = dict(band=BAND, bandHist=True, bucket=1, bandHistAuditAction=action)
    jb = ht.BatchedTracker(N, (H, W), cascade=ht.toy_cascade(),
                           histKernel="pallas", **kw)
    tb = pt.BatchedTracker(N, (H, W), cascade=pt.toy_cascade(),
                           device="cpu", **kw)
    rows, branches = [], []
    for t, frames in enumerate(_clip()):
        branches.append(tb.branch(tb.modes))
        out_j = jb.step_auto(frames)
        out_t = tb.step_auto(frames)
        rows.append(([np.asarray(v) for v in out_j],
                     [v.numpy() for v in out_t]))
        if t == 24:
            mid = ([np.asarray(x) for x in jax.tree_util.tree_leaves(jb.state)],
                   convert.state_to_numpy(tb.state))
    return dict(rows=rows, branches=branches, mid=mid, jb=jb, tb=tb)


@pytest.fixture(scope="module", params=["flag", "escape"])
def run(request):
    return _run(request.param)


def _field(rows, name):
    i = tft.StepOutput._fields.index(name)
    return np.stack([r[1][i] for r in rows])


def _assert_outputs_equal(ref, got, where):
    for name, a, b in zip(tft.StepOutput._fields, ref, got):
        a = np.broadcast_to(a, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{where} {name}")


def test_step_outputs_match_reference_every_tick(run):
    for t, (ref, got) in enumerate(run["rows"]):
        _assert_outputs_equal(ref, got, f"tick {t}")


def test_replayed_relock_ticks_match_reference_every_tick(run):
    """The same clip through the tick's device form (the serving program,
    as the card runs it: its bodies uncaptured here on the program's
    buffers, chosen by the select kernels' twins) against the reference's
    step_auto."""
    tb = pt.BatchedTracker(N, (H, W), cascade=pt.toy_cascade(), device="cpu",
                           band=BAND, bandHist=True, bucket=1,
                           bandHistAuditAction=run["tb"].config
                           .bandHistAuditAction)
    tb._steps.scheduled = True
    for t, frames in enumerate(_clip()):
        got = [v.numpy() for v in tb.step_auto(frames)]
        _assert_outputs_equal(run["rows"][t][0], got, f"tick {t}")
    assert any(g is not None for g in tb._steps._graphs.values())
    assert {s for _, s in tb._steps._graphs} >= {0, 1, 2}


def test_clip_covers_every_branch_escape_and_audit(run):
    rows, br = run["rows"], run["branches"]
    det = _field(rows, "detection")
    pending = (det != tft.MODE_CS).sum(1)
    assert br[0] == "wbtrack" and (det[0] == tft.MODE_WB).all()
    full_cs = [t for t in range(TICKS) if br[t] == "full"
               and (det[t] == tft.MODE_CS).any()]
    assert full_cs, "no full tick with a stream already tracking"
    assert any(b == "wbtrack" and (det[t] == tft.MODE_CS).any()
               for t, b in enumerate(br))
    assert any(b == "bucket" and pending[t] == 1 for t, b in enumerate(br))
    assert any(b == "bucket" and pending[t] > 1 for t, b in enumerate(br))
    assert br[-1] == "track" and (det[-1] == tft.MODE_CS).all()
    # the loss frame: zero mass, redetect on the next tick, relock after
    s, t = BLUE
    assert _field(rows, "face_w")[t, s] == 0
    assert det[t + 1, s] == tft.MODE_VJ and det[t + 2, s] == tft.MODE_CS
    # escapes: the big face every band tick; the full tick reports none
    esc = _field(rows, "escaped")
    assert esc[-8:, 3].all()
    assert not esc[full_cs].any()
    dirty = run["tb"].state.cs.band_dirty.numpy()
    assert not dirty[2] and dirty[[0, 1, 3, 4, 5]].all()
    if run["tb"].config.bandHistAuditAction == "escape":
        assert esc[-1, [0, 1, 3, 4, 5]].all()   # dirty streams go full-frame
    else:
        assert not esc[-1, [0, 1, 4, 5]].any()  # the flag is telemetry only


def test_convert_round_trip_with_band_dirty(run):
    ref_leaves, port_leaves = run["mid"]
    assert len(ref_leaves) == convert.n_leaves(True) == len(port_leaves)
    assert len(ref_leaves) == convert.N_LEAVES + 1
    for a, b in zip(ref_leaves, port_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    state = convert.state_from_numpy(ref_leaves, device="cpu")
    assert state.cs.band_dirty.dtype == torch.bool
    for a, b in zip(ref_leaves, convert.state_to_numpy(state)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        convert.state_from_numpy(ref_leaves[:-2], device="cpu")


def test_stream_info_divergence_and_reset_match_reference(run):
    jb, tb = run["jb"], run["tb"]
    frames = _clip()[-1]
    for s in range(N):
        assert tb.stream_info(s) == jb.stream_info(s)
        got = tb.band_hist_divergence(frames, s)
        want = jb.band_hist_divergence(frames, s)
        assert got.pop("max_inflation") == pytest.approx(
            want.pop("max_inflation"), rel=1e-6, abs=1e-7)
        assert got == want
    # a new camera on stream 1: both trackers re-initialize it alone
    jb.reset_stream(1)
    tb.reset_stream(1)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jb.state)]
    for a, b in zip(want, convert.state_to_numpy(tb.state)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
    assert tb.modes.tolist() == [tft.MODE_CS, tft.MODE_WB] + [tft.MODE_CS] * 4
    _assert_outputs_equal([np.asarray(v) for v in jb.step_auto(frames)],
                          [v.numpy() for v in tb.step_auto(frames)], "reset")
