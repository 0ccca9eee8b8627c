"""The schedulers' frozen streams: the port against the reference package
(histKernel="pallas", interpret mode on the CPU) on the same inputs.

  * the "track" step on a mixed WB/VJ/CS batch, banded and not: non-CS
    streams freeze (state kept, conf 0, no status, never escaped);
  * the host scheduler ``step`` at sync_interval 8 and 1 through a loss
    between syncs, which the stale mode view serves at the next sync;
  * ``step_auto(overload="rotate")`` with more than chunk_cap streams
    pending: the oldest served first (``pend_age``, ties to the lower
    index), the others frozen and aging; ``make_batched_steps``'s
    step_auto with the same knobs beside it, tick for tick.

Toy cascade, 120x160 frames, numpy-made clips.  Integer and bool fields
exact, floats to rtol 1e-5 / atol 1e-4 (f32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu.config import TrackerConfig as JConfig
from headtrackr_tpu.models import camshift as jcs
from headtrackr_tpu.models import facetracker as jft
from headtrackr_tpu_torch import TrackerConfig, convert, toy_cascade
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.runtime.serving import make_batched_steps

torch.set_num_threads(2)

H, W = 120, 160
BAND = (64, 96)
FACES = [(50, 45), (110, 50), (60, 70), (80, 60), (100, 80), (40, 60)]


def _frame(s, t, wobble=0, blue=False):
    """Stream s at tick t: a toy-cascade face drifting right; stream 3's
    face is taller than the band (it escapes every band tick).  Before tick
    ``wobble`` the background flickers, so whitebalance settles late."""
    f = np.full((H, W, 3), 40 + (8 if t < wobble and t % 2 else 0), np.uint8)
    if blue:
        f[...] = (0, 0, 250)
        return f
    cx, cy = FACES[s]
    cx += t % 5
    half = 26 if s == 3 else 12
    f[cy - half:cy + half, cx - half:cx + half] = (230, 80, 60)
    return f


def _assert_same(ref, got, where, fields=tft.StepOutput._fields):
    for name, a, b in zip(fields, ref, got):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        a = np.broadcast_to(a, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{where} {name}")


def _assert_states(jstate, tstate, where):
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    got = convert.state_to_numpy(tstate)
    assert len(ref) == len(got)
    _assert_same(ref, got, where, fields=[f"leaf {i}" for i in range(len(ref))])


@pytest.mark.parametrize("band", [None, BAND])
def test_track_step_freezes_non_cs_streams(band):
    """WB, VJ, CS, CS, VJ holding a lost tracker's camshift state: two
    "track" ticks on both sides, every state leaf and output.  The windows
    of streams 3 and 4 outgrow the band; only stream 3 (CS) escapes."""
    N = 5
    f = np.stack([_frame(s, 0) for s in range(N)])
    js1 = jft.init_state()
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N,) + x.shape).copy(), js1)
    hand = [jcs.init_tracker(jnp.asarray(f[s]), jnp.asarray(r, jnp.int32))
            for s, r in ((2, [48, 58, 24, 24]), (3, [50, 30, 60, 62]),
                         (4, [60, 40, 90, 70]))]
    cs = jax.tree_util.tree_map(
        lambda b, x, y, z: b.at[2].set(x).at[3].set(y).at[4].set(z),
        jstate.cs, *hand)
    jstate = jstate._replace(cs=cs, mode=jnp.asarray([0, 1, 2, 2, 1],
                                                     jnp.int32))
    cfg = dict(bandHist=band is not None, smoothing=True)
    jstep = jax.jit(jax.vmap(jft.make_step(
        ht.toy_cascade(), JConfig(histKernel="pallas", **cfg), (H, W),
        "track", band=band)))
    tstep = tft.make_step(toy_cascade(), TrackerConfig(**cfg), (H, W),
                          "track", band=band, device="cpu")
    tstate = convert.state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)],
        device="cpu")
    before = convert.state_to_numpy(tstate)
    for t in (1, 2):
        frames = np.stack([_frame(s, t) for s in range(N)])
        jres = jstep(jstate, jnp.asarray(frames))
        tres = tstep(tstate, torch.as_tensor(frames))
        jstate, jout, tstate, tout = jres[0], jres[1], tres[0], tres[1]
        _assert_same(jout, tout, f"tick {t}")
        _assert_states(jstate, tstate, f"tick {t}")
        if band is not None:
            np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
            assert tres[2][3] and not tres[2][[0, 1, 4]].any()
    # the non-CS streams kept their whole state and reported nothing
    for a, b in zip(before, convert.state_to_numpy(tstate)):
        np.testing.assert_array_equal(a[[0, 1, 4]], b[[0, 1, 4]])
    assert tout.status[[0, 1, 4]].tolist() == [0, 0, 0]
    assert tout.face_conf[[0, 1, 4]].tolist() == [0.0, 0.0, 0.0]
    assert tout.face_conf[[2, 3]].tolist() == [1.0, 1.0]


def _host_clip(ticks, blue):
    return np.stack([np.stack([_frame(s, t, wobble=(0, 3, 7, 5)[s],
                                      blue=(s, t) == blue)
                               for s in range(4)]) for t in range(ticks)])


@pytest.mark.parametrize("sync_interval", [8, 1])
def test_host_step_matches_reference(sync_interval):
    """``step(frames)`` on both sides: the cold start on stale full ticks,
    the locks, a loss at tick 26 that the interval-8 view sees only at its
    sync at tick 31 (the lost stream freezes on ticks 27-30), the bucket
    relock.  Band, bandHist and the big face's escapes on both: one
    configuration, so the second interval reuses the reference's compiled
    programs."""
    clip = _host_clip(38, blue=(1, 26))
    kw = dict(sync_interval=sync_interval, bucket=1, band=BAND, bandHist=True)
    jb = ht.BatchedTracker(4, (H, W), cascade=ht.toy_cascade(),
                           histKernel="pallas", **kw)
    tb = pt.BatchedTracker(4, (H, W), cascade=toy_cascade(), device="cpu",
                           **kw)
    frozen = 0
    for t, frames in enumerate(clip):
        jout = jb.step(frames)
        tout = tb.step(frames)
        _assert_same(jout, tout, f"tick {t}")
        # stream 1 on a track tick while VJ: frozen, conf 0
        frozen += int(tout.detection[1] == tft.MODE_VJ
                      and tout.face_conf[1] == 0)
    _assert_states(jb.state, tb.state, "end")
    assert tb.modes.tolist() == jb.modes.tolist() == [tft.MODE_CS] * 4
    assert tout.detection.tolist() == [tft.MODE_CS] * 4
    assert frozen == (4 if sync_interval == 8 else 0)


def test_host_step_after_reset_matches_reference():
    """``reset()`` mid-run at sync_interval 8 keeps the tick count, as the
    reference's does: the fresh cold start's mode view refreshes on the
    same ticks on both sides, so the switch back to "track" ticks (the band
    path) falls on the same tick.  Reset at tick 21, off the sync grid."""
    clip = _host_clip(52, blue=None)
    kw = dict(sync_interval=8, bucket=1, band=BAND, bandHist=True)
    jb = ht.BatchedTracker(4, (H, W), cascade=ht.toy_cascade(),
                           histKernel="pallas", **kw)
    tb = pt.BatchedTracker(4, (H, W), cascade=toy_cascade(), device="cpu",
                           **kw)
    for t, frames in enumerate(clip):
        if t == 21:
            jb.reset()
            tb.reset()
            assert tb.modes.tolist() == [tft.MODE_WB] * 4
        _assert_same(jb.step(frames), tb.step(frames), f"tick {t}")
        assert tb._tick == jb._tick == t + 1
    _assert_states(jb.state, tb.state, "end")
    assert tb.modes.tolist() == jb.modes.tolist() == [tft.MODE_CS] * 4


def _rotate_clip():
    """Six streams; streams 0-5 lose track at tick 17, streams 0-3 see blue
    again at tick 18 (their served redetect fails), so at tick 19 the
    pending streams carry ages 0, 0, 0, 0, 1, 1."""
    def blue(s, t):
        return t == 17 or (t == 18 and s < 4)
    return np.stack([np.stack([_frame(s, t, blue=blue(s, t))
                               for s in range(6)]) for t in range(24)])


def test_rotate_matches_reference():
    kw = dict(bucket=1, band=BAND, bandHist=True, overload="rotate")
    jb = ht.BatchedTracker(6, (H, W), cascade=ht.toy_cascade(),
                           histKernel="pallas", **kw)
    tb = pt.BatchedTracker(6, (H, W), cascade=toy_cascade(), device="cpu",
                           **kw)
    # the functional form of the same tick, tick for tick beside them
    step_auto = make_batched_steps(toy_cascade(), tb.config, (H, W),
                                   bucket=1, band=BAND, overload="rotate",
                                   device="cpu")[3]
    fstate = convert.state_from_numpy(convert.state_to_numpy(tb.state),
                                      device="cpu")
    ages, served = [], []
    for t, frames in enumerate(_rotate_clip()):
        assert tb.branch(tb.modes) != "full"
        entry = tb.modes
        jout = jb.step_auto(frames)
        tout = tb.step_auto(frames)
        fstate, fout = step_auto(fstate, frames)
        _assert_same(jout, tout, f"tick {t}")
        _assert_same(jout, fout, f"tick {t} make_batched_steps")
        age = tb.state.pend_age.numpy()
        np.testing.assert_array_equal(age, np.asarray(jb.state.pend_age))
        np.testing.assert_array_equal(fstate.pend_age.numpy(), age)
        ages.append(age.tolist())
        # a served pending stream reports its own branch's status bits
        served.append([s for s in range(6) if entry[s] != tft.MODE_CS
                       and (age[s] == 0)])
    _assert_states(jb.state, tb.state, "end")
    _assert_states(jb.state, fstate, "end (make_batched_steps)")
    # cold start: all six VJ at once, chunk_cap 4: streams 0-3 first
    first = next(t for t, a in enumerate(ages) if any(a))
    assert ages[first] == [0, 0, 0, 0, 1, 1]
    assert ages[first + 1] == [0] * 6
    # the mass loss: 0-3 served on blue (still pending), then the oldest
    assert ages[18] == [0, 0, 0, 0, 1, 1]
    assert served[19] == [0, 1, 4, 5] and ages[19] == [0, 0, 1, 1, 0, 0]
    assert served[20] == [2, 3] and ages[20] == [0] * 6
    assert tb.modes.tolist() == [tft.MODE_CS] * 6
