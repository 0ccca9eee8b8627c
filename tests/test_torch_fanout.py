"""Per-stream fanout and ingest (runtime/fanout.py) against the JAX package's,
on the CPU.

The JAX and the port's ``BatchedSession`` over the same 4 clips (one loses
its face and finds it again) must deliver each stream's listeners the same
events (types and statuses exact, payload floats to rtol 1e-5 / atol 1e-4,
``time`` excluded).  The port's session must also equal a ``StreamFanout``
fed tick by tick from a second tracker's ``step(sync=True)`` outputs.  The
rest: ``IngestRing`` latest-wins and untorn, push mode, the lost-stream halt
with ``reset_stream``, per-stream hints, and the one-copy-per-dtype host
read.
"""

import threading

import numpy as np
import pytest
import torch

import headtrackr_tpu as ht
from headtrackr_tpu.runtime.fanout import BatchedSession as JaxSession
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.models import facetracker as tft
from headtrackr_tpu_torch.runtime import fanout as tfo
from headtrackr_tpu_torch.runtime.host import HostCopy

torch.set_num_threads(2)

H, W = 120, 160
RTOL, ATOL = 1e-5, 1e-4
TYPES = (ht.events.STATUS, ht.events.FACETRACKING, ht.events.HEADTRACKING)


def _fr(cx=None, cy=None, blue=False):
    if blue:
        f = np.zeros((H, W, 3), np.uint8)
        f[..., 2] = 250
        return f
    f = np.full((H, W, 3), 40, np.uint8)
    if cx is not None:
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    return f


def _clip(cx, cy, lose_at=None, n=34):
    frames = [_fr(cx, cy)] * 16 + [_fr(cx + t, cy) for t in range(n - 16)]
    if lose_at is not None:
        frames[lose_at:lose_at + 2] = [_fr(blue=True)] * 2
    return np.stack(frames)


CLIPS = [_clip(60, 50), _clip(70, 55, lose_at=24), _clip(50, 40),
         _clip(90, 70, lose_at=20)]


def _listen(fanout, i, log):
    for ty in TYPES:
        fanout.add_event_listener(i, ty, lambda e, ty=ty: log.append(
            (ty, {k: v for k, v in vars(e).items()
                  if k not in ("type", "time")})))


def _same_events(got, want, where):
    assert [t for t, _ in got] == [t for t, _ in want], where
    for k, ((_, a), (_, b)) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), (where, k)
        for f in a:
            if isinstance(b[f], str):
                assert a[f] == b[f], (where, k, f)
            else:
                np.testing.assert_allclose(a[f], b[f], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{where} event {k} {f}")


def _session_logs(make):
    sess = make()
    logs = [[] for _ in CLIPS]
    for i, log in enumerate(logs):
        _listen(sess.fanout, i, log)
    assert sess.run(sync=True) == len(CLIPS[0])
    return sess, logs


@pytest.fixture(scope="module")
def port_session():
    return _session_logs(lambda: pt.BatchedSession(
        len(CLIPS), sources=[c.copy() for c in CLIPS], frame_shape=(H, W),
        cascade=pt.toy_cascade(), ui=False, device="cpu"))


def test_batched_session_equals_reference(port_session):
    _, logs = port_session
    _, ref = _session_logs(lambda: JaxSession(
        len(CLIPS), sources=[c.copy() for c in CLIPS], frame_shape=(H, W),
        cascade=ht.toy_cascade(), ui=False))
    for i, (got, want) in enumerate(zip(logs, ref)):
        _same_events(got, want, f"stream {i}")
        assert all(e["stream"] == i for _, e in got)
    statuses = [[e["status"] for t, e in log if t == ht.events.STATUS]
                for log in logs]
    assert "redetecting" in statuses[1] and "redetecting" in statuses[3]
    assert "redetecting" not in statuses[0]


def test_batched_session_equals_fanout_of_step(port_session):
    """The pipelined session (tick t-1 emitted while tick t runs) against a
    StreamFanout fed right after each step(sync=True) of a second tracker."""
    sess, logs = port_session
    assert sess.fanout.status == ["tracking"] * len(CLIPS)
    bt = pt.BatchedTracker(len(CLIPS), (H, W), cascade=pt.toy_cascade(),
                           ui=False, device="cpu")
    fan = tfo.StreamFanout(len(CLIPS))
    ref = [[] for _ in CLIPS]
    for i, log in enumerate(ref):
        _listen(fan, i, log)
    for frames in np.stack(CLIPS, axis=1):
        fan.emit(bt.step(frames, sync=True))
    for i, (got, want) in enumerate(zip(logs, ref)):
        _same_events(got, want, f"stream {i}")


def test_ingest_ring_latest_wins_and_torn_free():
    ring = tfo.IngestRing(3, frame_shape=(8, 8))
    f1 = np.full((8, 8, 3), 1, np.uint8)
    f2 = np.full((8, 8, 3), 2, np.uint8)
    ring.put(0, f1)
    ring.put(0, f2)           # overwrites: latest wins
    ring.put(2, f1)
    snap = ring.snapshot()
    assert (snap[0] == 2).all()
    assert (snap[1] == 0).all()  # never written: zeros
    assert (snap[2] == 1).all()
    assert ring.seq().tolist() == [2, 0, 1]
    stop = threading.Event()

    def writer():
        k = 0
        while not stop.is_set():
            ring.put(1, np.full((8, 8, 3), k % 251, np.uint8))
            k += 1

    th = threading.Thread(target=writer)
    th.start()
    try:
        for _ in range(200):
            row = ring.snapshot()[1]
            assert (row == row.flat[0]).all()  # one frame, never torn
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive()


def test_push_mode_ring_session():
    clip = _clip(60, 50)
    ring = tfo.IngestRing(2, frame_shape=(H, W))
    sess = pt.BatchedSession(2, ring=ring, frame_shape=(H, W),
                             cascade=pt.toy_cascade(), ui=False, device="cpu")
    log = []
    _listen(sess.fanout, 0, log)
    for f in clip:
        ring.put(0, f)
        ring.put(1, f)
        sess.step_once(sync=True)
    sess.flush()
    assert sess.fanout.status[0] == "tracking"
    statuses = [e["status"] for t, e in log if t == ht.events.STATUS]
    dedup = [s for i, s in enumerate(statuses)
             if i == 0 or statuses[i - 1] != s]
    assert dedup[:3] == ["whitebalance", "detecting", "found"]
    with pytest.raises(ValueError):
        pt.BatchedSession(2, sources=[clip], device="cpu")
    with pytest.raises(ValueError):
        tfo.StreamFanout(3, buses=[pt.events.EventBus()])


def _fake_out(n, status=0, det=2, face=False):
    z = np.zeros((n,), np.float32)
    return tft.StepOutput(
        detection=np.full((n,), det, np.int32), wb=z,
        face_x=z + 5, face_y=z + 6, face_w=z + 7, face_h=z + 8,
        face_angle=z, face_conf=z + 1,
        smooth_x=z, smooth_y=z, smooth_w=z, smooth_h=z,
        head_valid=np.zeros((n,), bool), head_x=z, head_y=z, head_z=z,
        status=np.full((n,), status, np.int32),
        event_face=np.full((n,), face, bool), fov_deg=z,
        mode_after=np.full((n,), det, np.int32),
        escaped=np.zeros((n,), bool))


def test_lost_stream_halts_until_reset():
    f = tfo.StreamFanout(2)
    log = []
    _listen(f, 0, log)
    f.emit(_fake_out(2, status=tft.STATUS_LOST, face=True))
    assert [e["status"] for _, e in log] == ["lost"]
    assert f.stopped == [True, True]
    before = len(log)
    assert f.emit(_fake_out(2, status=tft.STATUS_LOST, face=True)) == 0
    assert len(log) == before  # halted: silent
    f.reset_stream(0)
    assert f.emit(_fake_out(2, face=True)) == 1  # stream 0 only
    assert log[-1][0] == ht.events.FACETRACKING and log[-1][1]["x"] == 5.0


def test_per_stream_hints(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(tfo._time, "time", lambda: clock[0])
    f = tfo.StreamFanout(2)
    logs = [[], []]
    for i in (0, 1):
        f.add_event_listener(i, pt.events.STATUS,
                             lambda e, i=i: logs[i].append(e.status))
    f.emit(_fake_out(2, det=1))          # both enter VJ: timers start
    clock[0] += 6.0
    out = _fake_out(2, det=1)._replace(
        detection=np.array([1, 2], np.int32))
    f.emit(out)                          # stream 0 still VJ, 1 locked
    assert logs[0] == ["hints"] and f.status[0] == "hints"
    assert logs[1] == [] and f.status[1] == "tracking"
    f.emit(out)
    assert logs[0] == ["hints"]          # once


def test_host_copy_one_copy_per_dtype():
    a = torch.arange(6, dtype=torch.float32).view(2, 3)
    b = torch.tensor([True, False])
    c = torch.tensor([7, 8], dtype=torch.int32)
    d = torch.ones(4)
    host = HostCopy([a, b, c, d, np.array([1.5])])
    assert set(host._host) == {torch.float32, torch.bool, torch.int32}
    got = host.arrays()
    np.testing.assert_array_equal(got[0], a.numpy())
    assert got[1].dtype == bool and got[1].tolist() == [True, False]
    assert got[2].dtype == np.int32 and got[2].tolist() == [7, 8]
    np.testing.assert_array_equal(got[3], np.ones(4, np.float32))
    assert got[4].tolist() == [1.5]
    a.add_(1)  # the copy does not alias its source
    np.testing.assert_array_equal(got[0], np.arange(6.0).reshape(2, 3))
