"""The session ``Tracker`` against the JAX package's, on the CPU.

The same seeded synthetic clip (a face-colored square that locks, moves,
vanishes behind a blue frame and is found again) goes through the JAX
``Tracker`` and the port's ``Tracker(device="cpu")``, both with
``debug=True``: the event sequences must be equal (types and statuses
exact; payload floats to rtol 1e-5 / atol 1e-4, f32 sums in another order;
the ``time`` field excluded), as must ``getTrackingObject``, ``getFOV``, the
debug backprojection bytes, ``stop()`` and a second ``init()``, and the
"hints" status under an injected clock.  The rest holds the port's session
to the reference's contract: the camera/altVideo fallback, fadeVideo, the
start/run_clip guards.
"""

import numpy as np
import pytest
import torch

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.runtime import tracker as ttr

torch.set_num_threads(2)

H, W = 120, 160
RTOL, ATOL = 1e-5, 1e-4


def _fr(rng, cx=None, cy=None, blue=False):
    if blue:
        f = np.zeros((H, W, 3), np.uint8)
        f[..., 2] = 250
        return f
    f = np.full((H, W, 3), 40, np.uint8)
    if cx is not None:
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    return f + rng.integers(0, 3, f.shape, dtype=np.uint8)


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    still = _fr(rng, 60, 50)
    return np.stack([still] * 16 + [_fr(rng, 60 + t, 50) for t in range(15)]
                    + [_fr(rng, blue=True)] * 2
                    + [_fr(rng, 80, 60) for _ in range(6)])


def _listen(bus, log):
    for ty in (ht.events.STATUS, ht.events.FACETRACKING,
               ht.events.HEADTRACKING):
        bus.add_event_listener(ty, lambda e, ty=ty: log.append(
            (ty, {k: v for k, v in vars(e).items()
                  if k not in ("type", "time")})))


def _same_events(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    for k, ((_, a), (_, b)) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), k
        for f in a:
            if isinstance(b[f], str):
                assert a[f] == b[f], (k, f)
            else:
                np.testing.assert_allclose(a[f], b[f], rtol=RTOL, atol=ATOL,
                                           err_msg=f"event {k} {f}")


def _same_tracking(a, b):
    assert a["detection"] == b["detection"]
    for f in ("x", "y", "width", "height", "angle", "confidence"):
        np.testing.assert_allclose(a[f], b[f], rtol=RTOL, atol=ATOL)


def _session(mod, **kw):
    bus = mod.events.EventBus()
    log = []
    _listen(bus, log)
    t = mod.Tracker(ui=False, bus=bus, cascade=mod.toy_cascade(), debug=True,
                    **kw)
    return t, log


@pytest.fixture(scope="module")
def runs():
    """Both trackers over the clip frame by frame, then stop() and a second
    init() on another clip: per package the event log, and per frame the
    tracking object, FOV and debug surface."""
    out = {}
    for name, mod, kw in (("jax", ht, {}), ("port", pt, {"device": "cpu"})):
        t, log = _session(mod, **kw)
        assert t.init(mod.ClipSource(_clip()), canvas=(W, H))
        frames = []
        while t.step_once() is not None:
            d = t.get_debug()
            frames.append((t.getTrackingObject(), t.getFOV(),
                           d["backprojection"], d["overlay"]))
        t.stop()
        stopped = (t.status, t.getFOV(), len(log))
        assert t.init(mod.ClipSource(_clip(seed=1)), canvas=(W, H))
        assert t.getTrackingObject() is None and t.getFOV() == 0.0
        n2 = t.run_clip()
        out[name] = dict(log=log, frames=frames, stopped=stopped, n2=n2,
                         last=(t.getTrackingObject(), t.getFOV()))
    return out


def test_events_equal_reference(runs):
    got, want = runs["port"]["log"], runs["jax"]["log"]
    _same_events(got, want)
    statuses = [e["status"] for t, e in got if t == ht.events.STATUS]
    dedup = [s for i, s in enumerate(statuses)
             if i == 0 or statuses[i - 1] != s]
    assert dedup[:5] == ["whitebalance", "detecting", "found", "redetecting",
                         "found"]
    assert sum(t == ht.events.FACETRACKING for t, _ in got) > 10
    assert sum(t == ht.events.HEADTRACKING for t, _ in got) > 5


def test_tracking_object_fov_and_debug_equal_reference(runs):
    got, want = runs["port"]["frames"], runs["jax"]["frames"]
    assert len(got) == len(want) == len(_clip())
    peaks = []
    for k, ((ta, fa, ba, oa), (tb, fb, bb, ob)) in enumerate(zip(got, want)):
        _same_tracking(ta, tb)
        np.testing.assert_allclose(fa, fb, rtol=RTOL, atol=ATOL)
        assert (ba is None) == (bb is None), k
        if ba is not None:  # the backprojection image, byte for byte
            assert ba.shape == (H, W, 3) and ba.dtype == np.uint8
            np.testing.assert_array_equal(ba, bb, err_msg=f"frame {k}")
            peaks.append(int(ba.max()))
        assert oa.shape == ob.shape == (H, W, 3)
    assert len(peaks) > 10 and peaks.count(255) > 10


def test_stop_and_reinit_equal_reference(runs):
    port, ref = runs["port"], runs["jax"]
    assert port["stopped"][0] == ref["stopped"][0] == "stopped"
    np.testing.assert_allclose(port["stopped"][1], ref["stopped"][1],
                               rtol=RTOL)  # getFOV: stop() keeps the last
    assert port["stopped"][2] == ref["stopped"][2]
    assert port["n2"] == ref["n2"] == len(_clip(1))
    _same_tracking(port["last"][0], ref["last"][0])
    np.testing.assert_allclose(port["last"][1], ref["last"][1], rtol=RTOL)


def test_hints_after_5s_of_vj_equal_reference(monkeypatch):
    """Both trackers stall in VJ on face-less frames under one injected
    clock (both read ``time.time``): 'hints' once after 5 s of VJ.  The
    frames are flat: on noise the toy cascade's candidates overflow the
    reference's capacity caps, which the port does not have (ROADMAP F7)."""
    clock = [1000.0]
    monkeypatch.setattr(ttr._time, "time", lambda: clock[0])
    blank = np.full((30, H, W, 3), 40, np.uint8)
    logs = {}
    for name, mod, kw in (("jax", ht, {}), ("port", pt, {"device": "cpu"})):
        t, log = _session(mod, **kw)
        assert t.init(mod.ClipSource(blank), canvas=(W, H))
        while t.step_once() is not None:
            clock[0] += 1.0
        logs[name] = log
    _same_events(logs["port"], logs["jax"])
    statuses = [e["status"] for _, e in logs["port"]]
    assert statuses.count("hints") == 1


@pytest.mark.parametrize("name", ["jax", "port"])
def test_run_clip_and_start_guards(name):
    """Both packages: one loop thread however often start() is called,
    run_clip() refused while it runs, fine once stop()ped."""
    mod, kw = (ht, {}) if name == "jax" else (pt, {"device": "cpu"})
    t, _ = _session(mod, detectionInterval=5, **kw)
    assert t.init(mod.ClipSource(_clip(), loop=True), canvas=(W, H))
    assert t.start()
    th = t._thread
    assert t.start() and t._thread is th  # one loop thread only
    try:
        with pytest.raises(RuntimeError, match=r"call stop\(\) first"):
            t.run_clip(max_frames=3)
    finally:
        t.stop()
    assert t.status == "stopped"
    th.join(timeout=120)
    assert not th.is_alive()
    assert t.run_clip(max_frames=2) == 2  # fine once stopped


def test_camera_fallback_and_fade(monkeypatch):
    def no_camera():
        raise RuntimeError("no camera")

    monkeypatch.setattr(ttr, "CameraSource", no_camera)
    t, log = _session(pt, device="cpu")
    assert t.init() is False  # no camera, no altVideo
    assert [e["status"] for _, e in log] == ["getUserMedia", "no camera"]

    faded = []

    class Fading(pt.ClipSource):
        def fade(self):
            faded.append(True)

    t, log = _session(pt, device="cpu", altVideo=Fading(_clip()),
                      fadeVideo=True)
    assert t.init()  # the altVideo clip takes the camera's place
    assert t.run_clip() == len(_clip())
    assert faded == [True]  # on the first CS lock only


def test_session_params_and_debug_flag():
    with pytest.raises(TypeError):
        pt.Tracker(nonsense=True, device="cpu")
    t = pt.Tracker(ui=False, bus=pt.events.EventBus(),
                   cascade=pt.toy_cascade(), device="cpu")
    t.init(pt.ClipSource(_clip()), canvas=(W, H))
    with pytest.raises(RuntimeError, match="debug=True"):
        t.get_debug()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Tracker()  # no card: the CPU is asked for by name


def test_clip_source_and_resize():
    c = pt.ClipSource(np.zeros((3, 10, 12, 3), np.uint8))
    assert (c.width, c.height) == (12, 10)
    assert c.read() is not None and c.read() is not None
    assert c.read() is not None and c.read() is None
    with pytest.raises(ValueError):
        pt.ClipSource(np.zeros((3, 10, 12), np.uint8))
    from headtrackr_tpu.runtime import video as jv
    from headtrackr_tpu_torch.runtime import video as tv
    assert tv.normalize_size(640, 480) == jv.normalize_size(640, 480)
    assert tv.normalize_size(480, 640) == jv.normalize_size(480, 640)
    f = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(tv.resize_rgb(f, 32, 24),
                                  jv.resize_rgb(f, 32, 24))
    src = pt.SyntheticFaceSource(width=W, height=H, size=24, n_frames=3)
    ref = ht.SyntheticFaceSource(width=W, height=H, size=24, n_frames=3)
    for _ in range(3):
        np.testing.assert_array_equal(src.read(), ref.read())
    assert src.read() is None
