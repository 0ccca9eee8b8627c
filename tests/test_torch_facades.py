"""The reference-parity namespace of the port against the JAX package's, on
the CPU (``device="cpu"``: the kernels' plain twins), at the small frame
size and toy cascade of tests/test_runtime.py.

Tolerances, each with its reason:
  - integers exact: grayscale, detection neighbors, camshift windows and
    boxes, the histogram, the backprojection image bytes, event types;
  - detection boxes rtol 1e-6 and confidences atol 1e-5 (f32 group sums in
    another order, as tests/test_torch_detector.py);
  - the camshift angle by ROADMAP F11: within 1e-5 of the reference, or no
    farther from the f64 oracle than the reference is, plus 1e-5;
  - tracking results, events, head position, FOV and the smoother: rtol
    1e-5 / atol 1e-4 (f32 in both packages; sums in another order, and
    XLA:CPU may contract a multiply-add that PyTorch rounds twice).
"""

import os
import pkgutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import headtrackr_tpu as ht
import headtrackr_tpu_torch as pt
from headtrackr_tpu.models import detector as jd
from headtrackr_tpu.oracle.camshift import CamshiftTracker

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 120, 160
RTOL, ATOL = 1e-5, 1e-4
CPU = {"device": "cpu"}


def _fr(cx=None, cy=None, blue=False, noise=None):
    if blue:
        f = np.zeros((H, W, 3), np.uint8)
        f[..., 2] = 250
        return f
    f = np.full((H, W, 3), 40, np.uint8)
    if cx is not None:
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    if noise is not None:
        f = f + noise.integers(0, 3, f.shape, dtype=np.uint8)
    return f


def _clip():
    """tests/test_runtime.py's clip, first 24 frames: WB x 15 -> VJ -> CS
    on a square that stands, then moves."""
    rng = np.random.default_rng(3)
    return np.stack([_fr(60, 50, noise=rng)] * 16
                    + [_fr(60 + t, 50, noise=rng) for t in range(8)])


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


def _jitted(fn):
    """``fn(gray, cascade, interval, *rest)`` of the reference detector,
    jitted once per (cascade object, interval, rest): the reference's ccv
    calls it op by op, which takes minutes on the CPU."""
    cache = {}

    def call(gray, cascade, interval=5, *rest):
        key = (id(cascade), interval, rest)
        if key not in cache:
            cache[key] = (cascade, jax.jit(
                lambda g: fn(g, cascade, interval, *rest)))
        return cache[key][1](gray)
    return call


@pytest.fixture(scope="module")
def jit_detector():
    """The reference's ccv with its detector calls jitted (same functions,
    same arguments)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ht.ccv, "detect_candidates", _jitted(jd.detect_candidates))
        mp.setattr(ht.ccv, "detect_objects_padded",
                   _jitted(jd.detect_objects_padded))
        yield ht.ccv


# -- ccv ---------------------------------------------------------------------

def test_grayscale_bit_exact():
    rgb = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
    got = pt.ccv.grayscale(rgb, **CPU)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ht.ccv.grayscale(rgb)))


def _boxes(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


@pytest.mark.parametrize("min_neighbors", [0, 1, 2])
def test_detect_objects_equals_reference(jit_detector, min_neighbors):
    """Both branches: min_neighbors 0 (raw candidates, the ``neighbor``
    key) and grouped; sorted lists.  One square: its 215 raw candidates fit
    the reference's 256 slots, so JAX's capacity overflow is 0 (F7)."""
    f = _fr(60, 50)
    gray = np.asarray(ht.ccv.grayscale(f))
    cas = ht.toy_cascade()
    over = (jit_detector.detect_candidates(jnp.asarray(gray), cas, 5)
            if min_neighbors == 0 else jit_detector.detect_objects_padded(
                jnp.asarray(gray), cas, 5, min_neighbors))["overflow"]
    assert int(over) == 0
    want = jit_detector.detect_objects(gray, cas, 5, min_neighbors)
    got = pt.ccv.detect_objects(gray, pt.toy_cascade(), 5, min_neighbors,
                                **CPU)
    assert len(got) == len(want) > 0
    key = "neighbor" if min_neighbors == 0 else "neighbors"
    assert all(set(r) == {"x", "y", "width", "height", key, "confidence"}
               for r in got + want)
    order = lambda rows: sorted(rows, key=lambda r: (r["x"], r["y"],  # noqa: E731
                                                     r["width"]))
    for a, b in zip(order(got), order(want)):
        assert a[key] == b[key] and isinstance(a[key], int)
        for k in ("x", "y", "width", "height"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        np.testing.assert_allclose(a["confidence"], b["confidence"], atol=1e-5)
    # an RGB image is grayscaled first; the tables are built once
    n = len(pt.ccv._TABLES)
    assert _boxes(pt.ccv.detect_objects(f, pt.toy_cascade(), 5,
                                        min_neighbors, **CPU)) == _boxes(got)
    assert len(pt.ccv._TABLES) == n


# -- camshift ------------------------------------------------------------------

def _blob(rng, cx, cy):
    f = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
    f[cy - 10:cy + 10, cx - 8:cx + 8, 0] = 200 + rng.integers(0, 30, (20, 16))
    f[cy - 10:cy + 10, cx - 8:cx + 8, 1] = 80
    f[cy - 10:cy + 10, cx - 8:cx + 8, 2] = 60
    return f


@pytest.mark.parametrize("calc_angles", [True, False])
def test_camshift_tracker_equals_reference(calc_angles):
    rng = np.random.default_rng(8)
    clip = [_blob(rng, 50 + 2 * t, 40 + t) for t in range(10)]
    clip.append(np.zeros((H, W, 3), np.uint8))  # zero mass: the box collapses
    rect = (42, 30, 16, 20)
    j = ht.camshift.Tracker({"calcAngles": calc_angles})
    p = pt.camshift.Tracker({"calcAngles": calc_angles}, **CPU)
    o = CamshiftTracker(calc_angles=calc_angles)
    j.initTracker(clip[0], rect)
    p.initTracker(clip[0], pt.camshift.Rectangle(*rect))
    o.init_tracker(clip[0], rect)
    assert vars(p.getSearchWindow()) == vars(j.getSearchWindow())
    for k, f in enumerate(clip[1:]):
        a, b = p.track(f), j.track(f)
        oa = o.track(f)["angle"]
        for field in ("x", "y", "width", "height"):
            assert getattr(a, field) == getattr(b, field), (k, field)
            assert type(getattr(a, field)) is int
        if np.isnan(b.angle):
            assert np.isnan(a.angle)
        elif abs(a.angle - b.angle) > 1e-5:
            assert abs(a.angle - oa) <= abs(b.angle - oa) + 1e-5, k
        assert vars(p.getSearchWindow()) == vars(j.getSearchWindow()), k
        np.testing.assert_array_equal(p.getBackProjectionImg(),
                                      j.getBackProjectionImg())
    assert p.getTrackObj().width == 0  # the zero-mass frame
    # a 0-size frame returns the last result unchanged (src/camshift.js:219)
    last = p.getTrackObj()
    again = p.track(np.zeros((0, 0, 3), np.uint8))
    assert (again.x, again.y, again.width, again.height) == \
        (last.x, last.y, last.width, last.height)
    assert np.isnan(again.angle) == np.isnan(last.angle)


def test_histogram_equals_reference():
    rng = np.random.default_rng(9)
    for img in (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                _fr(60, 50), np.zeros((7, 5, 3), np.uint8)):
        got = pt.camshift.Histogram(img, **CPU)
        assert got.dtype == np.float32 and got.shape == (4096,)
        np.testing.assert_array_equal(got, ht.camshift.Histogram(img))


# -- facetrackr ----------------------------------------------------------------

def _facetrack(mod, clip, **kw):
    bus = mod.events.EventBus()
    log = []
    bus.add_event_listener(mod.events.FACETRACKING,
                           lambda e: log.append(dict(vars(e))))
    t = mod.facetrackr.Tracker(cascade=mod.toy_cascade(), bus=bus, **kw)
    t.init(mod.ClipSource(clip))
    res = [vars(t.track()) for _ in range(len(clip) + 1)]  # + exhausted
    return res, log, vars(t.getTrackingObject()), t.getBackProjectionImg()


def test_facetrackr_equals_reference(jit_detector, monkeypatch):
    """Result for result and event for event over 24 frames, ``time``
    pinned by one clock both packages read."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    clip = _clip()
    want = _facetrack(ht, clip)
    got = _facetrack(pt, clip, **CPU)
    (ra, la, ta, ba), (rb, lb, tb, bb) = got, want
    assert [r["detection"] for r in ra] == [r["detection"] for r in rb]
    assert [r["detection"] for r in ra][:16] == ["WB"] * 15 + ["VJ"]
    assert ra[-1]["detection"] == "CS"
    for k, (a, b) in enumerate(zip(ra + [ta], rb + [tb])):
        assert a.keys() == b.keys()
        for f in a:
            if isinstance(b[f], str):
                assert a[f] == b[f]
            else:
                _close(a[f], b[f], f"result {k} {f}")
    assert len(la) == len(lb) == 8
    for a, b in zip(la, lb):
        assert a.keys() == b.keys() and a["type"] == b["type"]
        for f in a:
            if f not in ("type", "detection"):
                _close(a[f], b[f], f)
    np.testing.assert_array_equal(ba, bb)


def test_facetrackr_explicit_frames_and_params(jit_detector):
    for mod, kw in ((ht, {}), (pt, CPU)):
        with pytest.raises(TypeError, match="unknown facetrackr params"):
            mod.facetrackr.Tracker(nonsense=True, **kw)
    res = {}
    for name, mod, kw in (("jax", ht, {}), ("port", pt, CPU)):
        t = mod.facetrackr.Tracker({"sendEvents": False,
                                    "whitebalancing": False},
                                   cascade=mod.toy_cascade(), **kw)
        t.init()
        res[name] = [t.track(_fr(60, 50)), t.track(_fr(62, 51))]
    for a, b in zip(res["port"], res["jax"]):
        assert a.detection == b.detection
        for f in ("x", "y", "width", "height", "confidence"):
            _close(getattr(a, f), getattr(b, f), f)
    assert [r.detection for r in res["port"]] == ["VJ", "CS"]


# -- headposition, Smoother, getWhitebalance -----------------------------------

FACES = [dict(x=80, y=60, width=40, height=48),     # center
         dict(x=25, y=60, width=40, height=48),     # left edge
         dict(x=80, y=112, width=40, height=48),    # bottom edge
         dict(x=8, y=6, width=40, height=48),       # corner
         dict(x=150, y=20, width=30, height=36)]    # right-top corner


@pytest.mark.parametrize("params", [
    None, {"fov": 60}, {"edgecorrection": False, "distance_to_screen": 45},
    {"distance_from_camera_to_screen": 5.0}])
def test_headposition_equals_reference(params):
    got_events = []
    listener = pt.events.add_event_listener(pt.events.HEADTRACKING,
                                            got_events.append)
    try:
        j = ht.headposition.Tracker(FACES[0], W, H, params)
        p = pt.headposition.Tracker(FACES[0], W, H, params, **CPU)
        _close(p.getFOV(), j.getFOV(), "fov")
        for f in FACES + FACES[::-1]:
            a, b = p.track(f), j.track(f)
            for k in "xyz":
                np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                           rtol=1e-4, atol=1e-4)
            assert vars(p.getTrackerObj()) == vars(a)
    finally:
        pt.events.remove_event_listener(pt.events.HEADTRACKING, listener)
    assert len(got_events) == 2 * len(FACES)
    assert all(np.isfinite([e.x, e.y, e.z]).all() for e in got_events)
    quiet = pt.headposition.Tracker(FACES[0], W, H, params,
                                    send_events=False, **CPU)
    quiet.track(FACES[1])
    assert len(got_events) == 2 * len(FACES)


@pytest.mark.parametrize("mode", ["ema", "desp"])
def test_smoother_equals_reference(mode):
    rng = np.random.default_rng(10)
    j = ht.Smoother(0.35, 35, mode=mode)
    p = pt.Smoother(0.35, 35, mode=mode, **CPU)
    assert p.smooth({"x": 1}) is False and p.predict(10) is False
    start = dict(x=80.0, y=60.0, width=40.0, height=48.0)
    j.init(start)
    p.init(pt.camshift.TrackObj(80, 60, 40, 48))  # an object works too
    for k in range(12):
        pos = {"x": float(80 + rng.normal(0, 5)), "y": float(60 + k),
               "width": 40.0 + k, "height": 48.0, "z": 3.0, "extra": k}
        a, b = p.smooth(pos), j.smooth(pos)
        assert a.keys() == b.keys() and a["extra"] == k
        for f in ("x", "y", "z", "width", "height"):
            _close(a[f], b[f], f"{mode} step {k} {f}")
        for t in (0, 34, 35, 100):
            pa, pb = p.predict(t), j.predict(t)
            for f in pb:
                _close(pa[f], pb[f], f"{mode} predict({t}) {f}")


def test_get_whitebalance_equals_reference():
    rng = np.random.default_rng(11)
    for img in (rng.integers(0, 256, (H, W, 3), dtype=np.uint8), _fr(60, 50)):
        got = pt.getWhitebalance(img, **CPU)
        assert isinstance(got, float)
        _close(got, ht.getWhitebalance(img), "wb")
        # a tensor stays on its own device: no device= needed
        _close(pt.getWhitebalance(torch.as_tensor(img)), got, "wb tensor")


# -- controllers -------------------------------------------------------------

HEADS = [dict(x=3.0, y=-2.0, z=60.0), dict(x=-4.5, y=6.0, z=45.0),
         dict(x=0.0, y=0.0, z=80.0)]


def test_controllers_equal_reference():
    for h in HEADS:
        a = pt.controllers.realistic_absolute_camera_pose(
            h, 2.0, (0, 0, 100), 16 / 9, damping=0.5)
        b = ht.controllers.realistic_absolute_camera_pose(
            h, 2.0, (0, 0, 100), 16 / 9, damping=0.5)
        assert vars(a) == vars(b)
        assert (pt.controllers.realistic_relative_camera_offset(
            h, 2.0, 30.0, 4 / 3) == ht.controllers.realistic_relative_camera_offset(
            h, 2.0, 30.0, 4 / 3))

    class Camera:
        aspect = 4 / 3

        def __init__(self):
            self.poses, self.rel = [], []

        def apply(self, pose):
            self.poses.append(pose)

        def apply_relative(self, *a):
            self.rel.append(a)

    got = {}
    for name, mod in (("jax", ht), ("port", pt)):
        bus = mod.events.EventBus()
        cam = Camera()
        ctl = mod.controllers.three.realisticAbsoluteCameraControl(
            cam, 2.0, (0, 0, 100), params={"damping": 0.5}, bus=bus)
        rel = mod.controllers.RealisticRelativeCameraControl(cam, 2.0, 30.0,
                                                             bus=bus)
        for h in HEADS:
            bus.dispatch_event(mod.events.HEADTRACKING, h)
        ctl.close()
        rel.close()
        bus.dispatch_event(mod.events.HEADTRACKING, HEADS[0])  # unheard
        got[name] = ([vars(p) for p in cam.poses], cam.rel,
                     vars(ctl.last_pose), rel.last)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == len(HEADS)


# -- profiling ---------------------------------------------------------------

def test_stage_timer_and_trace(tmp_path):
    from headtrackr_tpu_torch.utils import StageTimer, trace
    t = StageTimer()
    for _ in range(2):
        with t.stage("hist"):
            out = pt.camshift.Histogram(_fr(60, 50), **CPU)
            t.sync({"h": [torch.as_tensor(out)], "n": None})
    assert t.counts == {"hist": 2} and "hist" in t.report()
    path = tmp_path / "trace.json"
    with trace(path) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None and path.stat().st_size > 0
    assert "traceEvents" in path.read_text()


# -- the namespace -------------------------------------------------------------

def test_namespace_equals_reference():
    want = set(ht.__all__) | {"checkpoint"}
    assert set(pt.__all__) == want and len(pt.__all__) == len(want)
    for name in pt.__all__:
        assert hasattr(pt, name), name
    assert pt.rev == ht.rev == 2
    assert pt.cascade().count == ht.cascade().count
    assert set(pt.runtime.__all__) == set(ht.runtime.__all__)
    from headtrackr_tpu_torch import ops, utils
    assert set(ops.__all__) == set(ht.ops.__all__)
    assert set(utils.__all__) == set(ht.utils.__all__)
    from headtrackr_tpu.runtime import netingest as jn
    from headtrackr_tpu_torch.runtime import netingest as tn
    assert tn.__all__ == jn.__all__


FACADES = {
    "camshift.Tracker": lambda: pt.camshift.Tracker(),
    "camshift.Histogram": lambda: pt.camshift.Histogram(_fr()),
    "facetrackr.Tracker": lambda: pt.facetrackr.Tracker(),
    "headposition.Tracker": lambda: pt.headposition.Tracker(FACES[0], W, H),
    "Smoother": lambda: pt.Smoother(),
    "getWhitebalance": lambda: pt.getWhitebalance(_fr()),
    "ccv.grayscale": lambda: pt.ccv.grayscale(_fr()),
    "ccv.detect_objects": lambda: pt.ccv.detect_objects(
        np.full((H, W), 40, np.uint8), pt.toy_cascade()),
}


@pytest.mark.parametrize("name", sorted(FACADES))
def test_facade_without_device_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FACADES[name]()


def test_no_port_module_imports_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither jax nor the JAX package."""
    import headtrackr_tpu_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        headtrackr_tpu_torch.__path__, "headtrackr_tpu_torch."))
    assert {"headtrackr_tpu_torch.ccv", "headtrackr_tpu_torch.facetrackr",
            "headtrackr_tpu_torch.kernels.histbins",
            "headtrackr_tpu_torch.runtime.netingest",
            "headtrackr_tpu_torch.utils.profiling",
            "headtrackr_tpu_torch.oracle", "headtrackr_tpu_torch.oracle.pipeline",
            "headtrackr_tpu_torch.parallel",
            "headtrackr_tpu_torch.parallel.mesh"} <= set(mods)
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'headtrackr_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
