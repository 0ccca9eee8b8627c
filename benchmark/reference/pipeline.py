"""Full-pipeline oracle: the WB -> VJ -> CS state machine and the session loop.

FaceTracker transcribes src/facetrackr.js:37-228 (per-frame mode dispatch, VJ->CS
handoff, candidate selection).  HeadTracker transcribes the per-frame supervision
of src/main.js:168-305 (status side effects, loss/retry, smoothing, head-diagonal
stability gate, FOV caching, head position) driven by an array clip instead of a
camera.  Wall-clock ``time`` fields are stamped by the caller.

The benchmark's frozen copy of the port's NumPy oracle
(headtrackr_tpu_torch/oracle/pipeline.py): the yardstick that decides
``correct``, kept apart from the program so that no later change to the
program changes it.  It imports numpy alone.  Added to the copy: the band,
``band_hist`` and the rounding ``q`` handed to the camshift tracker, the
smoother and the head position; ``step`` also returns the raw face and the
statuses of this frame; ``state_key`` (exact state equality); a memo of
the detector's results by gray frame.
"""

import pickle

import numpy as np

from .camshift import CamshiftTracker
from .detector import detect_objects
from .headposition import HeadPositionTracker
from .imageproc import grayscale, whitebalance
from .precision import exact
from .smoother import Smoother

__all__ = ["FaceTracker", "HeadTracker"]

CONFIDENCE_THRESHOLD = -10.0  # src/facetrackr.js:57
PWB_LENGTH = 15               # src/facetrackr.js:59


def _track_obj(**kw):
    base = dict(height=0.0, width=0.0, angle=0.0, x=0.0, y=0.0,
                confidence=-10000.0, detection="", time=0, wb=None)
    base.update(kw)
    return base


class FaceTracker:
    """Oracle of headtrackr.facetrackr.Tracker (array frames in, TrackObj out)."""

    def __init__(self, cascade, whitebalancing=True, calc_angles=False,
                 send_events=True, interval=5, grayscale_mode="spec",
                 band=None, band_hist=False, q=exact, detections=None):
        self.cascade = cascade
        # detect_objects is a function of the gray frame alone: results of
        # frames seen before, shared by the session's trackers
        self.detections = {} if detections is None else detections
        self.mode = "WB" if whitebalancing else "VJ"
        self.calc_angles = calc_angles
        self.send_events = send_events
        self.interval = interval
        self.grayscale_mode = grayscale_mode
        self.cstracker = CamshiftTracker(calc_angles=calc_angles, band=band,
                                         band_hist=band_hist, q=q)
        self.previous_whitebalances = []
        self.cur_tracked = _track_obj()
        self.events = []

    def track(self, frame):
        """frame: (H, W, 3) u8.  Returns the current TrackObj dict."""
        if self.mode == "WB":
            result = _track_obj(detection="WB", wb=whitebalance(frame))
        elif self.mode == "VJ":
            result = self._do_vj(frame)
        else:
            result = self._do_cs(frame)

        if result["detection"] == "WB":
            # 15-deep stability window; switch when max - min < 2 (src/facetrackr.js:79-95)
            if len(self.previous_whitebalances) >= PWB_LENGTH:
                self.previous_whitebalances.pop()
            self.previous_whitebalances.insert(0, result["wb"])
            if len(self.previous_whitebalances) == PWB_LENGTH:
                if max(self.previous_whitebalances) - min(self.previous_whitebalances) < 2:
                    self.mode = "VJ"

        if result["detection"] == "VJ" and result["confidence"] > CONFIDENCE_THRESHOLD:
            # VJ -> CS handoff (src/facetrackr.js:97-108)
            self.mode = "CS"
            rect = (int(np.floor(result["x"])), int(np.floor(result["y"])),
                    int(np.floor(result["width"])), int(np.floor(result["height"])))
            self.cstracker.init_tracker(frame, rect)

        self.cur_tracked = result

        if result["detection"] == "CS" and self.send_events:
            self.events.append(("facetrackingEvent", {
                k: result[k] for k in
                ("height", "width", "angle", "x", "y", "confidence", "detection", "time")
            }))
        return dict(result)

    def _do_vj(self, frame):
        gray = grayscale(frame, mode=self.grayscale_mode)
        key = (gray.shape, gray.tobytes())
        if key not in self.detections:
            self.detections[key] = detect_objects(gray, self.cascade,
                                                  self.interval, 1)
        comp = self.detections[key]
        candidate = None
        for c in comp:  # max confidence, first wins ties (src/facetrackr.js:157-165)
            if candidate is None or c["confidence"] > candidate["confidence"]:
                candidate = c
        result = _track_obj(detection="VJ")
        if candidate is not None:
            result.update(width=candidate["width"], height=candidate["height"],
                          x=candidate["x"], y=candidate["y"],
                          confidence=candidate["confidence"])
        return result

    def _do_cs(self, frame):
        cs = self.cstracker.track(frame)
        return _track_obj(width=cs["width"], height=cs["height"], x=cs["x"],
                          y=cs["y"], angle=cs["angle"], confidence=1.0,
                          detection="CS")


class HeadTracker:
    """Oracle of the headtrackr.Tracker frame loop (src/main.js:168-305)."""

    def __init__(self, cascade, camwidth, camheight, smoothing=True,
                 retry_detection=True, fov=None, camera_offset=11.5,
                 calc_angles=False, head_position=True, detection_interval=20,
                 grayscale_mode="spec", band=None, band_hist=False, q=exact):
        self.cascade = cascade
        self.band, self.band_hist, self.q = band, band_hist, q
        self.detections = {}
        self.camwidth = camwidth
        self.camheight = camheight
        self.smoothing = smoothing
        self.retry_detection = retry_detection
        self.params_fov = fov
        self.camera_offset = camera_offset
        self.calc_angles = calc_angles
        self.head_position = head_position
        self.grayscale_mode = grayscale_mode

        self.facetracker = None
        self.smoother = Smoother(0.35, detection_interval + 15, q=q)
        self.headposition = None
        self.fov = 0.0
        self.face_found = False
        self.first_run = True
        self.head_diagonal = []
        self.statuses = []
        self.events = []
        self.stopped = False

    def _camshift_kw(self):
        return dict(band=self.band, band_hist=self.band_hist, q=self.q,
                    detections=self.detections)

    def state_key(self):
        """Bytes that equal another tracker's exactly when the two states
        are equal (the events and statuses logged so far, the cascade and
        the last backprojection, which no later frame reads, left out)."""
        return pickle.dumps(_state(self), protocol=4)

    def _status(self, s):
        self.statuses.append(s)
        self.events.append(("headtrackrStatus", s))

    def step(self, frame):
        """One iteration of the main track() loop.  Returns dict of outputs."""
        if self.facetracker is None:
            self.facetracker = FaceTracker(self.cascade, calc_angles=self.calc_angles,
                                           grayscale_mode=self.grayscale_mode,
                                           **self._camshift_kw())
        self.facetracker.track(frame)
        face = dict(self.facetracker.cur_tracked)
        raw = dict(face)
        n_status = len(self.statuses)
        headpos = None

        if face["detection"] == "WB":
            self._status("whitebalance")
        if self.first_run and face["detection"] == "VJ":
            self._status("detecting")

        if not face["confidence"] == 0:
            if face["detection"] == "CS":
                if face["width"] == 0 or face["height"] == 0:
                    # track lost (src/main.js:230-248)
                    if self.retry_detection:
                        self._status("redetecting")
                        self.facetracker = FaceTracker(
                            self.cascade, whitebalancing=False,
                            calc_angles=self.calc_angles,
                            grayscale_mode=self.grayscale_mode,
                            **self._camshift_kw())
                        self.face_found = False
                        self.headposition = None
                    else:
                        self._status("lost")
                        self.stopped = True
                else:
                    if not self.face_found:
                        self._status("found")
                        self.face_found = True
                    if self.smoothing:
                        if not self.smoother.initialized:
                            self.smoother.init(face)
                        face = self.smoother.smooth(face)
                    if self.headposition is None and self.head_position:
                        stable = False
                        headdiag = np.sqrt(face["width"] ** 2 + face["height"] ** 2)
                        if len(self.head_diagonal) < 6:
                            self.head_diagonal.append(headdiag)
                        else:
                            self.head_diagonal.pop(0)
                            self.head_diagonal.append(headdiag)
                            if max(self.head_diagonal) - min(self.head_diagonal) < 5:
                                stable = True
                        if stable:
                            if self.first_run:
                                self.headposition = HeadPositionTracker(
                                    face, self.camwidth, self.camheight,
                                    fov=self.params_fov,
                                    distance_from_camera_to_screen=self.camera_offset,
                                    q=self.q)
                                self.fov = self.headposition.get_fov()
                                self.first_run = False
                            else:
                                self.headposition = HeadPositionTracker(
                                    face, self.camwidth, self.camheight,
                                    fov=self.fov,
                                    distance_from_camera_to_screen=self.camera_offset,
                                    q=self.q)
                            headpos = self.headposition.track(face)
                    elif self.head_position and self.headposition is not None:
                        headpos = self.headposition.track(face)

        if headpos is not None:
            self.events.append(("headtrackingEvent", headpos))
        return dict(face=face, raw=raw, headpos=headpos,
                    mode=self.facetracker.mode, stopped=self.stopped,
                    statuses=self.statuses[n_status:])


_SKIP = frozenset(("events", "statuses", "cascade", "pdf", "q",
                   "detections"))


def _state(obj):
    """A tracker object's state as plain nested tuples."""
    if isinstance(obj, (FaceTracker, HeadTracker)) or hasattr(obj, "__dict__"):
        return (type(obj).__name__,
                tuple((k, _state(v)) for k, v in vars(obj).items()
                      if k not in _SKIP))
    if isinstance(obj, dict):
        return tuple((k, _state(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return tuple(_state(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    return obj
