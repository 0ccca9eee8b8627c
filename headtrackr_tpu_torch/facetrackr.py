"""API-parity namespace: headtrackr_tpu_torch.facetrackr (mirrors
headtrackr.facetrackr and headtrackr_tpu/facetrackr.py).

The detection orchestrator as a user-facing class (src/facetrackr.js:37-65,
128): the per-frame WB -> VJ -> CS state machine over array frames at N = 1,
built on the ``ccv`` and ``camshift`` facades, usable without the session
runtime.  (The batched form of the same machine is
models/facetracker.make_step.)

Canvas-free mapping: the reference's mutable ``_inputcanvas`` becomes either
a provider given to ``init`` (a VideoSource, a callable returning the
current frame, or a fixed array) that ``track()`` reads each call, or an
explicit ``track(frame)`` argument.  Frames are (H, W, 3) u8 arrays or
tensors; each frame is copied to the device once.  As in the reference, the
orchestrator never leaves CS once it is there: re-detection is the
session's (runtime/tracker.py).
"""

import time as _time

import numpy as np
import torch

from . import camshift as _camshift
from . import ccv as _ccv
from .api import getWhitebalance
from .cascade import frontalface
from .device import resolve_device, to_device
from .runtime import events as ev

__all__ = ["Tracker", "TrackObj"]

_CONFIDENCE_THRESHOLD = -10  # src/facetrackr.js:57
_PWB_LENGTH = 15             # src/facetrackr.js:59 (comment says 10, code 15)


class TrackObj:
    """src/facetrackr.js:233-255."""

    def __init__(self):
        self.height = 0
        self.width = 0
        self.angle = 0
        self.x = 0
        self.y = 0
        self.confidence = -10000
        self.detection = ""
        self.time = 0
        self.wb = 0  # set by the WB branch (src/facetrackr.js:224)

    def clone(self):
        c = TrackObj()
        c.__dict__.update(self.__dict__)
        return c

    def __repr__(self):
        return (f"TrackObj(detection={self.detection!r}, x={self.x}, "
                f"y={self.y}, w={self.width}, h={self.height}, "
                f"confidence={self.confidence})")


class Tracker:
    """Detection orchestrator (src/facetrackr.js:37-126).

    Params (same names/defaults as the reference, src/facetrackr.js:39-53):
      sendEvents (True), whitebalancing (True), debug (False),
      calcAngles (False).
    Framework extras: ``bus`` (event bus; default the module-level bus),
    ``cascade`` (defaults to the bundled frontal-face model, like the
    reference's hardcoded headtrackr.cascade at src/facetrackr.js:147-149)
    and ``device`` (None: the card, or an error).
    """

    def __init__(self, params=None, *, bus=None, cascade=None, device=None,
                 **kw):
        p = dict(params or {})
        p.update(kw)
        self.send_events = bool(p.pop("sendEvents", True))
        self.whitebalancing = bool(p.pop("whitebalancing", True))
        self.debug = bool(p.pop("debug", False))
        self.calc_angles = bool(p.pop("calcAngles", False))
        if p:
            raise TypeError(f"unknown facetrackr params: {sorted(p)}")
        self.device = resolve_device(device)
        self._bus = bus or ev.default_bus
        self._cascade = cascade if cascade is not None else frontalface()
        self._mode = "WB" if self.whitebalancing else "VJ"
        self._source = None
        self._cstracker = None
        self._curtracked = TrackObj()
        self._pwb = []  # previous whitebalance ring (src/facetrackr.js:58)

    def init(self, inputcanvas=None):
        """src/facetrackr.js:61-65: store the input surface, build the
        camshift tracker.  ``inputcanvas``: VideoSource / callable -> frame /
        array / None (then every ``track()`` call must pass a frame)."""
        self._source = inputcanvas
        self._cstracker = _camshift.Tracker(
            {"calcAngles": self.calc_angles}, device=self.device)

    def _current_frame(self, frame):
        if frame is None:
            src = self._source
            if src is None:
                raise ValueError("no input: init() with a source or pass "
                                 "track(frame)")
            read = getattr(src, "read", None)
            if callable(src):
                frame = src()
            elif callable(read):  # VideoSource: read the next frame
                frame = read()
                if frame is None:
                    return None
            else:
                frame = src
        if not torch.is_tensor(frame):
            frame = np.asarray(frame)
        return to_device(frame, self.device)

    def track(self, frame=None):
        """One step of the mode state machine (src/facetrackr.js:67-126).
        Returns the TrackObj result (also via getTrackingObject())."""
        frame = self._current_frame(frame)
        if frame is None:  # source exhausted: keep last result
            return self._curtracked.clone()
        if self._mode == "WB":
            result = self._check_whitebalance(frame)
        elif self._mode == "VJ":
            result = self._do_vj_detection(frame)
        else:
            result = self._do_cs_detection(frame)

        # whitebalance stability gate (src/facetrackr.js:79-95)
        if result.detection == "WB":
            if len(self._pwb) >= _PWB_LENGTH:
                self._pwb.pop()
            self._pwb.insert(0, result.wb)
            if len(self._pwb) == _PWB_LENGTH and \
                    (max(self._pwb) - min(self._pwb)) < 2:
                self._mode = "VJ"
        # VJ -> CS handoff (src/facetrackr.js:97-108)
        if result.detection == "VJ" and \
                result.confidence > _CONFIDENCE_THRESHOLD:
            self._mode = "CS"
            rect = _camshift.Rectangle(
                int(np.floor(result.x)), int(np.floor(result.y)),
                int(np.floor(result.width)), int(np.floor(result.height)))
            self._cstracker.initTracker(frame, rect)

        self._curtracked = result

        if result.detection == "CS" and self.send_events:
            # facetrackingEvent (src/facetrackr.js:112-125)
            self._bus.dispatch_event(ev.FACETRACKING, {
                "height": result.height, "width": result.width,
                "angle": result.angle, "x": result.x, "y": result.y,
                "confidence": result.confidence,
                "detection": result.detection, "time": result.time,
            })
        # a clone, like getTrackingObject: the stored result must not alias
        # a caller-mutable object
        return result.clone()

    def getTrackingObject(self):
        """src/facetrackr.js:128-130."""
        return self._curtracked.clone()

    # -- branches ----------------------------------------------------------

    def _check_whitebalance(self, frame):
        """src/facetrackr.js:220-227."""
        result = TrackObj()
        result.wb = getWhitebalance(frame)
        result.detection = "WB"
        return result

    def _do_vj_detection(self, frame):
        """src/facetrackr.js:133-182: detect, pick max confidence (first
        wins ties, like the JS strictly-greater scan)."""
        start = _time.time()
        comp = _ccv.detect_objects(_ccv.grayscale(frame), self._cascade, 5, 1)
        diff = int((_time.time() - start) * 1000)
        candidate = None
        for c in comp:
            if candidate is None or c["confidence"] > candidate["confidence"]:
                candidate = c
        result = TrackObj()
        if candidate is not None:
            result.width = candidate["width"]
            result.height = candidate["height"]
            result.x = candidate["x"]
            result.y = candidate["y"]
            result.confidence = candidate["confidence"]
        result.time = diff
        result.detection = "VJ"
        return result

    def _do_cs_detection(self, frame):
        """src/facetrackr.js:185-217."""
        start = _time.time()
        csresult = self._cstracker.track(frame)
        diff = int((_time.time() - start) * 1000)
        result = TrackObj()
        result.width = csresult.width
        result.height = csresult.height
        result.x = csresult.x
        result.y = csresult.y
        result.angle = csresult.angle
        result.confidence = 1
        result.time = diff
        result.detection = "CS"
        return result

    def getBackProjectionImg(self):
        """Debug surface (src/facetrackr.js:194-196): the camshift
        backprojection image of the last CS frame, or None."""
        if self._cstracker is None:
            return None
        return self._cstracker.getBackProjectionImg()
