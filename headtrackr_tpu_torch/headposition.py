"""API-parity namespace: headtrackr_tpu_torch.headposition (mirrors
headtrackr.headposition and headtrackr_tpu/headposition.py).

Stateful object API over the f32 geometry of models/headpose.py, the code
the batched step runs (models/facetracker.py), on the device.  Spec:
src/headposition.js:35-201.  Emits headtrackingEvent on the process-local
event bus like the reference dispatches on document.
"""

import math

import torch

from .device import resolve_device
from .models import headpose as _hp
from .runtime import events as _events

__all__ = ["Tracker", "TrackObj"]

_F32 = torch.float32


class TrackObj:
    """src/headposition.js:206-218: head position in cm rel. to screen center."""

    def __init__(self, x=None, y=None, z=None):
        self.x = x
        self.y = y
        self.z = z

    def clone(self):
        return TrackObj(self.x, self.y, self.z)

    def __repr__(self):
        return f"TrackObj(x={self.x}, y={self.y}, z={self.z})"


class Tracker:
    """Head position from facetrackr results, on ``device`` (None: the
    card, or an error).  The corner edge correction's head diagonal stays
    on the device between frames; one host copy per ``track``."""

    def __init__(self, facetrackrObj, camwidth, camheight, params=None,
                 send_events=True, device=None):
        params = params or {}
        self.device = resolve_device(device)
        face = _as_dict(facetrackrObj)
        self._camw = float(camwidth)
        self._camh = float(camheight)
        self._edge = bool(params.get("edgecorrection", True))
        self._offset = float(params.get(
            "distance_from_camera_to_screen", 11.5))
        w, h = float(face["width"]), float(face["height"])
        self._head_diag_cam = torch.tensor(math.sqrt(w * w + h * h),
                                           dtype=_F32, device=self.device)
        if params.get("fov") is not None:
            self._fov_width = float(params["fov"]) * math.pi / 180.0
        else:
            dts = float(params.get("distance_to_screen") or 60.0)
            fw, fh, cw, d = torch.tensor([w, h, self._camw, dts], dtype=_F32,
                                         device=self.device)
            self._fov_width = float(_hp.estimate_fov_width(fw, fh, cw, d))
        self._tan_fov = 2.0 * math.tan(self._fov_width / 2.0)
        self._send_events = send_events
        self.x = self.y = self.z = None

    def track(self, facetrackrObj):
        face = _as_dict(facetrackrObj)
        fx, fy, fw, fh, tan, cw, ch, off = torch.tensor(
            [face["x"], face["y"], face["width"], face["height"],
             self._tan_fov, self._camw, self._camh, self._offset],
            dtype=_F32, device=self.device)
        x, y, z, hdc = _hp.track_head(fx, fy, fw, fh, self._head_diag_cam,
                                      tan, cw, ch, off, self._edge)
        self._head_diag_cam = hdc
        self.x, self.y, self.z = torch.stack([x, y, z]).tolist()
        out = dict(x=self.x, y=self.y, z=self.z)
        if self._send_events:
            _events.dispatch_event("headtrackingEvent", out)
        return TrackObj(self.x, self.y, self.z)

    def getTrackerObj(self):
        return TrackObj(self.x, self.y, self.z)

    def getFOV(self):
        return self._fov_width * 180.0 / math.pi


def _as_dict(pos):
    if isinstance(pos, dict):
        return pos
    return dict(x=pos.x, y=pos.y, width=pos.width, height=pos.height,
                angle=getattr(pos, "angle", 0.0))
