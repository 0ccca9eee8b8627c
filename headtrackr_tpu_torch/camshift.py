"""API-parity namespace: headtrackr_tpu_torch.camshift (mirrors
headtrackr.camshift and headtrackr_tpu/camshift.py).

Canvas-free port of the reference interface (src/camshift.js:148-354):
frames are (H, W, 3) u8 arrays or tensors.  The work runs on the device in
models/camshift.py at N = 1 (the ``hist_mma``, ``backproject_ratio`` and
``meanshift`` kernels on the card); this wrapper is the stateful object API
(initTracker / track / getTrackObj / getBackProjectionImg).  ``Histogram``
counts an image's bins with the ``hist_bins`` kernel.
"""

import numpy as np
import torch

from .device import resolve_device, to_device
from .models import camshift as mc
from .ops.histogram import histogram_4096, rgb_bins
from .runtime.host import HostCopy

__all__ = ["Tracker", "Rectangle", "TrackObj", "Histogram"]


class Rectangle:
    """src/camshift.js:127-141."""

    def __init__(self, x=0, y=0, w=0, h=0):
        self.x = x
        self.y = y
        self.width = w
        self.height = h

    def clone(self):
        return Rectangle(self.x, self.y, self.width, self.height)

    def __repr__(self):
        return f"Rectangle({self.x}, {self.y}, {self.width}, {self.height})"


class TrackObj:
    """src/camshift.js:362-378: x/y = center of tracked object."""

    def __init__(self, x=0, y=0, width=0, height=0, angle=0.0):
        self.x = x
        self.y = y
        self.width = width
        self.height = height
        self.angle = angle

    def clone(self):
        return TrackObj(self.x, self.y, self.width, self.height, self.angle)

    def __repr__(self):
        return (f"TrackObj(x={self.x}, y={self.y}, w={self.width}, "
                f"h={self.height}, angle={self.angle})")


def Histogram(image, device=None):
    """4096-bin RGB histogram of an (H, W, 3) u8 image (src/camshift.js:49-72)
    as a (4096,) f32 NumPy array."""
    return histogram_4096(rgb_bins(to_device(image, device))).cpu().numpy()


class Tracker:
    """Stateful camshift tracker over array frames, on ``device`` (None: the
    card, or an error; a tensor frame stays on its own device)."""

    def __init__(self, params=None, calcAngles=None, device=None):
        params = params or {}
        if calcAngles is None:
            calcAngles = params.get("calcAngles", True)  # src/camshift.js:151
        self.calc_angles = bool(calcAngles)
        self.device = resolve_device(device)
        self._state = None
        self._pdf = None
        self._host = None  # the state's integers and angle on the host

    def initTracker(self, image, rect):
        if isinstance(rect, (tuple, list)):
            rect = Rectangle(*rect)
        frame = to_device(image, self.device)
        r = torch.tensor([[int(rect.x), int(rect.y), int(rect.width),
                           int(rect.height)]], dtype=torch.int32,
                         device=frame.device)
        self._state = mc.init_tracker(frame[None], r)
        self._pdf = None
        self._host = None

    def track(self, image):
        if self._state is None:
            raise RuntimeError("initTracker first")
        frame = to_device(image, self.device)
        h, w = frame.shape[:2]
        if w == 0 or h == 0:  # src/camshift.js:219
            return self.getTrackObj()
        self._state, pdf = mc.track(self._state, frame[None], self.calc_angles)
        self._pdf = pdf[0]
        self._host = None
        return self.getTrackObj()

    def _read(self):
        """(track_x, track_y, track_w, track_h, track_angle, window) of the
        one stream, by one host copy per dtype after each step."""
        if self._host is None:
            s = self._state
            self._host = [a[0] for a in HostCopy(
                [s.track_x, s.track_y, s.track_w, s.track_h, s.track_angle,
                 s.window]).arrays()]
        return self._host

    def getTrackObj(self):
        x, y, w, h, angle, _ = self._read()
        return TrackObj(int(x), int(y), int(w), int(h), float(angle))

    def getSearchWindow(self):
        x, y, w, h = self._read()[5].tolist()
        return Rectangle(x, y, w, h)

    def getPdf(self):
        return self._pdf.cpu().numpy() if self._pdf is not None else None

    def getBackProjectionImg(self):
        """Grayscale (H, W, 3) u8 rendering of the pdf (src/camshift.js:177-196)."""
        pdf = self.getPdf()
        if pdf is None:
            return None
        val = np.floor(255 * pdf).astype(np.uint8)
        return np.stack([val, val, val], axis=-1)
