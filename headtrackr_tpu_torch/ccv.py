"""API-parity namespace for the detector: headtrackr_tpu_torch.ccv.

Mirrors headtrackr.ccv (src/ccv.js) with arrays in place of canvases, as
headtrackr_tpu/ccv.py does:
  - grayscale(rgb)                                          src/ccv.js:22-32
  - detect_objects(gray, cascade, interval, min_neighbors)  src/ccv.js:109-333

detect_objects returns a list of dicts (x, y, width, height, neighbors,
confidence) like the JS, computed on the device by the batched detector
(models/detector.py) at N = 1 and brought to the host in one copy per
dtype.  Each function takes ``device=``: an array argument goes to that
device (None: the card, or an error), a tensor stays on its own.
"""

import numpy as np

from .device import to_device
from .models.detector import _TABLES  # noqa: F401 (the tables cache)
from .models.detector import detect_candidates, detect_objects_padded
from .ops.imageproc import grayscale as _grayscale
from .runtime.host import HostCopy

__all__ = ["grayscale", "detect_objects"]


def grayscale(image, device=None):
    """RGB (H, W, 3) u8 -> gray (H, W) u8 tensor (defined integer spec)."""
    return _grayscale(to_device(image, device))


def detect_objects(gray, cascade, interval=5, min_neighbors=1, device=None):
    """Face detections on a grayscale u8 image (an RGB one is grayscaled
    first), host-materialized.  min_neighbors > 0: grouped boxes with
    ``neighbors``; otherwise every raw candidate with ``neighbor=1`` (the
    reference's key, src/ccv.js:245-246)."""
    gray = to_device(gray, device)
    if gray.dim() == 3:
        gray = _grayscale(gray)
    keys = ("x", "y", "width", "height", "confidence")
    if not min_neighbors > 0:
        out = detect_candidates(gray[None], cascade, interval)
        *vals, valid = HostCopy([out[k][0] for k in keys + ("valid",)]).arrays()
        x, y, w, h, conf = vals
        return [dict(x=float(x[i]), y=float(y[i]), width=float(w[i]),
                     height=float(h[i]), neighbor=1, confidence=float(conf[i]))
                for i in np.nonzero(valid)[0]]
    g = detect_objects_padded(gray[None], cascade, interval, min_neighbors)
    *vals, nb, kept = HostCopy(
        [g[k][0] for k in keys + ("neighbors", "kept")]).arrays()
    x, y, w, h, conf = vals
    return [dict(x=float(x[i]), y=float(y[i]), width=float(w[i]),
                 height=float(h[i]), neighbors=int(nb[i]),
                 confidence=float(conf[i]))
            for i in np.nonzero(kept)[0]]
