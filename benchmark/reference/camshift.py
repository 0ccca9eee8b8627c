"""Camshift color tracker oracle (transcription of src/camshift.js).

State per tracker: the model histogram captured at init (src/camshift.js:198-211)
and the current search window.  Per frame: 4096-bin RGB histogram of the whole
frame, ratio backprojection, <=10 mean-shift moment iterations with early
fixed-point stop, then size/orientation from central moments.

Loss semantics (the signature behavior): zero backprojection mass => NaN moments
=> ``Math.sqrt(NaN) << 2 == 0`` => width = height = 0, which the runtime reads as
track-lost (src/main.js:230).  The oracle reproduces this via explicit NaN->0
conversion at the JS ``<< 2`` coercion points.

The benchmark's frozen copy of the port's NumPy oracle
(headtrackr_tpu_torch/oracle/camshift.py): the yardstick that decides
``correct``, kept apart from the program so that no later change to the
program changes it.  It imports numpy alone.

Added to the copy, the serving rules the oracle lacks:

* ``band_hist``: docs/PARITY.md deviation 13, band-local current
  histograms.  The band (``band_rect``: 8-aligned, centred on the search
  window clamped to the frame, clipped to the frame) is placed from the
  window a frame starts from; the current histogram counts the band's
  pixels alone.  A stream whose mean-shift trajectory leaves its band (a
  window of an executed iteration, clamped to the frame, not inside the
  band) is recomputed from the pre-frame window over the full frame, as
  the serving tick's escape fallback does.  Without ``band_hist`` the
  band changes nothing (the band pdf equals the full frame's and an
  escape recomputes the full frame), so the plain oracle stands.
* ``q``: a rounding applied to every float the camshift math produces
  (weights, pdf, moments, the size and orientation terms); identity for
  the reference, ``precision.bf16`` for the lower-precision control.
"""

import numpy as np

from .precision import exact

__all__ = ["Histogram", "Moments", "CamshiftTracker", "rgb_bins",
           "band_rect"]


def band_rect(window, band, frame_shape):
    """The serving band (ry, rx, bh, bw) for a search window [x, y, w, h]:
    8-aligned starts centred on the window clamped to the frame, clipped
    to the frame."""
    H, W = frame_shape
    bh, bw = min(band[0], H), min(band[1], W)
    cx = min(max(int(window[0]), 0), W) + int(window[2]) // 2
    cy = min(max(int(window[1]), 0), H) + int(window[3]) // 2
    rx = min(max((cx - bw // 2) & ~7, 0), W - bw)
    ry = min(max((cy - bh // 2) & ~7, 0), H - bh)
    return ry, rx, bh, bw


def rgb_bins(rgb):
    """Per-pixel 4096-bin index: 256*(r>>4) + 16*(g>>4) + (b>>4).  src/camshift.js:62-66."""
    rgb = np.asarray(rgb)
    r = (rgb[..., 0].astype(np.int32) >> 4)
    g = (rgb[..., 1].astype(np.int32) >> 4)
    b = (rgb[..., 2].astype(np.int32) >> 4)
    return 256 * r + 16 * g + b


def Histogram(rgb):
    """4096-bin histogram of an (H, W, 3) u8 image region.  src/camshift.js:49-72."""
    return np.bincount(rgb_bins(rgb).ravel(), minlength=4096).astype(np.float64)


def Moments(pdf, x, y, w, h, second, q=exact):
    """Raw + central moments of pdf over the window [x, w) x [y, h).

    NOTE: like the JS (src/camshift.js:79-120), ``w``/``h`` are *exclusive upper
    bounds*, not sizes, and vx/vy are relative to the window origin.  pdf is
    indexed pdf[row=y][col=x] here (the JS stores column-major; same values).
    Returns dict with m00..mu11, xc/yc in window-origin-relative coords... no:
    xc = m10/m00 is relative to (x, y) since vx = i - x.
    """
    win = pdf[y:h, x:w]
    hh, ww = win.shape
    vy = np.arange(hh, dtype=np.float64)[:, None]
    vx = np.arange(ww, dtype=np.float64)[None, :]
    m00 = q(win.sum())
    m01 = q((vy * win).sum())
    m10 = q((vx * win).sum())
    out = {"m00": m00, "m01": m01, "m10": m10}
    with np.errstate(divide="ignore", invalid="ignore"):
        invM00 = q(1.0 / m00)   # inf when m00 == 0, like JS
        xc = q(m10 * invM00)    # NaN when m00 == 0 (0 * inf)
        yc = q(m01 * invM00)
    out.update(invM00=invM00, xc=xc, yc=yc)
    if second:
        m11 = q((vx * vy * win).sum())
        m02 = q((vy * vy * win).sum())
        m20 = q((vx * vx * win).sum())
        out.update(
            m11=m11, m02=m02, m20=m20,
            mu20=q(m20 - m10 * xc),
            mu02=q(m02 - m01 * yc),
            mu11=q(m11 - m01 * xc),  # JS quirk: mu11 uses m01 * xc (src/camshift.js:118)
        )
    else:
        out.update(m11=0.0, m02=0.0, m20=0.0, mu20=np.nan, mu02=np.nan, mu11=np.nan)
    return out


def _js_int32(v):
    """JS ``x >> 0`` / ``x << 2 >> 2`` ToInt32: NaN -> 0, truncate toward zero."""
    if np.isnan(v) or np.isinf(v):
        return 0
    return int(np.trunc(v))


class CamshiftTracker:
    """Oracle equivalent of headtrackr.camshift.Tracker.  Frames are (H, W, 3) u8."""

    def __init__(self, calc_angles=True, band=None, band_hist=False, q=exact):
        self.calc_angles = calc_angles
        self.band = band
        self.band_hist = band_hist and band is not None
        self.q = q
        self.model_hist = None
        self.search_window = None   # [x, y, width, height] ints/floats like JS
        self.track_obj = dict(x=0, y=0, width=0, height=0, angle=0.0)
        self.pdf = None

    def init_tracker(self, frame, rect):
        """rect: (x, y, w, h) ints — the VJ handoff crop.  src/camshift.js:198-211."""
        x, y, w, h = rect
        crop = frame[y:y + h, x:x + w]
        self.model_hist = Histogram(crop)
        self.search_window = [x, y, w, h]
        self.track_obj = dict(x=0, y=0, width=0, height=0, angle=0.0)

    def track(self, frame):
        h, w = frame.shape[:2]
        if w != 0 and h != 0:
            self._cam_shift(frame)
        return dict(self.track_obj)

    # -- internals ---------------------------------------------------------

    def _cam_shift(self, frame):
        h, w = frame.shape[:2]
        m = self._mean_shift(frame)
        q = self.q

        a = q(m["mu20"] * m["invM00"])
        c = q(m["mu02"] * m["invM00"])

        if self.calc_angles:
            b = q(m["mu11"] * m["invM00"])
            d = q(a + c)
            e = q(np.sqrt((4 * b * b) + ((a - c) * (a - c))))
            self.track_obj["width"] = _js_int32(np.sqrt((d - e) * 0.5)) << 2
            self.track_obj["height"] = _js_int32(np.sqrt((d + e) * 0.5)) << 2
            angle = np.arctan2(2 * b, a - c + e)
            if np.isnan(angle):
                self.track_obj["angle"] = np.nan
            else:
                self.track_obj["angle"] = angle + np.pi if angle < 0 else angle
        else:
            self.track_obj["width"] = _js_int32(np.sqrt(a)) << 2
            self.track_obj["height"] = _js_int32(np.sqrt(c)) << 2
            self.track_obj["angle"] = np.pi / 2

        sw = self.search_window
        self.track_obj["x"] = int(np.floor(max(0, min(sw[0] + sw[2] / 2, w))))
        self.track_obj["y"] = int(np.floor(max(0, min(sw[1] + sw[3] / 2, h))))

        sw[2] = int(np.floor(1.1 * self.track_obj["width"]))
        sw[3] = int(np.floor(1.1 * self.track_obj["height"]))

    def _mean_shift(self, frame):
        if self.band_hist:
            h, w = frame.shape[:2]
            start = list(self.search_window)
            ry, rx, bh, bw = band_rect(start, self.band, (h, w))
            m, escaped = self._shift(frame, Histogram(frame[ry:ry + bh,
                                                            rx:rx + bw]),
                                     (ry, rx, bh, bw))
            if not escaped:
                return m
            self.search_window = start  # the escape fallback: full frame
        return self._shift(frame, Histogram(frame), None)[0]

    def _shift(self, frame, cur_hist, band):
        """The pdf from ``cur_hist`` and <= 10 mean-shift iterations.
        Returns (moments, escaped): escaped when an iteration's window,
        clamped to the frame, is not inside ``band`` (ry, rx, bh, bw)."""
        h, w = frame.shape[:2]
        q = self.q
        with np.errstate(divide="ignore", invalid="ignore"):
            weights = q(np.where(cur_hist != 0,
                                 np.minimum(self.model_hist / cur_hist, 1.0),
                                 0.0))
        self.pdf = weights[rgb_bins(frame)]  # (H, W) float backprojection

        sw = self.search_window
        iters = 10
        prevx, prevy = sw[0], sw[1]
        m = None
        escaped = False
        wadx = wady = wadw = wadh = 0
        for i in range(iters):
            wadx = max(sw[0], 0)
            wady = max(sw[1], 0)
            wadw = min(wadx + sw[2], w)
            wadh = min(wady + sw[3], h)
            if band is not None:
                ry, rx, bh, bw = band
                escaped |= (wadx < rx or wady < ry or wadw > rx + bw
                            or wadh > ry + bh)
            m = Moments(self.pdf, wadx, wady, wadw, wadh, i == iters - 1, q)
            sw[0] += _js_int32(m["xc"] - sw[2] / 2)
            sw[1] += _js_int32(m["yc"] - sw[3] / 2)
            if sw[0] == prevx and sw[1] == prevy:
                m = Moments(self.pdf, wadx, wady, wadw, wadh, True, q)
                break
            prevx, prevy = sw[0], sw[1]

        sw[0] = max(0, min(sw[0], w))
        sw[1] = max(0, min(sw[1], h))
        return m, escaped
