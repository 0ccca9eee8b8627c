"""One stream of the serving cells through the reference, tick by tick.

Per stream the serving tick equals the session's frame step (the device
scheduler serves every pending stream on the tick it pends, since no tick
of these cells has more pending streams than the chunk cap, and the lock
phase's mass-pending tick runs the full step on every stream).  So a
stream's outputs are the oracle's ``HeadTracker.step`` over its frames:
``n_lock`` ticks of its lock frame, then tick t of its pool, t % len(pool).

The pool repeats, so once the reference's whole state at the start of a
pass equals its state at the start of an earlier pass, every later tick
repeats the ticks between the two: ``stream_rows`` stops there and returns
the cycle, from which ``expand`` gives any tick.  That is exact (equal
states and equal frames give equal outputs), not an estimate.
"""

import numpy as np

from .pipeline import HeadTracker
from .precision import ROUNDINGS

__all__ = ["FIELDS", "STATUS", "MODES", "stream_rows", "expand",
           "load_cascade"]

# the outputs a caller consumes, as the harness reads them from the program
FIELDS = ("face_x", "face_y", "face_w", "face_h", "smooth_x", "smooth_y",
          "smooth_w", "smooth_h", "head_valid", "head_x", "head_y", "head_z",
          "status", "mode_after")
STATUS = {"whitebalance": 1, "detecting": 2, "found": 4, "redetecting": 8,
          "lost": 16}
MODES = {"WB": 0, "VJ": 1, "CS": 2}


def _row(r):
    raw, face, head = r["raw"], r["face"], r["headpos"]
    status = 0
    for name in r["statuses"]:
        status |= STATUS[name]
    h = (float(head["x"]), float(head["y"]), float(head["z"])) \
        if head is not None else (0.0, 0.0, 0.0)
    return (float(raw["x"]), float(raw["y"]), float(raw["width"]),
            float(raw["height"]), float(face["x"]), float(face["y"]),
            float(face["width"]), float(face["height"]),
            float(head is not None)) + h + (float(status),
                                            float(MODES[r["mode"]]))


def stream_rows(lock_frame, pool, cascade, band=None, band_hist=False,
                precision="f64", n_lock=16, max_passes=64):
    """The reference's outputs for one stream.

    lock_frame (H, W, 3) u8, pool (P, H, W, 3) u8, cascade the detector's
    arrays.  Returns (t0, period, rows): rows (t0 + period, len(FIELDS))
    float64 for ticks 0 .. t0 + period - 1 after the lock phase, the ticks
    from t0 on repeating with ``period`` (0 when no cycle was found within
    ``max_passes`` passes: rows then covers those passes alone)."""
    H, W = lock_frame.shape[:2]
    ht = HeadTracker(cascade, W, H, band=band, band_hist=band_hist,
                     q=ROUNDINGS[precision])
    for _ in range(n_lock):
        ht.step(lock_frame)
    plen = pool.shape[0]
    rows, seen = [], {}
    for p in range(max_passes):
        key = ht.state_key()
        if key in seen:
            t0 = seen[key] * plen
            return t0, p * plen - t0, np.asarray(rows, dtype=np.float64)
        seen[key] = p
        for t in range(plen):
            rows.append(_row(ht.step(pool[t])))
    return 0, 0, np.asarray(rows, dtype=np.float64)


def expand(t0, period, rows, ticks):
    """rows at the ticks ``ticks`` (ints >= 0) of a ``stream_rows`` cycle;
    ticks past the rows of a stream with no cycle raise."""
    ticks = np.asarray(ticks, dtype=np.int64)
    if period:
        ticks = np.where(ticks < t0, ticks, t0 + (ticks - t0) % period)
    elif ticks.size and ticks.max() >= rows.shape[0]:
        raise ValueError("the reference found no cycle and holds no row for "
                         f"tick {int(ticks.max())}")
    return rows[ticks]


def load_cascade(path):
    """The detector's arrays from an .npz file, as the oracle indexes them."""
    with np.load(path) as d:
        return {k: d[k] for k in d.files}
