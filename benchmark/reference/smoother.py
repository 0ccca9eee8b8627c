"""Smoother oracle.

The reference intends LaViola double-exponential smoothing (src/smoother.js:1-11)
but two latent bugs make the *observable* behavior a plain EMA with alpha = 0.35:

  1. ``sp2 = sp`` aliases the arrays (src/smoother.js:27-28), so the second stage
     update ``sp2[i] = a*sp[i] + (1-a)*sp2[i]`` reads/writes the same slot and is a
     no-op, leaving sp2 === sp forever.
  2. ``updateTime`` is reset immediately before computing msDiff
     (src/smoother.js:44-46), so predict(0) returns ``2*sp - sp2 == sp``.

The framework's parity target is therefore EMA on [x, y, z, width, height]; a
correct DESP implementation is available behind ``mode="desp"`` for users who want
the intended behavior.  The z channel: the reference feeds undefined (NaN) z — we
deliberately carry z = 0 instead (documented deviation; z is never consumed).

The benchmark's frozen copy of the port's NumPy oracle
(headtrackr_tpu_torch/oracle/smoother.py): the yardstick that decides
``correct``, kept apart from the program so that no later change to the
program changes it.  It imports numpy alone.  Added to the copy: ``q``,
a rounding of the smoothed values (the lower-precision control's).
"""

from .precision import exact

__all__ = ["Smoother"]


class Smoother:
    def __init__(self, alpha=0.35, interval=35, mode="ema", q=exact):
        self.q = q
        self.alpha = alpha
        self.interval = interval
        self.mode = mode
        self.initialized = False
        self.sp = None
        self.sp2 = None

    def init(self, pos):
        """pos: dict with x, y, width, height (z optional, default 0)."""
        self.sp = [pos["x"], pos["y"], pos.get("z", 0.0), pos["width"], pos["height"]]
        self.sp2 = list(self.sp)
        self.initialized = True

    def smooth(self, pos):
        if not self.initialized:
            return False
        a = self.alpha
        cur = [pos["x"], pos["y"], pos.get("z", 0.0), pos["width"], pos["height"]]
        for i in range(5):
            self.sp[i] = self.q(a * cur[i] + (1 - a) * self.sp[i])
            if self.mode == "desp":
                self.sp2[i] = a * self.sp[i] + (1 - a) * self.sp2[i]
            else:  # parity: aliasing bug makes the second stage a no-op
                self.sp2[i] = self.sp[i]
        if self.mode == "desp":
            out = [2 * self.sp[i] - self.sp2[i] for i in range(5)]
        else:
            out = list(self.sp)
        pos = dict(pos)
        pos["x"], pos["y"], pos["z"], pos["width"], pos["height"] = out
        return pos
