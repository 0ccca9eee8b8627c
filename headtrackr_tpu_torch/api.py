"""Host-side convenience API mirroring the reference's top-level helpers
(the port's counterpart of headtrackr_tpu/api.py).

  - getWhitebalance(image)    (src/whitebalance.js:5-29)
  - Smoother(alpha, interval) (src/smoother.js:13-89; observable behavior =
    EMA because of the reference's sp2-aliasing and msDiff bugs, see
    headtrackr_tpu/oracle/smoother.py; mode="desp" gives the intended
    double-exponential smoothing behind a flag)

Both run on the device in f32 (``device=``: None means the card, or an
error; a tensor argument stays on its own device).
"""

import numpy as np
import torch

from .device import resolve_device, to_device
from .ops.imageproc import whitebalance as _wb

__all__ = ["getWhitebalance", "Smoother"]

_F32 = torch.float32


def getWhitebalance(image, device=None):
    """Mean gray value of an RGB (H, W, 3) u8 frame."""
    return float(_wb(to_device(image, device)))


class Smoother:
    """Positional smoother over {x, y, z, width, height} dicts.

    Parity target is EMA (the reference's latent aliasing bug,
    src/smoother.js:27-28,44-46); pass mode="desp" for correct LaViola
    double-exponential smoothing.  State lives on the device in f32; one
    host copy per smooth()."""

    def __init__(self, alpha=0.35, interval=35, mode="ema", device=None):
        self.alpha = float(alpha)
        self.interval = float(interval)
        self.mode = mode
        self.device = resolve_device(device)
        self.initialized = False
        self._a = torch.tensor(self.alpha, dtype=_F32, device=self.device)
        self._sp = None
        self._sp2 = None

    def init(self, pos):
        """pos: dict/obj with x, y, width, height (z optional, default 0)."""
        self._sp = torch.tensor(_as_vec(pos), dtype=_F32, device=self.device)
        self._sp2 = self._sp.clone()
        self.initialized = True

    def smooth(self, pos):
        if not self.initialized:
            return False
        cur = torch.tensor(_as_vec(pos), dtype=_F32, device=self.device)
        a = self._a
        nsp = a * cur + (1 - a) * self._sp
        if self.mode == "desp":
            nsp2 = a * nsp + (1 - a) * self._sp2
            out = 2 * nsp - nsp2
        else:  # parity: the reference's aliasing bug makes sp2 === sp
            nsp2 = nsp
            out = nsp
        self._sp, self._sp2 = nsp, nsp2
        x, y, z, w, h = out.tolist()
        pos = dict(_as_dict(pos))
        pos.update(x=x, y=y, z=z, width=w, height=h)
        return pos

    def predict(self, time=0):
        """Extrapolated position (src/smoother.js:61-88), in float64 on the
        host from the f32 state.

        Parity note: in the reference, ``sp2`` aliases ``sp`` and the
        interpolation branch is dead code (wrong ``this``,
        src/smoother.js:23,65), so ``predict(t)`` observably returns the
        current smoothed position for any ``t``, which is what mode="ema"
        reproduces here.  mode="desp" implements the live
        (non-interpolating) branch: step = ``t/interval >> 0``,
        ratio = alpha*step/(1-alpha), 2+ratio times sp minus 1+ratio times
        sp2 (src/smoother.js:78-85)."""
        if not self.initialized:
            return False
        sp, sp2 = (a.astype(np.float64) for a in
                   torch.stack([self._sp, self._sp2]).cpu().numpy())
        step = int(time / self.interval)  # JS ``>> 0`` truncation
        ratio = (self.alpha * step) / (1.0 - self.alpha)
        out = (2.0 + ratio) * sp - (1.0 + ratio) * sp2
        x, y, z, w, h = out.tolist()
        return dict(x=x, y=y, z=z, width=w, height=h)


def _as_dict(pos):
    if isinstance(pos, dict):
        return pos
    return dict(x=pos.x, y=pos.y, z=getattr(pos, "z", 0.0),
                width=pos.width, height=pos.height)


def _as_vec(pos):
    d = _as_dict(pos)
    return [d["x"], d["y"], d.get("z", 0.0) or 0.0, d["width"], d["height"]]
