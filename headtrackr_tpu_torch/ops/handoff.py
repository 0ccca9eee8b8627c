"""The VJ -> CS handoff in plain PyTorch: the twin of the ``handoff`` kernel
(kernels/handoff.py, csrc/handoff.cu).

Spec: src/facetrackr.js:97-108 and src/camshift.js:198-211, as the
reference computes them (headtrackr_tpu/models/facetracker.py:197-216
vj_branch's handoff, headtrackr_tpu/models/camshift.py:133 init_tracker
with :113 handoff_band_audit): the detection's result, the switch to CS
when its confidence clears the threshold, the floored rect, the model
histogram of that rect clamped to the frame and, with a band, whether a
model-colored pixel lies outside the band placed for the rect
(``band_dirty``).  The camshift leaves come back as a tuple in
``CamshiftState``'s order: model_hist (S, 4096) f32, window (S, 4) i32,
track_x, track_y, track_w, track_h (S,) i32, track_angle (S,) f32,
band_dirty (S,) bool or None.
"""

import torch

from .histogram import hist4096_plain, rgb_bins
from .imageproc import slot_rows

__all__ = ["handoff_plain", "CONFIDENCE_THRESHOLD", "NO_CONF"]

CONFIDENCE_THRESHOLD = -10.0   # src/facetrackr.js:57
NO_CONF = -10000.0             # a VJ miss's confidence
_MODE_VJ, _MODE_CS = 1, 2      # models/facetracker.py MODE_VJ, MODE_CS
_F32, _I32 = torch.float32, torch.int32


def _outside_band(rows, hist, rect, band):
    """(S,) bool: some pixel of ``rows`` whose bin has a nonzero count in
    ``hist`` lies outside the band placed for ``rect`` (the placement rule
    of models/camshift.py band_rect)."""
    from ..models.camshift import band_rect
    S, H, W, _ = rows.shape
    is_model = torch.gather((hist > 0).to(_F32), 1,
                            rgb_bins(rows).to(torch.int64).view(S, -1))
    ry, rx, bh, bw = band_rect(rect, band, (H, W))
    r = torch.arange(H, device=rows.device).view(1, H, 1)
    c = torch.arange(W, device=rows.device).view(1, 1, W)
    v = lambda t: t.view(S, 1, 1)  # noqa: E731
    outside = (r < v(ry)) | (r >= v(ry) + bh) | (c < v(rx)) | (c >= v(rx) + bw)
    return ((is_model.view(S, H, W) > 0.5) & outside).flatten(1).any(1)


def _new_state(rows, rect, band):
    """The camshift leaves of a fresh handoff on each row's ``rect``."""
    S = rect.shape[0]
    hist = hist4096_plain(rows, rect).to(_F32)
    z = torch.zeros((S,), dtype=_I32, device=rect.device)
    return (hist, rect, z, z.clone(), z.clone(), z.clone(),
            torch.zeros((S,), dtype=_F32, device=rect.device),
            _outside_band(rows, hist, rect, band) if band is not None
            else None)


def handoff_plain(frames, slots=None, rect=None, det=None, entry_mode=None,
                  mode=None, old=None, band=None):
    """The handoff over S rows of frames (N, H, W, 3) u8 read through
    ``slots`` (S,) i64 padded with N (None: every stream); band=(bh, bw):
    also the audit, giving band_dirty.

    Init form (``det`` None): ``rect`` (S, 4) i32 already floored; every
    row takes the new camshift leaves.  Returns the leaves (the
    ``init_tracker`` step).

    Handoff form: det = (found (S,) bool, x, y, w, h, conf (S,) f32), the
    detector's best box; entry_mode (S,) i32; mode (S,) i32 the rows'
    mode before the handoff (frame_prep's); old the rows' camshift leaves.
    A row that enters in VJ reports the detection (x, y, w, h where found,
    else 0; conf where found, else -10000) and switches to CS when its
    conf clears the threshold, taking the new leaves on its floored rect
    and mode CS; it stays in VJ otherwise.  Any other row keeps its mode
    and leaves and reports no detection (0s, conf -10000).  Returns
    (leaves, mode' (S,) i32, (x, y, w, h, angle, conf) (S,) f32)."""
    rows = slot_rows(frames, slots)
    if det is None:
        return _new_state(rows, rect.to(_I32), band)
    found, x, y, w, h, conf = det
    conf = torch.where(found, conf, NO_CONF)
    box = [torch.where(found, t, 0.0).to(_F32) for t in (x, y, w, h)]
    is_vj = entry_mode == _MODE_VJ
    switch = is_vj & (conf > CONFIDENCE_THRESHOLD)
    rect = torch.floor(torch.stack(box, 1)).to(_I32)
    new = _new_state(rows, rect, band)
    leaves = []
    for a, b in zip(new, old):
        if a is None:
            leaves.append(None)
            continue
        leaves.append(torch.where(switch.view((-1,) + (1,) * (a.dim() - 1)),
                                  a, b))
    mode2 = torch.where(is_vj, torch.where(switch, _MODE_CS, _MODE_VJ),
                        mode).to(_I32)
    zero = torch.zeros_like(conf)
    res = tuple(torch.where(is_vj, t, 0.0) for t in box) + (
        zero, torch.where(is_vj, conf, NO_CONF))
    return tuple(leaves), mode2, res

