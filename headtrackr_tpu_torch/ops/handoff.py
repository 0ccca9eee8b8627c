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

The twin computes by the kernel's split of a stream over P CTAs: the
rect's rows counted a share a CTA (``rect_shares``, the cluster
histogram's ``cta_share``) and the counts joined, the frame's rows audited
a share a CTA (rank k: rows [k H / P, (k + 1) H / P)) and the findings
joined by ``any``.  Integer counts and ``any`` are exact in any order, so
every P gives the same bits.
"""

import torch

from .histogram import NBINS, rgb_bins
from .imageproc import slot_rows

__all__ = ["handoff_plain", "CONFIDENCE_THRESHOLD", "NO_CONF"]

CONFIDENCE_THRESHOLD = -10.0   # src/facetrackr.js:57
NO_CONF = -10000.0             # a VJ miss's confidence
_MODE_VJ, _MODE_CS = 1, 2      # models/facetracker.py MODE_VJ, MODE_CS
_F32, _I32 = torch.float32, torch.int32
_MIN_CTA_PX = 3072  # csrc/cluster_hist.cuh kMinCtaPx


def rect_shares(rw, rh, split):
    """(S, split, 2) i64: the rows [r0, r1) of each stream's clamped rect
    (rw x rh, (S,) tensors) that each of ``split`` CTAs counts: the rh rows
    split evenly over the first min(split, ceil(rw rh / 3072), rh) CTAs (at
    least one), none for the others (csrc/cluster_hist.cuh cta_share;
    kernels/histpdf.py cluster_rows for one rect)."""
    rw, rh = rw.to(torch.int64), rh.to(torch.int64)
    active = torch.clamp(torch.minimum(torch.minimum(
        torch.full_like(rh, split), -(-(rw * rh) // _MIN_CTA_PX)), rh), min=1)
    k = torch.arange(split, device=rh.device).view(1, split)
    a, h = active.view(-1, 1), rh.view(-1, 1)
    r0 = torch.where(k < a, k * h // a, h)
    r1 = torch.where(k < a, (k + 1) * h // a, h)
    return torch.stack([r0, r1], 2)


def _rect_counts(rows, rect, split):
    """(S, 4096) i32: each stream's counts of its rect clamped to the frame,
    counted a share of its rows a CTA (``rect_shares``) and joined."""
    S, H, W, _ = rows.shape
    dev = rows.device
    r = rect.to(torch.int64)
    x0, y0 = torch.clamp(r[:, 0], min=0), torch.clamp(r[:, 1], min=0)
    rw = torch.clamp(torch.clamp(r[:, 0] + r[:, 2], max=W) - x0, min=0)
    rh = torch.clamp(torch.clamp(r[:, 1] + r[:, 3], max=H) - y0, min=0)
    shares = rect_shares(rw, rh, split)  # (S, split, 2)
    local = torch.arange(H, device=dev).view(1, H, 1) - y0.view(S, 1, 1)
    in_share = (local >= shares[:, None, :, 0]) & \
        (local < shares[:, None, :, 1])  # (S, H, split)
    cta = torch.argmax(in_share.to(torch.int8), 2)  # each row's CTA
    col = torch.arange(W, device=dev).view(1, 1, W)
    inside = in_share.any(2).view(S, H, 1) & (col >= x0.view(S, 1, 1)) & \
        (col < (x0 + rw).view(S, 1, 1))
    ids = rgb_bins(rows).to(torch.int64) + NBINS * torch.arange(
        S, device=dev).view(S, 1, 1)
    counts = torch.zeros((S * NBINS,), dtype=torch.int64, device=dev)
    for k in range(split):  # each CTA's share, joined in rank order
        counts += torch.bincount(ids[inside & (cta.view(S, H, 1) == k)],
                                 minlength=S * NBINS)
    return counts.view(S, NBINS).to(_I32)


def _outside_band(rows, hist, rect, band, split):
    """(S,) bool: some pixel of ``rows`` whose bin has a nonzero count in
    ``hist`` lies outside the band placed for ``rect`` (the placement rule
    of models/camshift.py band_rect), found a share of the frame's rows a
    CTA and joined."""
    from ..models.camshift import band_rect
    S, H, W, _ = rows.shape
    dev = rows.device
    is_model = torch.gather((hist > 0).to(_F32), 1,
                            rgb_bins(rows).to(torch.int64).view(S, -1))
    ry, rx, bh, bw = band_rect(rect, band, (H, W))
    r = torch.arange(H, device=dev).view(1, H, 1)
    c = torch.arange(W, device=dev).view(1, 1, W)
    v = lambda t: t.view(S, 1, 1)  # noqa: E731
    outside = (r < v(ry)) | (r >= v(ry) + bh) | (c < v(rx)) | (c >= v(rx) + bw)
    row_hit = ((is_model.view(S, H, W) > 0.5) & outside).any(2)  # (S, H)
    k = torch.arange(split, device=dev)
    cta = torch.bucketize(torch.arange(H, device=dev), k * H // split,
                          right=True) - 1  # row y's CTA
    found = torch.zeros((S, split), dtype=torch.int32, device=dev)
    found.index_add_(1, cta, row_hit.to(torch.int32))
    return (found > 0).any(1)


def _new_state(rows, rect, band, split):
    """The camshift leaves of a fresh handoff on each row's ``rect``."""
    S = rect.shape[0]
    hist = _rect_counts(rows, rect, split).to(_F32)
    z = torch.zeros((S,), dtype=_I32, device=rect.device)
    return (hist, rect, z, z.clone(), z.clone(), z.clone(),
            torch.zeros((S,), dtype=_F32, device=rect.device),
            _outside_band(rows, hist, rect, band, split) if band is not None
            else None)


def handoff_plain(frames, slots=None, rect=None, det=None, entry_mode=None,
                  mode=None, old=None, band=None, split=None):
    """The handoff over S rows of frames (N, H, W, 3) u8 read through
    ``slots`` (S,) i64 padded with N (None: every stream); band=(bh, bw):
    also the audit, giving band_dirty.  ``split``: the CTAs a stream whose
    shares the twin counts and audits (None: the kernel's ``pick_split``).

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
    if split is None:
        from ..kernels.handoff import pick_split
        split = pick_split(rows.shape[0])
    if det is None:
        return _new_state(rows, rect.to(_I32), band, split)
    found, x, y, w, h, conf = det
    conf = torch.where(found, conf, NO_CONF)
    box = [torch.where(found, t, 0.0).to(_F32) for t in (x, y, w, h)]
    is_vj = entry_mode == _MODE_VJ
    switch = is_vj & (conf > CONFIDENCE_THRESHOLD)
    rect = torch.floor(torch.stack(box, 1)).to(_I32)
    new = _new_state(rows, rect, band, split)
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

