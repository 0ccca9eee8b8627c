"""Camshift tracker over a batch of streams: histogram, backprojection, mean shift.

Behavior spec: src/camshift.js (see headtrackr_tpu/oracle/camshift.py); the
counterpart of headtrackr_tpu/models/camshift.py with the stream axis written
out.  Per frame: the current 4096-bin histogram, ratio weights, the
backprojection, <= 10 mean-shift iterations with the fixed-point freeze,
then size and orientation from the central moments.

Every function takes the reference's parameters, names and positional order,
with each array batched over a leading stream axis N (frames (N, H, W, 3),
windows and rects (N, 4)); ``init_state`` takes N first.

Two forms of the step:
  * ``track``: full frame (CUDA kernels on the card: the histogram that
    ``kernel`` names, ``hist_mma`` by default or ``hist4096``, then
    ``backproject_ratio``, which forms the ratio weights from the model
    and those counts as it stages its table).
  * ``track_band``: the pdf and the moments over an 8-aligned (bh, bw) band
    around each search window (``band_rect``, which each band kernel
    applies itself to the window it is given).  The current histogram is
    full frame (``kernel``'s, then ``backproject_ratio`` over the band) or,
    with
    ``band_hist``, the band's own (one fused ``histpdf_band`` launch:
    counts, weights and pdf).  A stream whose mean-shift trajectory leaves
    its band is flagged ``escaped``; its result is invalid and the caller
    recomputes it with ``track``.

* Mean shift is one launch of the ``meanshift`` kernel
  for the whole batch (kernels/meanshift.py): first moments from 1-D
  marginal prefix sums, window-relative like the reference package, the
  iterations, the second moments, all in shared memory and in the fixed
  order of its twin (ops/meanshift.py), so the card and the CPU agree to
  the bit.
* The finish (size and orientation from the central moments, the output
  box, the window growth) is the ``tick_epilogue`` kernel's finish form
  (kernels/epilogue.py); ``shift`` and ``shift_band`` stop before it, so
  that the serving step's "track" variant runs it fused with its
  supervision, one launch.
* The JS NaN-mediated loss (zero backprojection mass => 0-size box,
  src/camshift.js:109,240-241) is explicit zero-mass logic.
"""

from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..kernels import epilogue as _epilogue
from ..kernels import handoff as _handoff
from ..kernels import meanshift as _ms
from ..kernels.histpdf import backproject_ratio, histpdf_band, pdf_pallas
from ..ops.histogram import NBINS, histogram_full
from ..ops.meanshift import MEANSHIFT_ITERS

__all__ = ["CamshiftState", "init_state", "init_tracker", "track",
           "track_band", "mean_shift", "camshift_step", "MEANSHIFT_ITERS", "DEFAULT_BAND",
           "BAND_SLACK", "band_for", "parse_band", "band_rect", "band_rects",
           "handoff_band_audit"]

# Default band (rows, cols) of the band-local serving path at 240x320+:
# covers search windows up to ~(112, 176) px with drift margin; bigger
# windows (or trajectories reaching the band edge) raise ``escaped`` and the
# serving tick recomputes those streams full-frame (runtime/serving.py).
DEFAULT_BAND = (128, 192)

# Escape-free slack per band dimension: up to 8 px of 8-aligned band
# re-centering + the per-tick mean-shift trajectory + the 1.1x window growth
# (src/camshift.js:257-258).
BAND_SLACK = 24

_F32 = torch.float32
_I32 = torch.int32


class CamshiftState(NamedTuple):
    model_hist: torch.Tensor    # (N, 4096) f32
    window: torch.Tensor        # (N, 4) i32: x, y, width, height (JS ints)
    track_x: torch.Tensor       # (N,) i32 center x (JS Math.floor result)
    track_y: torch.Tensor       # (N,) i32
    track_w: torch.Tensor       # (N,) i32 (JS << 2 result)
    track_h: torch.Tensor       # (N,) i32
    track_angle: torch.Tensor   # (N,) f32 radians
    # bandHist handoff audit (TrackerConfig.bandHistAudit): True when, at
    # handoff, a pixel outside the serving band carried a model bin.  None
    # when the audit is off (the reference's schema rule, same leaf order).
    band_dirty: Optional[torch.Tensor] = None   # (N,) bool


def init_state(n, sparse_k=0, band_audit=False, *, device=None):
    """The state of n streams before a handoff, on ``device`` (see
    device.resolve_device: None is the card, and raises with none).
    ``sparse_k`` is accepted for the reference's signature: sparseHist is
    value-identical here, so the state carries no sparse descriptor."""
    device = resolve_device(device)
    z = torch.zeros((n,), dtype=_I32, device=device)
    return CamshiftState(
        model_hist=torch.zeros((n, NBINS), dtype=_F32, device=device),
        window=torch.zeros((n, 4), dtype=_I32, device=device),
        track_x=z, track_y=z.clone(), track_w=z.clone(), track_h=z.clone(),
        track_angle=torch.zeros((n,), dtype=_F32, device=device),
        # False before the handoff, which always overwrites it
        band_dirty=(torch.zeros((n,), dtype=torch.bool, device=device)
                    if band_audit else None))


def band_rect(window, band, frame_shape):
    """Each stream's serving band (ry, rx, bh, bw) for its search window:
    8-aligned starts centered on the clamped window, clipped to the frame.
    window (N, 4) i32 -> ry, rx (N,) i32 tensors and bh, bw ints -- the one
    placement rule of track_band, the handoff audit and the divergence
    cross-check.  The band kernels (histpdf_band, backproject_rect,
    meanshift, handoff) apply it themselves to the window they are given
    (csrc/band.cuh place_band, the same i32 arithmetic); their CPU twins
    call this function."""
    H, W = frame_shape
    bh = min(band[0], H)
    bw = min(band[1], W)
    cx = torch.clamp(window[:, 0], 0, W) + window[:, 2] // 2
    cy = torch.clamp(window[:, 1], 0, H) + window[:, 3] // 2
    rx = torch.clamp((cx - bw // 2) & ~7, 0, W - bw)
    ry = torch.clamp((cy - bh // 2) & ~7, 0, H - bh)
    return ry, rx, bh, bw


def band_rects(ry, rx, bh, bw):
    """``band_rect``'s result as (N, 4) i32 [x, y, w, h] rects."""
    return torch.stack([rx, ry, torch.full_like(rx, bw),
                        torch.full_like(rx, bh)], 1).to(_I32)


def _model_outside_band(is_model, rect, band):
    """(N,) bool: some pixel of the (N, H, W) 0/1 lookup ``is_model`` lies
    outside the band placed for ``rect``."""
    N, H, W = is_model.shape
    ry, rx, bh, bw = band_rect(rect, band, (H, W))
    rows = torch.arange(H, device=is_model.device).view(1, H, 1)
    cols = torch.arange(W, device=is_model.device).view(1, 1, W)
    v = lambda t: t.view(N, 1, 1)  # noqa: E731
    outside = ((rows < v(ry)) | (rows >= v(ry) + bh) |
               (cols < v(rx)) | (cols >= v(rx) + bw))
    return ((is_model > 0.5) & outside).flatten(1).any(1)


def handoff_band_audit(bins, model_hist, rect, band):
    """(N,) bool: some pixel OUTSIDE the band (placed for the handoff window
    ``rect`` (N, 4) i32) carries a bin with nonzero model count -- the
    content condition under which bandHist stops being exact
    (docs/PARITY.md deviation 13).  bins (N, H, W) i32, model_hist
    (N, 4096) f32.  One full-frame 0/1-weight lookup (``pdf_pallas``)
    masked to the band's complement."""
    is_model = pdf_pallas(bins, (model_hist > 0).to(_F32))
    return _model_outside_band(is_model, rect, band)


def init_tracker(frame_rgb, rect, sparse_k=0, audit_band=None):
    """VJ -> CS handoff (src/camshift.js:198-211): model histogram of each
    stream's crop.  frame_rgb (N, H, W, 3) u8; rect (N, 4) i32 [x, y, w, h],
    already floored by the caller (src/facetrackr.js:101-106).
    ``sparse_k`` is accepted for the reference's signature (sparseHist is
    value-identical here).  audit_band=(bh, bw) also runs the bandHist
    handoff audit (``handoff_band_audit``'s function) and stores
    ``band_dirty``.  One launch of the ``handoff`` kernel in its init form
    (kernels/handoff.py: the histogram, the model-bin mask and the audit's
    scan outside the band in one pass a stream)."""
    return CamshiftState(*_handoff.handoff(frame_rgb,
                                           rect=rect.to(_I32).contiguous(),
                                           band=audit_band))


def _finish(state, win, m, zero_mass, calc_angles, H, W):
    """Size/orientation from central moments + output box + 1.1x window
    growth (src/camshift.js:230-258): the ``tick_epilogue`` kernel's finish
    (kernels/epilogue.py; its twin ops/epilogue.finish_plain on the CPU)."""
    win, tx, ty, tw, th, ang = _epilogue.finish(win, m, zero_mass,
                                                calc_angles, H, W)
    return state._replace(window=win, track_x=tx, track_y=ty,
                          track_w=tw, track_h=th, track_angle=ang)


def mean_shift(pdf, window, exact=False):
    """Full-frame mean shift (src/camshift.js:261-312) for every stream:
    pdf (N, H, W) f32, window (N, 4) i32.  Returns (window' (N, 4) i32,
    moments {name: (N,) f32} at the stopping iteration, zero_mass (N,)
    bool).  One launch of the ``meanshift`` kernel (kernels/meanshift.py).
    ``exact`` is accepted for the reference's signature: the sums here are
    always f32-faithful, in the kernel's fixed order."""
    win, m, zero_mass, _ = _ms.mean_shift(pdf, window)
    return win, m, zero_mass


def track(state, frame_rgb, calc_angles=True, exact=False, block=None,
          kernel=None):
    """One camshift frame step for every stream (src/camshift.js:213-259).

    frame_rgb (N, H, W, 3) u8; kernel: TrackerConfig.histKernel, the
    full-frame histogram's kernel (see ops/histogram.HIST_KERNELS).
    ``exact`` and ``block`` are accepted for the reference's signature:
    the pdf is always the exact lookup, and no scan has blocks.  Returns
    (new state, full-frame pdf (N, H, W))."""
    H, W = frame_rgb.shape[1], frame_rgb.shape[2]
    win, m, zero_mass, pdf = shift(state, frame_rgb, kernel)
    return _finish(state, win, m, zero_mass, calc_angles, H, W), pdf


def shift(state, frame_rgb, kernel=None):
    """``track``'s work before the finish: the full-frame histogram, the
    ratio weights with the backprojection (one kernel) and the mean shift:
    three kernels, no PyTorch operation between them.  Returns (window'
    (N, 4) i32, moments, zero_mass (N,) bool, pdf (N, H, W))."""
    cur = histogram_full(frame_rgb, kernel)
    pdf = backproject_ratio(frame_rgb, state.model_hist, cur)
    win, m, zero_mass, _ = _ms.mean_shift(pdf, state.window)
    return win, m, zero_mass, pdf


def band_for(max_window, frame_shape=(240, 320)):
    """Smallest escape-free band (rows, cols) for search windows up to
    ``max_window`` = (h, w) px: each window dimension plus BAND_SLACK,
    rounded up to 8 px and clipped to the frame.  Undersized bands are
    safe -- escapes recompute full-frame (slower, never wrong)."""
    wh, ww = int(max_window[0]), int(max_window[1])
    H, W = int(frame_shape[0]), int(frame_shape[1])
    bh = min(-(-(wh + BAND_SLACK) // 8) * 8, H)
    bw = min(-(-(ww + BAND_SLACK) // 8) * 8, W)
    return (bh, bw)


def parse_band(tok):
    """CLI band token -> serving band value: "auto" -> "auto"
    (DEFAULT_BAND upstream), "none" -> None (full-frame), "HxW" -> (H, W)."""
    if tok == "auto":
        return "auto"
    if tok == "none":
        return None
    try:
        h, w = tok.split("x")
        return (int(h), int(w))
    except ValueError:
        raise ValueError(
            f"band must be 'auto', 'none', or HxW (e.g. 96x128); got "
            f"{tok!r}") from None


def track_band(state, frame_rgb, calc_angles=True, exact=False,
               band=DEFAULT_BAND, block=None, kernel=None, band_hist=False,
               audit_escape=True):
    """Band-local camshift step: ``track``'s math with the pdf lookup and
    moment reductions restricted to each stream's band (``band_rect``).

    The current histogram is full frame (reference semantics; the band pdf
    values then equal the full-frame ones exactly) or, with ``band_hist``
    (TrackerConfig.bandHist), counted over the band: exact whenever the
    band contains every model-colored pixel, else weights inflate toward 1
    (docs/PARITY.md deviation 13).

    Returns (new_state, escaped (N,) bool).  Where ``escaped`` is True the
    window's mean-shift trajectory left the band and that stream's new
    state is INVALID: the caller reruns ``track`` on its old state.

    audit_escape (TrackerConfig.bandHistAuditAction == "escape"): with
    band_hist and a state carrying ``band_dirty``, dirty streams are also
    reported escaped, so the caller's full-frame fallback serves them
    reference-exact.  False (the "flag" action) leaves the flag as
    telemetry.  kernel: the full-frame histogram's kernel, as in ``track``;
    ``exact`` and ``block`` are accepted as there.  frame_rgb
    (N, H, W, 3) u8."""
    H, W = frame_rgb.shape[1], frame_rgb.shape[2]
    win, m, zero_mass, escaped, dirty = shift_band(
        state, frame_rgb, band, kernel, band_hist, audit_escape)
    if dirty is not None:
        escaped = escaped | dirty
    return _finish(state, win, m, zero_mass, calc_angles, H, W), escaped


def shift_band(state, frame_rgb, band=DEFAULT_BAND, kernel=None,
               band_hist=False, audit_escape=True):
    """``track_band``'s work before the finish: the band's pdf and the
    mean shift over it.  Returns (window' (N, 4) i32, moments, zero_mass
    (N,) bool, escaped (N,) bool, dirty): dirty is the state's
    ``band_dirty`` where the "escape" audit action reports those streams
    escaped too (band_hist, audit_escape and the leaf present), else
    None."""
    H, W = frame_rgb.shape[1], frame_rgb.shape[2]
    bh, bw = min(band[0], H), min(band[1], W)
    window = state.window.contiguous()
    # each kernel places the band around its stream's window (band_rect's
    # rule, csrc/band.cuh place_band): no operation of the band here
    if band_hist:
        _, pdf = histpdf_band(frame_rgb, window, state.model_hist, (bh, bw))
    else:
        pdf = backproject_ratio(frame_rgb, state.model_hist,
                                histogram_full(frame_rgb, kernel), window,
                                (bh, bw))
    win, m, zero_mass, escaped = _ms.mean_shift(pdf, window, (H, W))
    dirty = (state.band_dirty if band_hist and audit_escape
             and state.band_dirty is not None else None)
    return win, m, zero_mass, escaped, dirty


def camshift_step(state, frame_rgb, calc_angles=True, exact=False):
    """``track``'s new state alone: one camshift step for every stream of
    ``frame_rgb`` (N, H, W, 3) u8.  ``exact`` is accepted for the
    reference's signature: this port's pdf is always the exact lookup."""
    return track(state, frame_rgb, calc_angles)[0]
