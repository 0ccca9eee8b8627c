"""The per-frame WB -> VJ -> CS state machine over a batch of streams.

Spec: src/facetrackr.js:37-228 (mode dispatch, handoff) + src/main.js:168-305
(supervision: loss/retry, smoothing, head-diagonal stability gate, FOV caching,
head position).  The counterpart of headtrackr_tpu/models/facetracker.py:
state is a ``TrackerState`` of (N, ...) tensors, and the mode dispatch runs
each branch on the streams in that mode, selected by index.  The optional
``band_dirty`` leaf (None when the bandHist audit is off) passes through
every tree helper as None.

Status side effects are a bitmask in the step output (src/main.js:70-77).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import TrackerConfig
from ..device import resolve_device
from ..kernels import epilogue as _epilogue
from ..kernels.frameprep import frame_prep
from ..kernels.handoff import handoff
from ..kernels.launch import host_paths
from ..ops.epilogue import (DIAG_LENGTH, MODE_CS, MODE_VJ, MODE_WB,
                            STATUS_DETECTING, STATUS_FOUND, STATUS_LOST,
                            STATUS_REDETECTING, STATUS_WHITEBALANCE,
                            epilogue_config)
from ..ops.handoff import CONFIDENCE_THRESHOLD  # noqa: F401 (the reference's name)
from ..ops.histogram import check_hist_kernel
from ..ops.imageproc import PWB_LENGTH
from . import camshift as cs
from .detector import detect_best, detector_tables

__all__ = ["TrackerState", "StepOutput", "init_state", "make_step",
           "tree_index", "tree_scatter", "tree_where",
           "MODE_WB", "MODE_VJ", "MODE_CS",
           "STATUS_WHITEBALANCE", "STATUS_DETECTING", "STATUS_FOUND",
           "STATUS_REDETECTING", "STATUS_LOST", "STATUS_BITS"]

STATUS_BITS = [
    (STATUS_WHITEBALANCE, "whitebalance"),
    (STATUS_DETECTING, "detecting"),
    (STATUS_FOUND, "found"),
    (STATUS_REDETECTING, "redetecting"),
    (STATUS_LOST, "lost"),
]

_F32 = torch.float32
_I32 = torch.int32


class TrackerState(NamedTuple):
    mode: torch.Tensor            # (N,) i32: 0 WB, 1 VJ, 2 CS
    wb_ring: torch.Tensor         # (N, 15) f32, most recent first (JS unshift)
    wb_n: torch.Tensor            # (N,) i32
    cs: cs.CamshiftState
    sm_sp: torch.Tensor           # (N, 5) f32 smoother state [x, y, z, w, h]
    sm_init: torch.Tensor         # (N,) bool
    face_found: torch.Tensor      # (N,) bool
    first_run: torch.Tensor       # (N,) bool
    diag_ring: torch.Tensor       # (N, 6) f32
    diag_n: torch.Tensor          # (N,) i32
    headpose_active: torch.Tensor  # (N,) bool
    tan_fov: torch.Tensor         # (N,) f32 (2*tan(fov/2); 0 = unset)
    fov_width: torch.Tensor       # (N,) f32 radians (cached across re-inits)
    head_diag_cam: torch.Tensor   # (N,) f32 (stateful edge-correction diagonal)
    stopped: torch.Tensor         # (N,) bool
    pend_age: torch.Tensor        # (N,) i32 ticks pended unserved by the
                                  # device scheduler (runtime/serving.py;
                                  # nonzero only under overload="rotate")


class StepOutput(NamedTuple):
    detection: torch.Tensor       # i32 mode of this frame's result
    wb: torch.Tensor              # f32 (WB frames)
    face_x: torch.Tensor          # raw result fields (facetrackingEvent payload)
    face_y: torch.Tensor
    face_w: torch.Tensor
    face_h: torch.Tensor
    face_angle: torch.Tensor
    face_conf: torch.Tensor
    smooth_x: torch.Tensor        # main's faceObj after optional smoothing
    smooth_y: torch.Tensor
    smooth_w: torch.Tensor
    smooth_h: torch.Tensor
    head_valid: torch.Tensor      # bool: headtrackingEvent fired
    head_x: torch.Tensor
    head_y: torch.Tensor
    head_z: torch.Tensor
    status: torch.Tensor          # i32 bitmask of STATUS_*
    event_face: torch.Tensor      # bool: facetrackingEvent fired
    fov_deg: torch.Tensor         # f32 current FOV estimate in degrees
    mode_after: torch.Tensor      # i32 mode for the NEXT frame
    escaped: torch.Tensor         # bool: this tick's band-local camshift
                                  # result was recomputed full-frame (band
                                  # escape or the "escape" audit action);
                                  # the serving tick fills it after the
                                  # merge, always False off the band path


def init_state(n, whitebalancing=True, sparse_k=0, band_audit=False, *,
               device=None):
    """The state of n streams, the reference's ``init_state`` with the
    stream count first.  device: see device.resolve_device (None: the
    card).  whitebalancing must be a bool (so that a device passed in its
    place raises).  sparse_k is accepted for the reference's signature
    (sparseHist is value-identical here).  band_audit: carry the bandHist
    handoff-audit flag (must match the step's ``audit_band`` presence, the
    reference's schema rule)."""
    if not isinstance(whitebalancing, (bool, np.bool_)):
        raise TypeError(f"whitebalancing must be a bool, got "
                        f"{whitebalancing!r}")
    device = resolve_device(device)
    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)
    return TrackerState(
        mode=full((n,), MODE_WB if whitebalancing else MODE_VJ, _I32),
        wb_ring=full((n, PWB_LENGTH), 0.0, _F32), wb_n=full((n,), 0, _I32),
        cs=cs.init_state(n, band_audit=band_audit, device=device),
        sm_sp=full((n, 5), 0.0, _F32), sm_init=full((n,), False, torch.bool),
        face_found=full((n,), False, torch.bool),
        first_run=full((n,), True, torch.bool),
        diag_ring=full((n, DIAG_LENGTH), 0.0, _F32), diag_n=full((n,), 0, _I32),
        headpose_active=full((n,), False, torch.bool),
        tan_fov=full((n,), 0.0, _F32), fov_width=full((n,), 0.0, _F32),
        head_diag_cam=full((n,), 0.0, _F32),
        stopped=full((n,), False, torch.bool), pend_age=full((n,), 0, _I32),
    )


def tree_index(tree, idx):
    """Rows ``idx`` of every (N, ...) tensor of a NamedTuple tree."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_index(t, idx) for t in tree))
    return None if tree is None else tree.index_select(0, idx)


def tree_scatter(tree, idx, sub):
    """A copy of ``tree`` with rows ``idx`` replaced by ``sub``'s rows."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_scatter(t, idx, s) for t, s in zip(tree, sub)))
    return None if tree is None else tree.index_copy(0, idx, sub.to(tree.dtype))


def tree_where(cond, a, b):
    """Per-stream select over NamedTuple trees of (N, ...) tensors.  A leaf
    that is one tensor on both sides is returned as it is (the select of a
    tensor with itself is that tensor): a step passes a leaf it leaves
    unchanged through without a copy."""
    if isinstance(a, tuple):
        return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))
    if a is None or a is b:
        return a
    return torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)), a, b)


_where = tree_where


class _Result(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    angle: torch.Tensor
    conf: torch.Tensor
    wb: torch.Tensor
    escaped: torch.Tensor  # bool: band-local camshift left its band


def _empty_result(n, device):
    z = torch.zeros((n,), dtype=_F32, device=device)
    return _Result(z, z, z, z, z, torch.full_like(z, -10000.0), z,
                   torch.zeros((n,), dtype=torch.bool, device=device))


def make_step(cascade, config: TrackerConfig, frame_shape, variant="full",
              with_pdf=False, band=None, audit_band=None, *, device=None,
              tables=None):
    """Build the per-frame step for a static (cascade, config, H, W, device):
    the reference's ``make_step`` over a batch, with ``device`` and
    ``tables`` as keywords after its parameters.

    step(state, frames, modes=None, *, select=False) -> (state',
    StepOutput), frames (N, H, W, 3) u8.  ``modes`` is the host copy of
    ``state.mode`` (a NumPy array); when None the step reads it from the
    device.  select=True ("full" and "wbtrack"): the select form of the
    reference's vmapped per-stream ``lax.switch`` instead: every mode's
    branch runs on every stream and each stream takes its entry mode's
    result, so the step reads nothing on the host and a CUDA graph can
    capture it (``modes`` is ignored).  A stream's result is the same in
    both forms.

    variant="full":  the complete WB/VJ/CS mode dispatch; each branch runs
        on the streams in its mode.
    variant="track": camshift-only fast path.  Non-CS streams freeze: state
        unchanged, conf 0, no status, never ``escaped`` (the reference's
        freeze, so a scheduler may dispatch it on a stale mode view).  It
        selects with ``torch.where`` over the batch, so it holds no host
        read and a CUDA graph can capture it.
    variant="wbtrack": camshift for CS streams + whitebalance for WB
        streams; VJ streams freeze (state unchanged, conf 0, no status).
        The cold-start fast path: no detector.
    variant="pending": the "full" step for streams not in CS, in the
        select form of the reference's vmapped step: the WB and the VJ
        branch both run on every stream and each stream takes its mode's
        result (``_where``), so the step holds no host read and a CUDA
        graph can capture it.  A CS stream's result is meaningless; the
        caller drops it (the serving bucket's masked scatter).
    band=(bh, bw), with "track" or "wbtrack": the CS streams take the
        band-local camshift (models/camshift.track_band), and the step
        returns (state', StepOutput, escaped): escaped (N,) marks CS streams
        whose result is invalid (window left the band); the caller
        recomputes them with an unbanded "track" step.
    audit_band=(bh, bw): run the bandHist handoff audit at every VJ -> CS
        handoff and carry ``band_dirty`` (states must come from
        ``init_state(..., band_audit=True)``).
    tables: the detector tables of this (cascade, config, H, W, device),
        to share them between steps; built here when None.
    device: see device.resolve_device (None: the card).
    with_pdf=True: the step also returns the full-frame camshift
        backprojection (N, H, W) f32, zeros on streams not in CS at entry,
        as a third output: the debug surface of Tracker(debug=True)
        (src/facetrackr.js:194-196).  It is the pdf the camshift step
        computes anyway; not with ``band``.
    The full-frame histogram runs the kernel that config.histKernel names
    (ops/histogram.HIST_KERNELS: None -> hist_mma, "pallas" -> hist4096);
    any other value raises.  Every variant ends in one launch of the
    ``tick_epilogue`` kernel (kernels/epilogue.py; its twin on the CPU):
    "track" in its fused form from the mean shift's outputs (camshift's
    finish, the freeze, the supervision), the others in its supervision
    form after their branches.
    """
    device = resolve_device(device)
    if variant not in ("full", "track", "wbtrack", "pending"):
        raise ValueError("variant must be 'full', 'track', 'wbtrack' or "
                         f"'pending', got {variant!r}")
    if band is not None and (variant in ("full", "pending") or with_pdf):
        raise ValueError("band requires variant 'track' or 'wbtrack' "
                         "without with_pdf")
    hist_kernel = check_hist_kernel(config.histKernel)
    if config.bandHistAuditAction not in ("flag", "escape"):
        raise ValueError("bandHistAuditAction must be 'flag' or 'escape', "
                         f"got {config.bandHistAuditAction!r}")
    H, W = frame_shape
    if variant in ("full", "pending") and tables is None:
        tables = detector_tables(W, H, cascade, config.detectorInterval,
                                 device=device)
    epi = epilogue_config(config, frame_shape)

    def wb_branch(state, frames, wb_vj=False):
        """The WB branch (src/facetrackr.js:79-95) on the streams that
        enter in WB: one ``frame_prep`` launch (its whitebalance, the
        15-deep stability ring, VJ once the ring spans less than 2); the
        others keep their rows (wb_vj: VJ streams report the whitebalance
        too)."""
        _, wb, ring, n, mode = frame_prep(frames, None, state.mode,
                                          state.wb_ring, state.wb_n,
                                          gray=False, wb_vj=wb_vj)
        res = _empty_result(frames.shape[0], frames.device)._replace(wb=wb)
        return state._replace(mode=mode, wb_ring=ring, wb_n=n), res, None

    def vj_branch(state, frames, slots=None, prep=None):
        """The VJ branch and its handoff (src/facetrackr.js:97-108) on the
        streams that enter in VJ: the detector on ``frame_prep``'s gray
        plane (``prep``, the WB branch's run of it, when it ran), then one
        ``handoff`` launch: the result, the switch, the camshift rows of
        the floored rect (and the audit), the mode.  Every other stream
        keeps its mode and camshift rows and reports no detection.
        frames (N, ...) read through ``slots`` (None: every stream)."""
        if prep is None:
            prep = frame_prep(frames, slots, state.mode, state.wb_ring,
                              state.wb_n)
        det = detect_best(prep[0], tables, config.detectorInterval,
                          config.minNeighbors)
        leaves, mode, r = handoff(frames, slots, det=det,
                                  entry_mode=state.mode, mode=prep[4],
                                  old=tuple(state.cs), band=audit_band)
        res = _Result(*r, wb=prep[1], escaped=None)
        return state._replace(mode=mode, cs=cs.CamshiftState(*leaves)), \
            res, None

    def vj_frozen(state, frames):
        # wbtrack's VJ streams: the reference's wbtrack reports the
        # whitebalance branch's result with conf 0 and keeps the state
        _, res, _ = wb_branch(state, frames, wb_vj=True)
        return state, res._replace(conf=torch.zeros_like(res.conf)), None

    def cs_branch(state, frames):
        """(state', result, full-frame pdf or None off the full frame)."""
        pdf = None
        if band is None:
            new_cs, pdf = cs.track(state.cs, frames, config.calcAngles,
                                   kernel=hist_kernel)
            escaped = torch.zeros_like(state.mode, dtype=torch.bool)
        else:
            new_cs, escaped = cs.track_band(
                state.cs, frames, config.calcAngles, band=band,
                kernel=hist_kernel, band_hist=config.bandHist,
                audit_escape=config.bandHistAuditAction == "escape")
        one = torch.ones_like(new_cs.track_angle)
        res = _Result(x=new_cs.track_x.to(_F32), y=new_cs.track_y.to(_F32),
                      w=new_cs.track_w.to(_F32), h=new_cs.track_h.to(_F32),
                      angle=new_cs.track_angle, conf=one,
                      wb=torch.zeros_like(one), escaped=escaped)
        return state._replace(cs=new_cs), res, pdf

    branches = {MODE_WB: wb_branch,
                MODE_VJ: vj_frozen if variant == "wbtrack" else vj_branch,
                MODE_CS: cs_branch}

    def no_pdf(n):
        return torch.zeros((n, H, W), dtype=_F32, device=device)

    def dispatch(state, frames, modes):
        """Each mode's branch on its streams: (state', result, pdf or
        None), the pdf zero on the streams of other modes."""
        host_paths["dispatch"] += 1
        if modes is None:
            modes = state.mode.cpu().numpy()
        present = [m for m in (MODE_WB, MODE_VJ, MODE_CS) if (modes == m).any()]
        if len(present) == 1:
            return branches[present[0]](state, frames)
        new_state = state
        res = _empty_result(frames.shape[0], frames.device)
        pdf = None
        for m in present:
            idx = torch.as_tensor(np.nonzero(modes == m)[0], device=frames.device)
            sub_state, sub_res, sub_pdf = branches[m](
                tree_index(state, idx), frames.index_select(0, idx))
            if sub_res.escaped is None:  # the VJ branch reports none
                sub_res = sub_res._replace(escaped=torch.zeros(
                    idx.shape, dtype=torch.bool, device=frames.device))
            new_state = tree_scatter(new_state, idx, sub_state)
            res = tree_scatter(res, idx, sub_res)
            if with_pdf and sub_pdf is not None:
                pdf = no_pdf(frames.shape[0]).index_copy(0, idx, sub_pdf)
        return new_state, res, pdf

    def pending(state, frames, slots=None):
        """The WB and the VJ branch in one: ``frame_prep`` (the gray plane,
        the WB streams' rows), the detector, ``handoff`` (the VJ streams'
        rows), each writing only the rows of its own entry mode: (state',
        result, None), a CS stream's rows meaningless."""
        prep = frame_prep(frames, slots, state.mode, state.wb_ring,
                          state.wb_n)
        state = state._replace(wb_ring=prep[2], wb_n=prep[3])
        return vj_branch(state, frames, slots, prep)

    def selected(state, frames):
        """Every mode's branch on every stream, each stream taking its
        entry mode's result: (state', result, pdf or None).  The WB and
        VJ branches write only their own streams' rows (``frame_prep``,
        ``handoff``); the CS streams take the camshift branch's."""
        mode = state.mode
        is_cs = mode == MODE_CS
        if variant == "wbtrack":
            new, res, _ = wb_branch(state, frames, wb_vj=True)
            res = res._replace(conf=torch.where(mode == MODE_VJ, 0.0,
                                                res.conf))
        else:
            new, res, _ = pending(state, frames)
            res = res._replace(escaped=torch.zeros_like(is_cs))
        cs_state, cs_res, pdf = cs_branch(state, frames)
        new = new._replace(cs=_where(is_cs, cs_state.cs, new.cs))
        res = _where(is_cs, cs_res, res)
        if pdf is not None:
            pdf = torch.where(is_cs.view(-1, 1, 1), pdf, 0.0)
        return new, res, pdf

    def step(state, frames, modes=None, *, select=False, slots=None):
        entry_mode = state.mode
        if slots is not None and variant != "pending":
            raise ValueError("slots apply to the 'pending' step")
        if select and variant not in ("full", "wbtrack"):
            raise ValueError(f"select applies to the 'full' and 'wbtrack' "
                             f"steps, not {variant!r}")
        esc = None
        if variant == "track":  # the mean shift, then one epilogue launch
            if band is None:
                win, m, zero_mass, pdf = cs.shift(state.cs, frames,
                                                  hist_kernel)
                escaped = dirty = None
            else:
                win, m, zero_mass, escaped, dirty = cs.shift_band(
                    state.cs, frames, band, hist_kernel, config.bandHist,
                    config.bandHistAuditAction == "escape")
            state, out, esc = _epilogue.track(state, win, m, zero_mass,
                                              escaped, dirty, epi)
            if with_pdf:
                pdf = torch.where((entry_mode == MODE_CS).view(-1, 1, 1),
                                  pdf, 0.0)
        else:
            if variant == "pending":
                state, res, pdf = pending(state, frames, slots)
            elif select:
                state, res, pdf = selected(state, frames)
            else:
                state, res, pdf = dispatch(state, frames, modes)
            state, out, esc = _epilogue.supervise(
                state, entry_mode, res, epi, variant,
                res.escaped if band is not None else None)
        out = StepOutput(**out)
        if band is not None:
            return state, out, esc
        if with_pdf:
            return state, out, pdf if pdf is not None else \
                no_pdf(frames.shape[0])
        return state, out

    return step
