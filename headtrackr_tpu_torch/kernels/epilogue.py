"""Wrapper of the ``tick_epilogue`` CUDA kernel (``csrc/epilogue.cu``).

  finish     replaces headtrackr_tpu/models/camshift.py _finish (with
             _sqrt_shl2)
  supervise  replaces the supervision of headtrackr_tpu/models/
             facetracker.py full_step (lines 288-397, with
             models/headpose.py estimate_fov_width and track_head)
  track      both, with the "track" variant's freeze between them: the
             "track" step's whole end from the mean shift's outputs

One kernel in three forms (a flags word).  Dispatch as in
kernels/histpdf.py: CPU tensors take the plain twin (ops/epilogue.py), CUDA
tensors launch the kernel, one launch a call for every stream; any other
device raises, and so does a failed build or launch.  The kernel equals
the twin run on the card to the bit (NaN-equal).  Inputs are read where
they lie (a base and a stride between streams, so the mean shift's moment
columns are read in place); each output is a row of a fresh tensor, and a
leaf the step leaves alone is the input tensor itself.
"""

import ctypes
import functools
import math

import torch

from ..ops import epilogue as _ep
from ..ops.epilogue import finish_plain, supervise_plain, track_plain
from .launch import launch

__all__ = ["finish", "supervise", "track", "F32_ROWS", "I32_ROWS",
           "BOOL_ROWS"]

# flags (csrc/epilogue.cu)
_FINISH, _SUPERVISE, _FREEZE, _WBTRACK = 1, 2, 4, 8
_CALC_ANGLES, _RETRY, _SMOOTHING, _HEAD_POSITION = 16, 32, 64, 128
_FOV, _EDGE, _SEND_EVENTS, _ESCAPED, _DIRTY = 256, 512, 1024, 2048, 4096
# the kernel's output rows, in its order
F32_ROWS = ("track_angle", "face_x", "face_y", "face_w", "face_h",
            "face_angle", "face_conf", "wb", "smooth_x", "smooth_y",
            "smooth_w", "smooth_h", "head_x", "head_y", "head_z", "fov_deg",
            "tan_fov", "fov_width", "head_diag_cam")
I32_ROWS = ("track_x", "track_y", "track_w", "track_h", "detection",
            "status", "mode_after", "diag_n")
BOOL_ROWS = ("head_valid", "event_face", "escaped", "esc", "sm_init",
             "face_found", "first_run", "headpose_active", "stopped")
_CONSTS = ("alpha", "offset", "fov_rad", "distance", "rad2deg", "camw",
           "camh", "sin", "cos", "tan", "diag_cm", "pi", "half_pi",
           "margin", "width_cm", "growth")
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


class _Plane(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """csrc/epilogue.cu's Args, field for field."""
    _fields_ = [("mode_in", _Plane), ("mode", _Plane), ("res", _Plane * 7),
                ("esc", _Plane), ("dirty", _Plane), ("win", _Plane),
                ("mom", _Plane * 4), ("zero_mass", _Plane),
                ("old_win", _Plane), ("old_track", _Plane * 4),
                ("old_angle", _Plane), ("first_run", _Plane),
                ("face_found", _Plane), ("sm_init", _Plane),
                ("headpose_active", _Plane), ("stopped", _Plane),
                ("sm_sp", _Plane), ("diag_ring", _Plane), ("diag_n", _Plane),
                ("tan_fov", _Plane), ("fov_width", _Plane),
                ("head_diag_cam", _Plane),
                ("of", ctypes.c_void_p * len(F32_ROWS)),
                ("oi", ctypes.c_void_p * len(I32_ROWS)),
                ("ob", ctypes.c_void_p * len(BOOL_ROWS)),
                ("sm_sp_out", ctypes.c_void_p), ("ring_out", ctypes.c_void_p),
                ("win_out", ctypes.c_void_p),
                ("k", ctypes.c_float * len(_CONSTS))]


@functools.lru_cache(maxsize=1)
def _checked_layout():
    """Raise unless the library's Args is this module's (once)."""
    from .build import load_library
    got = load_library().fn("tick_epilogue_args_bytes")()
    if got != ctypes.sizeof(_Args):
        raise RuntimeError(f"tick_epilogue's Args is {got} bytes, the "
                           f"wrapper's {ctypes.sizeof(_Args)}")


def _on_cuda(*tensors):
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else raises.  (Any strides: the kernel reads
    each input where it lies.)"""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def _plane(t, keep):
    """An input's (base, stride between streams); a 2-D input whose rows
    are not dense is copied first (kept alive in ``keep``)."""
    if t.dim() == 2 and t.stride(1) != 1:
        t = t.contiguous()
        keep.append(t)
    return _Plane(t.data_ptr(), t.stride(0))


def _consts(ep, H, W):
    k = dict(camw=float(W), camh=float(H), sin=_ep.SIN_HSA, cos=_ep.COS_HSA,
             tan=_ep.TAN_HSA, diag_cm=_ep.HEAD_DIAG_CM, pi=math.pi,
             half_pi=math.pi / 2, margin=_ep.EDGE_MARGIN,
             width_cm=_ep.HEAD_WIDTH_CM, growth=1.1, rad2deg=180.0 / math.pi)
    if ep is not None:
        k.update(alpha=ep.alpha, offset=ep.camera_offset,
                 distance=ep.distance,
                 fov_rad=0.0 if ep.fov is None else ep.fov * math.pi / 180.0)
    return (ctypes.c_float * len(_CONSTS))(*(k.get(c, 0.0) for c in _CONSTS))


def _flags(ep):
    return ((_CALC_ANGLES if ep.calc_angles else 0)
            | (_RETRY if ep.retry else 0)
            | (_SMOOTHING if ep.smoothing else 0)
            | (_HEAD_POSITION if ep.head_position else 0)
            | (_FOV if ep.fov is not None else 0)
            | (_EDGE if ep.edgecorrection else 0)
            | (_SEND_EVENTS if ep.send_events else 0))


def _outputs(a, n, dev, f32, i32, bools):
    """Allocate the named rows (one tensor a dtype) and point ``a``'s
    output rows at them: {name: (n,) tensor}."""
    rows = {}
    for names, order, dt, table in ((f32, F32_ROWS, _F32, a.of),
                                    (i32, I32_ROWS, _I32, a.oi),
                                    (bools, BOOL_ROWS, _BOOL, a.ob)):
        block = torch.empty((len(names), n), dtype=dt, device=dev)
        base, pitch = block.data_ptr(), n * block.element_size()
        for j, (name, row) in enumerate(zip(names, block.unbind(0))):
            rows[name] = row
            table[order.index(name)] = base + j * pitch
    return rows


def _launch(a, n, flags, dev):
    with torch.cuda.device(dev):
        _checked_layout()
        if n:
            launch("tick_epilogue", "tick_epilogue_launch",
                   ctypes.addressof(a), n, flags)


def _set_finish(a, win, m, zero_mass, keep):
    a.win = _plane(win, keep)
    for j, name in enumerate(("mu20", "mu02", "mu11", "invM00")):
        a.mom[j] = _plane(m[name], keep)
    a.zero_mass = _plane(zero_mass, keep)


def _check_finish(win, m, zero_mass):
    N = win.shape[0]
    if win.dtype != _I32 or tuple(win.shape) != (N, 4):
        raise ValueError(f"win must be (N, 4) int32, got "
                         f"{tuple(win.shape)} {win.dtype}")
    for name in ("mu20", "mu02", "mu11", "invM00"):
        t = m[name]
        if t.dtype != _F32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be ({N},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if zero_mass.dtype != _BOOL or tuple(zero_mass.shape) != (N,):
        raise ValueError(f"zero_mass must be a ({N},) bool mask")


def finish(win, m, zero_mass, calc_angles, H, W):
    """Camshift's size, orientation, output box and window growth:
    ``ops.epilogue.finish_plain``'s contract (win (N, 4) i32, moments
    mu20, mu02, mu11, invM00 (N,) f32, zero_mass (N,) bool).  Returns
    (window (N, 4) i32, track_x, track_y, track_w, track_h (N,) i32,
    track_angle (N,) f32)."""
    _check_finish(win, m, zero_mass)
    names = ("mu20", "mu02", "mu11", "invM00")
    if not _on_cuda(win, zero_mass, *(m[k] for k in names)):
        return finish_plain(win, m, zero_mass, calc_angles, H, W)
    N, dev = win.shape[0], win.device
    a, keep = _Args(), []
    _set_finish(a, win, m, zero_mass, keep)
    rows = _outputs(a, N, dev, ("track_angle",), I32_ROWS[:4], ())
    window = torch.empty((N, 4), dtype=_I32, device=dev)
    a.win_out = window.data_ptr()
    a.k = _consts(None, H, W)
    _launch(a, N, _FINISH | (_CALC_ANGLES if calc_angles else 0), dev)
    return (window, rows["track_x"], rows["track_y"], rows["track_w"],
            rows["track_h"], rows["track_angle"])


def _supervision(a, state, entry_mode, ep, keep, escaped, finished):
    """Point ``a`` at the state leaves the supervision reads and allocate
    its outputs (with the finish's when ``finished``; the escaped flags'
    when ``escaped`` is given): (flags, rows, sm_sp, diag_ring)."""
    N, dev = entry_mode.shape[0], entry_mode.device
    a.mode_in = _plane(entry_mode, keep)
    for name in ("first_run", "face_found", "sm_init", "headpose_active",
                 "stopped", "sm_sp", "diag_ring", "diag_n", "tan_fov",
                 "fov_width", "head_diag_cam"):
        setattr(a, name, _plane(getattr(state, name), keep))
    flags = _SUPERVISE | _flags(ep)
    bools = ["head_valid", "event_face", "escaped", "face_found",
             "first_run", "headpose_active"]
    if escaped is not None:
        a.esc = _plane(escaped, keep)
        bools.append("esc")
        flags |= _ESCAPED
    if ep.smoothing:
        bools.append("sm_init")
    if not ep.retry:
        bools.append("stopped")
    rows = _outputs(a, N, dev, F32_ROWS if finished else F32_ROWS[8:],
                    I32_ROWS if finished else I32_ROWS[4:], bools)
    sm_sp = state.sm_sp
    if ep.smoothing:
        sm_sp = torch.empty((N, 5), dtype=_F32, device=dev)
        a.sm_sp_out = sm_sp.data_ptr()
    ring = torch.empty((N, 6), dtype=_F32, device=dev)
    a.ring_out = ring.data_ptr()
    a.k = _consts(ep, ep.H, ep.W)
    return flags, rows, sm_sp, ring


def _results(state, rows, sm_sp, ring, ep, res):
    """(state', the StepOutput's fields) from the kernel's rows; ``res``
    the result fields (x, y, w, h, angle, conf, wb) the output reports."""
    new_state = state._replace(
        mode=rows["mode_after"], sm_sp=sm_sp,
        sm_init=rows["sm_init"] if ep.smoothing else state.sm_init,
        face_found=rows["face_found"], first_run=rows["first_run"],
        diag_ring=ring, diag_n=rows["diag_n"],
        headpose_active=rows["headpose_active"], tan_fov=rows["tan_fov"],
        fov_width=rows["fov_width"], head_diag_cam=rows["head_diag_cam"],
        stopped=state.stopped if ep.retry else rows["stopped"])
    x, y, w, h, angle, conf, wb = res
    out = dict(
        detection=rows["detection"], wb=wb, face_x=x, face_y=y, face_w=w,
        face_h=h, face_angle=angle, face_conf=conf,
        **{k: rows[k] for k in ("smooth_x", "smooth_y", "smooth_w",
                                "smooth_h", "head_valid", "head_x",
                                "head_y", "head_z", "status", "event_face",
                                "fov_deg", "mode_after", "escaped")})
    return new_state, out


def supervise(state, entry_mode, res, ep, variant="full", escaped=None):
    """The supervision after a step's mode branches:
    ``ops.epilogue.supervise_plain``'s contract (state the merged
    TrackerState, entry_mode (N,) i32, res the merged result with fields
    x, y, w, h, angle, conf, wb (N,) f32, ep an Epilogue, variant one of
    ops.epilogue.VARIANTS, escaped (N,) bool or None).  Returns (state',
    the StepOutput's fields, escaped & in CS or None)."""
    if variant not in _ep.VARIANTS:
        raise ValueError(f"variant must be one of {_ep.VARIANTS}, got "
                         f"{variant!r}")
    fields = (res.x, res.y, res.w, res.h, res.angle, res.conf, res.wb)
    if not _on_cuda(entry_mode, state.mode, escaped, *fields):
        return supervise_plain(state, entry_mode, res, ep, variant, escaped)
    a, keep = _Args(), []
    flags, rows, sm_sp, ring = _supervision(a, state, entry_mode, ep, keep,
                                            escaped, False)
    a.mode = _plane(state.mode, keep)
    for j, t in enumerate(fields):
        a.res[j] = _plane(t, keep)
    flags |= {"track": _FREEZE, "wbtrack": _WBTRACK}.get(variant, 0)
    _launch(a, entry_mode.shape[0], flags, entry_mode.device)
    new_state, out = _results(state, rows, sm_sp, ring, ep, fields)
    return new_state, out, rows.get("esc")


def track(state, win, m, zero_mass, escaped, dirty, ep):
    """The "track" step's end from the mean shift's outputs, one launch:
    ``ops.epilogue.track_plain``'s contract (win (N, 4) i32, moments,
    zero_mass (N,) bool, escaped (N,) bool or None off the band, dirty
    band_dirty to OR into it or None).  Returns (state', the StepOutput's
    fields, escaped & in CS or None)."""
    _check_finish(win, m, zero_mass)
    names = ("mu20", "mu02", "mu11", "invM00")
    if not _on_cuda(win, zero_mass, state.mode, escaped,
                    *(m[k] for k in names)):
        return track_plain(state, win, m, zero_mass, escaped, dirty, ep)
    N, dev = win.shape[0], win.device
    a, keep = _Args(), []
    _set_finish(a, win, m, zero_mass, keep)
    old = state.cs
    a.old_win = _plane(old.window, keep)
    for j, t in enumerate((old.track_x, old.track_y, old.track_w,
                           old.track_h)):
        a.old_track[j] = _plane(t, keep)
    a.old_angle = _plane(old.track_angle, keep)
    flags, rows, sm_sp, ring = _supervision(a, state, state.mode, ep, keep,
                                            escaped, True)
    window = torch.empty((N, 4), dtype=_I32, device=dev)
    a.win_out = window.data_ptr()
    if escaped is not None and dirty is not None:
        a.dirty = _plane(dirty, keep)
        flags |= _DIRTY
    _launch(a, N, flags | _FINISH | _FREEZE, dev)
    cs = old._replace(window=window, track_x=rows["track_x"],
                      track_y=rows["track_y"], track_w=rows["track_w"],
                      track_h=rows["track_h"],
                      track_angle=rows["track_angle"])
    res = tuple(rows[k] for k in ("face_x", "face_y", "face_w", "face_h",
                                  "face_angle", "face_conf", "wb"))
    new_state, out = _results(state._replace(cs=cs), rows, sm_sp, ring, ep,
                              res)
    return new_state, out, rows.get("esc")
