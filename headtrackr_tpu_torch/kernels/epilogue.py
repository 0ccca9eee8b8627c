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
columns are read in place); the outputs are rows of one fresh block (each
row at a place fixed by the batch size, whichever a form writes), and a
leaf the step leaves alone is the input tensor itself.

A call's argument block is built once per (form, flags, configuration,
batch size) and kept (``_call``): a call writes only its inputs' bases and
strides and its output block's addresses into it, then launches.
"""

import ctypes
import functools
import math
import struct
import threading

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
# the kernel's inputs (Args::in), in its order: (name, planes)
_INPUTS = (("mode_in", 1), ("mode", 1), ("res", 7), ("esc", 1),
           ("dirty", 1), ("win", 1), ("mom", 4), ("zero_mass", 1),
           ("old_win", 1), ("old_track", 4), ("old_angle", 1),
           ("first_run", 1), ("face_found", 1), ("sm_init", 1),
           ("headpose_active", 1), ("stopped", 1), ("sm_sp", 1),
           ("diag_ring", 1), ("diag_n", 1), ("tan_fov", 1),
           ("fov_width", 1), ("head_diag_cam", 1))
_IN, _N_IN = {}, 0  # each group's first plane; the planes in all
for _name, _k in _INPUTS:
    _IN[_name], _N_IN = _N_IN, _N_IN + _k
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
_MOMENTS = ("mu20", "mu02", "mu11", "invM00")
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


class _Plane(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """csrc/epilogue.cu's Args, field for field."""
    _fields_ = [("inputs", _Plane * _N_IN), ("out", ctypes.c_void_p),
                ("k", ctypes.c_float * len(_CONSTS))]


# the output block of n streams (csrc/epilogue.cu Out): (dtype, rows,
# columns) regions in order, each rows x n x columns elements
_REGIONS = ((_F32, len(F32_ROWS), 1), (_I32, len(I32_ROWS), 1),
            (_F32, 1, 5), (_F32, 1, 6), (_I32, 1, 4),
            (_BOOL, len(BOOL_ROWS), 1))
_OUT_BYTES_A_STREAM = 4 * (len(F32_ROWS) + len(I32_ROWS) + 15) + len(
    BOOL_ROWS)


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


class _Call:
    """One (form, flags, configuration, batch size)'s launch: its argument
    block (the constants set, the inputs it reads named by ``inputs``) and
    the rows of the output block it returns."""

    def __init__(self, n, flags, inputs, ep, H, W, f32, i32, bools, sm_sp,
                 ring, window):
        self.n, self.flags = n, flags
        self.args = _Args()
        self.args.k = _consts(ep, H, W)
        # the inputs' (base, stride) words and the output block's address,
        # written by one struct.pack_into (the words between them skipped)
        words, fmt, at = sorted(inputs) + [_N_IN], "<", 0
        for q in words:
            fmt += f"{8 * (2 * q - at)}x" if 2 * q > at else ""
            fmt += "qq" if q < _N_IN else "q"
            at = 2 * q + 2
        self.pack = struct.Struct(fmt).pack_into
        self.lock = threading.Lock()  # one block, written then launched
        self.order = sorted(range(len(inputs)), key=inputs.__getitem__)
        # the inputs read as (N, k) rows: a view whose rows are not dense is
        # copied first
        self.wide = [j for j, q in enumerate(inputs)
                     if q in (_IN["win"], _IN["old_win"], _IN["sm_sp"],
                              _IN["diag_ring"])]
        self.bytes = -(-_OUT_BYTES_A_STREAM * n // 16) * 16
        # the output block's regions: (start, end, dtype, rows or (n,
        # width), row names or None) of those this form returns
        self.regions, at = [], 0
        for (dt, nrows, width), names, order in zip(
                _REGIONS, (f32, i32, sm_sp, ring, window, bools),
                (F32_ROWS, I32_ROWS, None, None, None, BOOL_ROWS)):
            size = nrows * width * n * (1 if dt == _BOOL else 4)
            if order is not None and names:
                self.regions.append((at, at + size, dt, (nrows, n), names,
                                     [order.index(k) for k in names]))
            elif order is None and names:
                self.regions.append((at, at + size, dt, (n, width), None,
                                     None))
            at += size

    def __call__(self, inputs, dev):
        """Launch on ``inputs`` (the tensors of the inputs named at
        construction, in order); returns ({row name: (n,) tensor}, [sm_sp,
        ring, window] as constructed)."""
        keep = []
        for j in self.wide:
            if inputs[j].stride(1) != 1:  # rows read as a whole
                keep.append(inputs[j].contiguous())
                inputs = (*inputs[:j], keep[-1], *inputs[j + 1:])
        block = torch.empty((self.bytes,), dtype=torch.uint8, device=dev)
        words = [v for j in self.order
                 for v in (inputs[j].data_ptr(), inputs[j].stride(0))]
        if self.n:
            with self.lock:
                self.pack(self.args, 0, *words, block.data_ptr())
                if dev.index != torch.cuda.current_device():
                    with torch.cuda.device(dev):
                        self._launch()
                else:
                    self._launch()
        rows, leaves = {}, []
        for a, b, dt, shape, names, idx in self.regions:
            t = block.narrow(0, a, b - a).view(dt).view(shape)
            if names is None:
                leaves.append(t)
            else:
                t = t.unbind(0)
                rows.update(zip(names, [t[j] for j in idx]))
        return rows, leaves

    def _launch(self):
        _checked_layout()
        launch("tick_epilogue", "tick_epilogue_launch",
               ctypes.addressof(self.args), self.n, self.flags)


@functools.lru_cache(maxsize=256)
def _call(*key):
    return _Call(*key)


def _check_finish(win, m, zero_mass):
    N = win.shape[0]
    if win.dtype != _I32 or tuple(win.shape) != (N, 4):
        raise ValueError(f"win must be (N, 4) int32, got "
                         f"{tuple(win.shape)} {win.dtype}")
    for name in _MOMENTS:
        t = m[name]
        if t.dtype != _F32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be ({N},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if zero_mass.dtype != _BOOL or tuple(zero_mass.shape) != (N,):
        raise ValueError(f"zero_mass must be a ({N},) bool mask")


def _ids(*names):
    """The kernel's input indices of ``names`` (a plane group by its
    first name, e.g. "mom": its four planes)."""
    out = []
    for name in names:
        k = dict(_INPUTS)[name]
        out += range(_IN[name], _IN[name] + k)
    return tuple(out)


_FINISH_IN = _ids("win", "mom", "zero_mass")
_STATE_LEAVES = ("first_run", "face_found", "sm_init", "headpose_active",
                 "stopped", "sm_sp", "diag_ring", "diag_n", "tan_fov",
                 "fov_width", "head_diag_cam")
_SUPERVISE_IN = _ids("mode_in", *_STATE_LEAVES)
_ESC_IN, _DIRTY_IN = _ids("esc"), _ids("dirty")
_RESULT_IN = _ids("mode", "res")
_TRACK_IN = _FINISH_IN + _ids("old_win", "old_track", "old_angle")


def finish(win, m, zero_mass, calc_angles, H, W):
    """Camshift's size, orientation, output box and window growth:
    ``ops.epilogue.finish_plain``'s contract (win (N, 4) i32, moments
    mu20, mu02, mu11, invM00 (N,) f32, zero_mass (N,) bool).  Returns
    (window (N, 4) i32, track_x, track_y, track_w, track_h (N,) i32,
    track_angle (N,) f32)."""
    _check_finish(win, m, zero_mass)
    moments = [m[k] for k in _MOMENTS]
    if not _on_cuda(win, zero_mass, *moments):
        return finish_plain(win, m, zero_mass, calc_angles, H, W)
    call = _call(win.shape[0], _FINISH | (_CALC_ANGLES if calc_angles
                                          else 0),
                 _FINISH_IN, None, H, W, ("track_angle",), I32_ROWS[:4], (),
                 False, False, True)
    rows, (window,) = call((win, *moments, zero_mass), win.device)
    return (window, rows["track_x"], rows["track_y"], rows["track_w"],
            rows["track_h"], rows["track_angle"])


def _supervision(state, entry_mode, ep, escaped, finished, variant_flags,
                 extra_in):
    """The launch of a supervision form: (the call, its input tensors
    before ``extra_in``'s).  ``finished``: the finish's outputs too;
    ``escaped`` given: its flags' output too."""
    flags = _SUPERVISE | _flags(ep) | variant_flags
    bools = ["head_valid", "event_face", "escaped", "face_found",
             "first_run", "headpose_active"]
    ins = _SUPERVISE_IN
    tensors = [entry_mode, *(getattr(state, k) for k in _STATE_LEAVES)]
    if escaped is not None:
        bools.append("esc")
        flags |= _ESCAPED
        ins += _ESC_IN
        tensors.append(escaped)
    if ep.smoothing:
        bools.append("sm_init")
    if not ep.retry:
        bools.append("stopped")
    call = _call(entry_mode.shape[0], flags, ins + extra_in, ep, ep.H, ep.W,
                 F32_ROWS if finished else F32_ROWS[8:],
                 I32_ROWS if finished else I32_ROWS[4:], tuple(bools),
                 ep.smoothing, True, finished)
    return call, tensors


def _results(state, rows, sm_sp, ring, ep, res):
    """(state', the StepOutput's fields) from the kernel's rows; ``res``
    the result fields (x, y, w, h, angle, conf, wb) the output reports."""
    new_state = state._replace(
        mode=rows["mode_after"], sm_sp=sm_sp if ep.smoothing else state.sm_sp,
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
    call, tensors = _supervision(
        state, entry_mode, ep, escaped, False,
        {"track": _FREEZE, "wbtrack": _WBTRACK}.get(variant, 0),
        _RESULT_IN)
    rows, leaves = call((*tensors, state.mode, *fields), entry_mode.device)
    sm_sp, ring = (leaves if ep.smoothing else (None, *leaves))
    new_state, out = _results(state, rows, sm_sp, ring, ep, fields)
    return new_state, out, rows.get("esc")


def track(state, win, m, zero_mass, escaped, dirty, ep):
    """The "track" step's end from the mean shift's outputs, one launch:
    ``ops.epilogue.track_plain``'s contract (win (N, 4) i32, moments,
    zero_mass (N,) bool, escaped (N,) bool or None off the band, dirty
    band_dirty to OR into it or None).  Returns (state', the StepOutput's
    fields, escaped & in CS or None)."""
    _check_finish(win, m, zero_mass)
    moments = [m[k] for k in _MOMENTS]
    if not _on_cuda(win, zero_mass, state.mode, escaped, *moments):
        return track_plain(state, win, m, zero_mass, escaped, dirty, ep)
    old = state.cs
    extra = _TRACK_IN
    tail = [win, *moments, zero_mass, old.window, old.track_x, old.track_y,
            old.track_w, old.track_h, old.track_angle]
    flags = _FINISH | _FREEZE
    if escaped is not None and dirty is not None:
        extra += _DIRTY_IN
        tail.append(dirty)
        flags |= _DIRTY
    call, tensors = _supervision(state, state.mode, ep, escaped, True, flags,
                                 extra)
    rows, leaves = call((*tensors, *tail), win.device)
    if ep.smoothing:
        sm_sp, ring, window = leaves
    else:
        sm_sp, (ring, window) = None, leaves
    cs = old._replace(window=window, track_x=rows["track_x"],
                      track_y=rows["track_y"], track_w=rows["track_w"],
                      track_h=rows["track_h"],
                      track_angle=rows["track_angle"])
    res = tuple(rows[k] for k in ("face_x", "face_y", "face_w", "face_h",
                                  "face_angle", "face_conf", "wb"))
    new_state, out = _results(state._replace(cs=cs), rows, sm_sp, ring, ep,
                              res)
    return new_state, out, rows.get("esc")
