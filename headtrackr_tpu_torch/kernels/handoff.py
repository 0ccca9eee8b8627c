"""Wrapper of the ``handoff`` CUDA kernel (``csrc/handoff.cu``).

  handoff  replaces headtrackr_tpu/models/camshift.py:133 init_tracker
           with :113 handoff_band_audit, and the handoff of
           headtrackr_tpu/models/facetracker.py:197-216 (the switch, the
           floored rect, the select of the new camshift state, the mode)

Dispatch as the other wrappers: CPU tensors take the plain twin
(ops/handoff.py ``handoff_plain``), CUDA tensors launch the kernel, one
launch a call; any other device raises, and so does a failed build or
launch.  The kernel equals the twin to the bit.

The kernel spreads each stream over a cluster of P CTAs (``pick_split``,
frame_prep's rule; ``split=`` forces it): the rect's rows, the histogram's
bins and the audit's frame rows split over them; the twin takes the same
split.  It reads its frames in place under ``launch.frames_at``
(``launch.frames_of``), at any address.
"""

import ctypes
import functools

import torch

from ..ops.handoff import handoff_plain
from ..ops.histogram import NBINS
from .frameprep import MAX_SPLIT, pick_split, resolve_split
from .launch import frames_of, launch

__all__ = ["handoff", "pick_split", "MAX_SPLIT"]

_F32, _I32 = torch.float32, torch.int32


class _Plane(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """csrc/handoff.cu's Args, field for field."""
    _fields_ = [("frames", ctypes.c_void_p), ("frame_at", ctypes.c_void_p),
                ("n", ctypes.c_longlong),
                ("h", ctypes.c_longlong), ("w", ctypes.c_longlong),
                ("slots", ctypes.c_void_p), ("rect", ctypes.c_void_p),
                ("found", _Plane), ("x", _Plane), ("y", _Plane),
                ("bw", _Plane), ("bh", _Plane), ("conf", _Plane),
                ("entry_mode", ctypes.c_void_p), ("mode_in", ctypes.c_void_p),
                ("mode_out", ctypes.c_void_p), ("old_hist", ctypes.c_void_p),
                ("old_win", ctypes.c_void_p),
                ("old_track", ctypes.c_void_p * 4),
                ("old_angle", ctypes.c_void_p), ("old_dirty", ctypes.c_void_p),
                ("hist", ctypes.c_void_p), ("win", ctypes.c_void_p),
                ("track", ctypes.c_void_p * 4), ("angle", ctypes.c_void_p),
                ("dirty", ctypes.c_void_p), ("res", ctypes.c_void_p * 6),
                ("band_h", ctypes.c_int), ("band_w", ctypes.c_int)]


@functools.lru_cache(maxsize=1)
def _checked_layout():
    """Raise unless the library's Args is this module's (once)."""
    from .build import load_library
    got = load_library().fn("handoff_args_bytes")()
    if got != ctypes.sizeof(_Args):
        raise RuntimeError(f"handoff's Args is {got} bytes, the wrapper's "
                           f"{ctypes.sizeof(_Args)}")


def _devices(tensors):
    """True for one CUDA device, False for the CPU; anything else raises
    (a CUDA tensor must be contiguous, but for 1-D detection inputs, which
    the kernel reads at their stride)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cuda"


def _band(band):
    if band is None:
        return None
    bh, bw = int(band[0]), int(band[1])
    if bh < 1 or bw < 1:
        raise ValueError(f"band must be positive, got {band}")
    return bh, bw


def _check(frames, slots, s):
    if frames.dtype != torch.uint8 or frames.dim() != 4 or \
            frames.shape[3] != 3 or frames.shape[0] < 1:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if slots is not None and (slots.dtype != torch.int64 or
                              tuple(slots.shape) != (s,)):
        raise ValueError(f"slots must be ({s},) int64")
    if slots is None and s != frames.shape[0]:
        raise ValueError("without slots the rows are the frames' streams")


def handoff(frames, slots=None, rect=None, det=None, entry_mode=None,
            mode=None, old=None, band=None, split=None):
    """``ops.handoff.handoff_plain``'s contract: the init form (``rect``
    (S, 4) i32; returns the camshift leaves) or the handoff form (``det``
    = (found, x, y, w, h, conf) (S,), entry_mode and mode (S,) i32, old
    the rows' camshift leaves in ``CamshiftState``'s order; returns
    (leaves, mode', (x, y, w, h, angle, conf))).  frames (N, H, W, 3) u8
    read through ``slots`` (S,) i64 padded with N (None: every stream);
    band=(bh, bw): the audit, band_dirty among the leaves; ``split`` the
    CTAs a stream (None: ``pick_split``'s).  Reads its frames in place
    under ``launch.frames_at``."""
    init = det is None
    s = rect.shape[0] if init else entry_mode.shape[0]
    _check(frames, slots, s)
    if init and (rect.dtype != _I32 or tuple(rect.shape) != (s, 4)):
        raise ValueError(f"rect must be ({s}, 4) int32, got "
                         f"{tuple(rect.shape)} {rect.dtype}")
    if not init and (len(det) != 6 or any(t.shape != (s,) for t in det)
                     or det[0].dtype != torch.bool
                     or any(t.dtype != _F32 for t in det[1:])
                     or entry_mode.dtype != _I32 or mode.dtype != _I32
                     or mode.shape != (s,)):
        raise ValueError("the handoff form takes (found bool, x, y, w, h, "
                         "conf f32) (S,) and (S,) i32 entry_mode and mode")
    if not init and band is not None and old[7] is None:
        raise ValueError("the audit needs the rows' band_dirty")
    band = _band(band)
    inputs = [frames, slots, rect] + ([] if init else [*det, entry_mode,
                                                        mode,
                                                        *old])
    cuda = _devices(inputs)
    dev = frames.device
    split = resolve_split(split, s, dev, cuda)
    frames, at = frames_of(frames, cuda)
    if not cuda:
        return handoff_plain(frames, slots, rect, det, entry_mode, mode, old,
                             band, split)
    N, H, W, _ = frames.shape
    keep = []

    def dense(t):
        if t is None:
            return 0
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        return t.data_ptr()

    if not frames.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    hist = torch.empty((s, NBINS), dtype=_F32, device=dev)
    win = torch.empty((s, 4), dtype=_I32, device=dev)
    track = torch.empty((4, s), dtype=_I32, device=dev)
    angle = torch.empty((s,), dtype=_F32, device=dev)
    dirty = torch.empty((s,), dtype=torch.bool, device=dev) \
        if band is not None else None
    a = _Args(frames.data_ptr(), at, N, H, W, dense(slots), dense(rect))
    a.hist, a.win, a.angle, a.dirty = (hist.data_ptr(), win.data_ptr(),
                                       angle.data_ptr(), dense(dirty))
    for j in range(4):
        a.track[j] = track[j].data_ptr()
    if band is not None:
        a.band_h, a.band_w = band
    res = mode_out = None
    if not init:
        for name, t in zip(("found", "x", "y", "bw", "bh", "conf"), det):
            setattr(a, name, _Plane(t.data_ptr(), t.stride(0)))
        res = torch.empty((6, s), dtype=_F32, device=dev)
        mode_out = torch.empty((s,), dtype=_I32, device=dev)
        a.entry_mode, a.mode_in = dense(entry_mode), dense(mode)
        a.mode_out = mode_out.data_ptr()
        a.old_hist, a.old_win = dense(old[0]), dense(old[1])
        for j in range(4):
            a.old_track[j] = dense(old[2 + j])
        a.old_angle = dense(old[6])
        a.old_dirty = dense(old[7]) if band is not None else 0
        for j in range(6):
            a.res[j] = res[j].data_ptr()
    with torch.cuda.device(dev):
        _checked_layout()
        if s:
            launch("handoff", "handoff_launch", ctypes.addressof(a), s,
                   split)
    leaves = (hist, win, *track.unbind(0), angle, dirty)
    if init:
        return leaves
    return leaves, mode_out, tuple(res.unbind(0))
