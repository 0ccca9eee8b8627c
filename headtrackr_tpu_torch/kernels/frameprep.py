"""Wrapper of the ``frame_prep`` CUDA kernel (``csrc/frameprep.cu``).

  frame_prep  replaces headtrackr_tpu/ops/imageproc.py:35 grayscale, :43
              whitebalance and the WB branch of headtrackr_tpu/models/
              facetracker.py:186-195, in one pass over each served
              stream's frame

Dispatch as the other wrappers: CPU tensors take the plain twin
(ops/imageproc.py ``frame_prep_plain``), CUDA tensors launch the kernel,
one launch a call; any other device raises, and so does a failed build or
launch.  The kernel equals the twin to the bit.

The kernel spreads each stream's frame over a cluster of P CTAs
(``pick_split``; ``split=`` forces it) and joins their exact channel sums
in the cluster's first CTA; the twin takes the same split.  It reads its
frames in place under ``launch.frames_at`` (``launch.frames_of``), at any
address: each CTA takes the widest loads that the address it reads
allows.
"""

import ctypes
import functools

import torch

from ..ops.imageproc import PWB_LENGTH, frame_prep_plain
from .launch import frames_of, launch, on_cuda, sm_count
from .meanshift import H100

__all__ = ["frame_prep", "pick_split", "resolve_split", "MAX_SPLIT"]

MAX_SPLIT = 16  # CTAs a stream: a cluster of 16 is past the portable 8


def pick_split(streams, sms=None):
    """CTAs a stream (P, a power of two <= MAX_SPLIT) of a launch over
    ``streams`` streams on a card of ``sms`` SMs (None: an H100's 132):
    about two CTAs an SM over the whole launch, so the relock bucket's 8
    slots take 16 each and any launch past 132 streams (the wbtrack and
    full ticks at serving widths) one."""
    sms = H100.sms if sms is None else sms
    p = max(1, min(MAX_SPLIT, 2 * sms // max(streams, 1)))
    return 1 << (p.bit_length() - 1)


def resolve_split(split, s, dev, cuda):
    """The launch's P: ``split`` where given (a power of two <= 16 on the
    card, any P >= 1 for the twin), else ``pick_split`` for the card's
    SMs."""
    if split is None:
        return pick_split(s, sm_count(dev) if cuda else None)
    split = int(split)
    if split < 1 or (cuda and (split > MAX_SPLIT or split & (split - 1))):
        raise ValueError(f"split must be a power of two <= {MAX_SPLIT} on "
                         f"the card (any P >= 1 for the twin), got {split}")
    return split


class _Args(ctypes.Structure):
    """csrc/frameprep.cu's Args, field for field."""
    _fields_ = [("frames", ctypes.c_void_p), ("frame_at", ctypes.c_void_p),
                ("n", ctypes.c_longlong),
                ("h", ctypes.c_longlong), ("w", ctypes.c_longlong),
                ("slots", ctypes.c_void_p), ("mode", ctypes.c_void_p),
                ("ring", ctypes.c_void_p), ("wb_n", ctypes.c_void_p),
                ("gray", ctypes.c_void_p), ("wb", ctypes.c_void_p),
                ("ring_out", ctypes.c_void_p), ("wb_n_out", ctypes.c_void_p),
                ("mode_out", ctypes.c_void_p), ("wb_vj", ctypes.c_int)]


@functools.lru_cache(maxsize=1)
def _checked_layout():
    """Raise unless the library's Args is this module's (once)."""
    from .build import load_library
    got = load_library().fn("frame_prep_args_bytes")()
    if got != ctypes.sizeof(_Args):
        raise RuntimeError(f"frame_prep's Args is {got} bytes, the "
                           f"wrapper's {ctypes.sizeof(_Args)}")


def _check(frames, slots, mode, wb_ring, wb_n):
    if frames.dtype != torch.uint8 or frames.dim() != 4 or \
            frames.shape[3] != 3 or frames.shape[0] < 1:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    s = mode.shape[0]
    if slots is not None and (slots.dtype != torch.int64 or
                              tuple(slots.shape) != (s,)):
        raise ValueError(f"slots must be ({s},) int64")
    if slots is None and s != frames.shape[0]:
        raise ValueError("without slots the rows are the frames' streams")
    for name, t, dt, shape in (("mode", mode, torch.int32, (s,)),
                               ("wb_ring", wb_ring, torch.float32,
                                (s, PWB_LENGTH)),
                               ("wb_n", wb_n, torch.int32, (s,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def frame_prep(frames, slots, mode, wb_ring, wb_n, gray=True, wb_vj=False,
               split=None):
    """``ops.imageproc.frame_prep_plain``'s contract: frames (N, H, W, 3)
    u8 read through ``slots`` (S,) i64 padded with N (None: every
    stream); mode, wb_ring, wb_n the S rows' state; ``split`` the CTAs a
    stream (None: ``pick_split``'s).  Returns (gray (S, H, W) u8 or None,
    wb (S,) f32, wb_ring' (S, 15) f32, wb_n' (S,) i32, mode' (S,) i32).
    Reads its frames in place under ``launch.frames_at``."""
    _check(frames, slots, mode, wb_ring, wb_n)
    tensors = [frames, mode, wb_ring, wb_n] + ([] if slots is None
                                               else [slots])
    cuda = on_cuda(*tensors)
    S, dev = mode.shape[0], frames.device
    split = resolve_split(split, S, dev, cuda)
    frames, at = frames_of(frames, cuda)
    if not cuda:
        return frame_prep_plain(frames, slots, mode, wb_ring, wb_n, gray,
                                wb_vj, split)
    N, H, W, _ = frames.shape
    g = torch.empty((S, H, W), dtype=torch.uint8, device=dev) if gray \
        else None
    wb = torch.empty((S,), dtype=torch.float32, device=dev)
    ring = torch.empty((S, PWB_LENGTH), dtype=torch.float32, device=dev)
    n = torch.empty((S,), dtype=torch.int32, device=dev)
    mode_out = torch.empty((S,), dtype=torch.int32, device=dev)
    a = _Args(frames.data_ptr(), at, N, H, W,
              0 if slots is None else slots.data_ptr(), mode.data_ptr(),
              wb_ring.data_ptr(), wb_n.data_ptr(),
              0 if g is None else g.data_ptr(), wb.data_ptr(),
              ring.data_ptr(), n.data_ptr(), mode_out.data_ptr(),
              int(bool(wb_vj)))
    with torch.cuda.device(dev):
        _checked_layout()
        if S:
            launch("frame_prep", "frame_prep_launch", ctypes.addressof(a), S,
                   split)
    return g, wb, ring, n, mode_out
