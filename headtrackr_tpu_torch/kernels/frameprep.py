"""Wrapper of the ``frame_prep`` CUDA kernel (``csrc/frameprep.cu``).

  frame_prep  replaces headtrackr_tpu/ops/imageproc.py:35 grayscale, :43
              whitebalance and the WB branch of headtrackr_tpu/models/
              facetracker.py:186-195, in one pass over each served
              stream's frame

Dispatch as the other wrappers: CPU tensors take the plain twin
(ops/imageproc.py ``frame_prep_plain``), CUDA tensors launch the kernel,
one launch a call; any other device raises, and so does a failed build or
launch.  The kernel equals the twin to the bit.
"""

import ctypes
import functools

import torch

from ..ops.imageproc import PWB_LENGTH, frame_prep_plain
from .launch import launch, on_cuda

__all__ = ["frame_prep"]


class _Args(ctypes.Structure):
    """csrc/frameprep.cu's Args, field for field."""
    _fields_ = [("frames", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("h", ctypes.c_longlong), ("w", ctypes.c_longlong),
                ("slots", ctypes.c_void_p), ("mode", ctypes.c_void_p),
                ("ring", ctypes.c_void_p), ("wb_n", ctypes.c_void_p),
                ("gray", ctypes.c_void_p), ("wb", ctypes.c_void_p),
                ("ring_out", ctypes.c_void_p), ("wb_n_out", ctypes.c_void_p),
                ("mode_out", ctypes.c_void_p), ("wb_vj", ctypes.c_int),
                ("vec", ctypes.c_int)]


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


def frame_prep(frames, slots, mode, wb_ring, wb_n, gray=True, wb_vj=False):
    """``ops.imageproc.frame_prep_plain``'s contract: frames (N, H, W, 3)
    u8 read through ``slots`` (S,) i64 padded with N (None: every
    stream); mode, wb_ring, wb_n the S rows' state.  Returns (gray (S, H,
    W) u8 or None, wb (S,) f32, wb_ring' (S, 15) f32, wb_n' (S,) i32,
    mode' (S,) i32)."""
    _check(frames, slots, mode, wb_ring, wb_n)
    tensors = [frames, mode, wb_ring, wb_n] + ([] if slots is None
                                               else [slots])
    if not on_cuda(*tensors):
        return frame_prep_plain(frames, slots, mode, wb_ring, wb_n, gray,
                                wb_vj)
    N, H, W, _ = frames.shape
    S, dev = mode.shape[0], frames.device
    g = torch.empty((S, H, W), dtype=torch.uint8, device=dev) if gray \
        else None
    wb = torch.empty((S,), dtype=torch.float32, device=dev)
    ring = torch.empty((S, PWB_LENGTH), dtype=torch.float32, device=dev)
    n = torch.empty((S,), dtype=torch.int32, device=dev)
    mode_out = torch.empty((S,), dtype=torch.int32, device=dev)
    vec = frames.data_ptr() % 4 == 0 and (H * W) % 4 == 0
    a = _Args(frames.data_ptr(), N, H, W,
              0 if slots is None else slots.data_ptr(), mode.data_ptr(),
              wb_ring.data_ptr(), wb_n.data_ptr(),
              0 if g is None else g.data_ptr(), wb.data_ptr(),
              ring.data_ptr(), n.data_ptr(), mode_out.data_ptr(),
              int(bool(wb_vj)), int(vec))
    with torch.cuda.device(dev):
        _checked_layout()
        if S:
            launch("frame_prep", "frame_prep_launch", ctypes.addressof(a), S)
    return g, wb, ring, n, mode_out
