"""Wrapper of the ``group`` CUDA kernel (``csrc/group.cu``).

  group   replaces headtrackr_tpu/models/detector.py group_candidates and
          the pick of detect_best

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/detect.py group_plain), a CUDA tensor launches the kernel, one launch
a call, a CTA a stream, reading the six planes in place (no copy: a call is
one device operation); any other device raises, and so does a failed build
or launch.  The two are equal to the bit where the twin's f64 member sums
are exact (csrc/group.cu states the range; the detector's boxes lie well
inside it).
"""

import torch

from ..ops.detect import group_plain
from .launch import launch, on_cuda

__all__ = ["group", "MAX_SLOTS"]

MAX_SLOTS = 256  # the kernel's most candidate slots a stream (a thread each)


def group(x, y, w, h, conf, valid, min_neighbors=1):
    """ccv's grouping of (N, K) candidate slots (f32 boxes and confidences,
    a bool valid mask; K <= MAX_SLOTS on the card) and facetrackr's pick:
    ``ops.detect.group_plain``'s contract.  Returns (slots, best): slots a
    dict of (N, K) kept / x / y / width / height / neighbors / confidence,
    best = (found, x, y, width, height, confidence) (N,)."""
    N, K = x.shape
    for name, t in zip(("y", "width", "height", "confidence"), (y, w, h, conf)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N, K):
            raise ValueError(f"{name} must be ({N}, {K}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (x.dtype != torch.float32 or valid.dtype != torch.bool
            or tuple(valid.shape) != (N, K)):
        raise ValueError("x must be float32 and valid a bool mask of its shape")
    if not on_cuda(x, y, w, h, conf, valid):
        return group_plain(x, y, w, h, conf, valid, min_neighbors)
    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"the group kernel takes 1 to {MAX_SLOTS} slots a "
                         f"stream, got {K}")
    dev = x.device
    slots = torch.empty((6, N, K), dtype=torch.float32, device=dev)
    kept = torch.empty((N, K), dtype=torch.bool, device=dev)
    best = torch.empty((5, N), dtype=torch.float32, device=dev)
    found = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        with torch.cuda.device(dev):
            launch("group", "group_launch", x.data_ptr(), y.data_ptr(),
                   w.data_ptr(), h.data_ptr(), conf.data_ptr(),
                   valid.data_ptr(), slots.data_ptr(), kept.data_ptr(),
                   best.data_ptr(), found.data_ptr(), N, K,
                   int(min_neighbors))
    return (dict(kept=kept, x=slots[0], y=slots[1], width=slots[2],
                 height=slots[3], neighbors=slots[4], confidence=slots[5]),
            (found, best[0], best[1], best[2], best[3], best[4]))
