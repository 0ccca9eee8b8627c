"""Wrapper of the ``cascade`` CUDA kernels (``csrc/cascade.cu``).

  cascade   replaces headtrackr_tpu/models/detector.py detect_candidates
            (with _dense_chunk_stacked and _patch_chunk)

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/detect.py cascade_plain), a CUDA tensor launches the kernels, two
launches a call (the windows through the stages, then each stream's
survivors compacted in window order); any other device raises, and so does
a failed build or launch.  The two are equal to the bit, slot for slot.
"""

import torch

from ..ops.detect import cascade_plain
from .launch import launch, on_cuda

__all__ = ["cascade"]


def cascade(buf, tables, capacity):
    """The cascade of ``tables`` (a models.detector.DetectorTables on buf's
    device) over every window of the packed planes ``buf`` (N, L) u8.

    Returns dict of (N, capacity) x, y, width, height, confidence (f32; 0
    in empty slots) and valid (bool): each stream's first ``capacity``
    survivors in window order (scale-major, then row-major); and overflow
    (N,) i32, the survivors beyond ``capacity``."""
    if buf.dtype != torch.uint8 or buf.dim() != 2 or buf.shape[1] != tables.L:
        raise ValueError(f"buf must be (N, {tables.L}) uint8, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if int(capacity) < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    buf = buf.contiguous()
    if not on_cuda(buf, tables.feat):
        return cascade_plain(buf, tables, int(capacity))
    N, M = buf.shape[0], tables.M
    dev = buf.device
    out = torch.empty((5, N, capacity), dtype=torch.float32, device=dev)
    valid = torch.empty((N, capacity), dtype=torch.bool, device=dev)
    overflow = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        words = -(-M // 32)
        bits = torch.empty((N, words), dtype=torch.int32, device=dev)
        conf = torch.empty((N, M), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            if M:
                launch("cascade", "cascade_eval_launch", buf.data_ptr(),
                       tables.base32.data_ptr(), tables.rowstep32.data_ptr(),
                       tables.feat.data_ptr(), tables.alpha.data_ptr(),
                       tables.thresh.data_ptr(), tables.stage_end.data_ptr(),
                       bits.data_ptr(), conf.data_ptr(), N, tables.L, M,
                       len(tables.stages))
            launch("cascade", "cascade_compact_launch", bits.data_ptr(),
                   conf.data_ptr(), tables.out_x.data_ptr(),
                   tables.out_y.data_ptr(), tables.out_w.data_ptr(),
                   tables.out_h.data_ptr(), out.data_ptr(), valid.data_ptr(),
                   overflow.data_ptr(), N, M, int(capacity))
    return dict(x=out[0], y=out[1], width=out[2], height=out[3],
                confidence=out[4], valid=valid, overflow=overflow)
