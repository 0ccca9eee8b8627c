"""Wrapper of the ``hist_mma`` CUDA kernel (``csrc/histmma.cu``).

  hist_mma   replaces tools/kernel_experiments.py mk_call(hist_k6), the
             int8 one-hot histogram (the JAX package's default formulation,
             headtrackr_tpu/ops/histogram.py histogram_scan); the camshift
             histogram when TrackerConfig.histKernel is None, and
             band_hist_divergence's full-frame histogram

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/histogram.py ``hist_mma_plain``), a CUDA tensor launches the kernel,
any other device raises.  The kernel puts the stream on the grid's y
dimension: a batch past 65,535 streams takes a launch a chunk of at most
that many (kernels/histbins.py ``row_chunks``).
"""

import torch

from ..ops.histogram import NBINS, hist_mma_plain
from .histpdf import _check_frames, _check_rects
from .histbins import row_chunks
from .launch import launch, on_cuda, row_ptr, sm_count

__all__ = ["hist_mma", "split_frame"]

# resident blocks an SM holds (a block is one warpgroup with 45 KB of
# shared memory: five fit, four leave room), and the pixels of a bulk-copy
# stage, of which a block's span is a multiple
_BLOCKS_PER_SM = 4
_STAGE_PX = 1024


def split_frame(n, npx, sms):
    """(blocks per stream, pixels per block) of a launch over n streams of
    npx pixels on a card of ``sms`` SMs: one wave of blocks, split evenly
    over the streams (a stream per block from n >= the wave on), each a
    whole number of _STAGE_PX-pixel stages.  Each block pays a fixed cost
    (zeroing its one-hot tiles, writing its partial), so fewer, longer
    blocks win once the card is full."""
    wave = _BLOCKS_PER_SM * sms
    blocks = max(1, min(-(-npx // _STAGE_PX), wave // n))
    block_px = -(-npx // blocks)
    block_px = -(-block_px // _STAGE_PX) * _STAGE_PX
    return -(-npx // block_px), block_px


def hist_mma(frames, rects):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) f32 exact
    counts of each stream's rect (clamped to the frame), by an int8 one-hot
    product on the tensor cores: ``hist4096``'s contract.  Its grid covers
    the frame: meant for full-frame rects."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    _check_rects(rects, N)
    if not on_cuda(frames, rects):
        return hist_mma_plain(frames, rects)
    if N * H * W == 0:
        return torch.zeros((N, NBINS), dtype=torch.float32,
                           device=frames.device)
    out = torch.empty((N, NBINS), dtype=torch.float32, device=frames.device)
    chunks = row_chunks(N)
    plans = [split_frame(r1 - r0, H * W, sm_count(frames.device))
             for r0, r1 in chunks]
    # one scratch for the chunks' partial counts, which run in turn
    partial = torch.empty((max((r1 - r0) * b for (r0, r1), (b, _) in
                               zip(chunks, plans)), NBINS), dtype=torch.int32,
                          device=frames.device)
    with torch.cuda.device(frames.device):
        for (r0, r1), (blocks, block_px) in zip(chunks, plans):
            launch("hist_mma", "hist_mma_launch", row_ptr(frames, r0),
                   row_ptr(rects, r0), partial.data_ptr(), row_ptr(out, r0),
                   r1 - r0, H, W, blocks, block_px)
    return out
