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
from ..ops.histogram import full_rects
from .histpdf import _check_frames, _check_rects
from .histbins import row_chunks
from .launch import frames_of, launch, on_cuda, row_ptr, sm_count

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


def hist_mma(frames, rects=None):
    """(N, H, W, 3) u8 + (N, 4) i32 [x, y, w, h] -> (N, 4096) f32 exact
    counts of each stream's rect (clamped to the frame); ``rects`` None: of
    the whole frame (the kernel reads no rect).  By an int8 one-hot
    product on the tensor cores: ``hist4096``'s contract.  Its grid covers
    the frame: meant for the whole frame.  Reads its frames in place under
    ``launch.frames_at`` (``launch.frames_of``): the kernel
    then takes its bulk copies where the address it loads is 16-byte
    aligned, else its per-thread loads."""
    _check_frames(frames)
    N, H, W, _ = frames.shape
    if rects is not None:
        _check_rects(rects, N)
    card = on_cuda(frames, *(() if rects is None else (rects,)))
    frames, at = frames_of(frames, card)
    if not card:
        if rects is None:
            rects = full_rects(N, (H, W), frames.device)
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
            # in place, streams r0.. lie r0 frames past the word's address
            launch("hist_mma", "hist_mma_launch", row_ptr(frames, r0),
                   0 if rects is None else row_ptr(rects, r0),
                   partial.data_ptr(), row_ptr(out, r0), r1 - r0, H, W,
                   blocks, block_px, at, r0 * H * W * 3)
    return out
