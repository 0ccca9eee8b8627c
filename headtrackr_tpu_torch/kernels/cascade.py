"""Wrapper of the ``cascade`` CUDA kernels (``csrc/cascade.cu``).

  cascade   replaces headtrackr_tpu/models/detector.py detect_candidates
            (with _dense_chunk_stacked and _patch_chunk)

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/detect.py cascade_plain), a CUDA tensor launches the kernels, three
launches a call (the windows through the dense stages, listing their
survivors; the listed survivors through the deep stages, a warp each; each
stream's survivors compacted in window order), two for a cascade of at
most DENSE stages; any other device raises, and so does a failed build or
launch.  The two are equal to the bit, slot for slot.

The launch policy is this module's: the dense kernel's tile (``dense_tile``)
and its tiles (``dense_tiles``), cached on the tables.  The dense kernel
puts the stream on the grid's y dimension and the work list numbers its
windows n * M + m in 32 bits, so the dense and deep launches run over
chunks of at most 65,535 streams and 2^32 windows
(kernels/histbins.py ``row_chunks``), in turn, each chunk's survivors
listed afresh (the list, its count and the chunk's bitmap zeroed by the
dense launch's memset); the compaction, a CTA a stream on the grid's x
dimension, takes the batch in one launch.
"""

import numpy as np
import torch

from ..ops.detect import cascade_plain
from .histbins import row_chunks
from .launch import launch, on_cuda, row_ptr, sm_count

DENSE = 2          # stages run a thread a window, at most (kDense)
DENSE_WEAK = 16    # their weak classifiers, at most (kDenseWeak)
DENSE_TILES = (256, 1024)  # windows of one scale step a dense CTA takes
_LIST_MAX = (1 << 32) - 1  # list entries n * M + m are u32


def dense_tile(n_streams, ctas, sms):
    """Windows a dense CTA takes: the larger tile (its staging and slot
    table spread over 4x the windows) where its CTAs (``ctas``: the larger
    tile's CTAs a stream) still fill 8 a SM of ``sms``, else the smaller
    (more CTAs: the relock bucket and the session).  A pure function of
    the shapes and the card."""
    return DENSE_TILES[1] if n_streams * ctas >= 8 * sms else DENSE_TILES[0]


def dense_tiles(scales, ext, tile):
    """The dense kernel's tiles of ``tile`` windows over the scale steps
    ``scales`` (DetectorTables.dense): tile_first (G + 1,) i32 (scale step
    g's tiles, each from the 32-window word of its first window), and the
    most shared-memory bytes a tile's staged rows take (each plane's run
    of whole rows, ``ext`` rows beyond the tile's window rows, 16-byte
    aligned with its start's offset)."""
    tile_first, most = [0], 0
    for first, count, cols, _, _, _, w0, w1, wi in scales:
        starts = range(first // 32 * 32, first + count, tile)
        tile_first.append(tile_first[-1] + len(starts))
        for m0 in starts:
            dy = ((min(m0 + tile, first + count) - 1 - first) // cols
                  - (max(m0, first) - first) // cols)
            rows = [2 * dy + ext[0], dy + ext[1], dy + ext[2]]
            most = max(most, sum((r * w + 30) & ~15 for r, w, e in zip(
                rows, (w0, w1, wi), ext) if e))
    return np.asarray(tile_first, np.int32), most


def _tiles(tables, tile):
    """dense_tiles of ``tables``, cached on them."""
    key = ("cascade", tile)
    if key not in tables.launch:
        tables.launch[key] = dense_tiles(tables.dense.scales,
                                         tables.dense.ext, tile)
    return tables.launch[key]


def dense_stages(ends):
    """The stages the dense kernel runs, a thread a window: the leading
    ones, at most DENSE, whose weak classifiers (``ends``: each stage's
    cumulative end) fit DENSE_WEAK; the deep kernel takes the rest."""
    d = 0
    while d < min(DENSE, len(ends)) and int(ends[d]) <= DENSE_WEAK:
        d += 1
    return d

__all__ = ["cascade", "dense_stages", "dense_tile", "dense_tiles", "DENSE",
           "DENSE_WEAK", "DENSE_TILES"]


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
        # the bitmap, then the survivor count: zeroed by one memset
        zero = torch.empty((N * words + 1,), dtype=torch.int32, device=dev)
        bits = zero[:N * words]
        conf = torch.empty((N, M), dtype=torch.float32, device=dev)
        stages = len(tables.stages)
        dn = tables.dense
        d = len(dn.ends)
        tile = dense_tile(N, int(_tiles(tables, DENSE_TILES[1])[0][-1]),
                          sm_count(dev))
        tile_first, tile_bytes = _tiles(tables, tile)
        chunks = row_chunks(N if M else 0, _LIST_MAX // max(M, 1))
        with torch.cuda.device(dev):
            if M:
                work = torch.empty((max(n1 - n0 for n0, n1 in chunks) * M,),
                                   dtype=torch.int32, device=dev)
            for n0, n1 in chunks:
                n = n1 - n0
                at = (row_ptr(bits, n0 * words), row_ptr(zero, N * words),
                      row_ptr(conf, n0), work.data_ptr(), n, tables.L, M)
                launch("cascade", "cascade_dense_launch",
                       dn.codes.ctypes.data, dn.side.ctypes.data,
                       dn.alpha.ctypes.data, dn.thresh.ctypes.data,
                       dn.ends.ctypes.data, d, len(dn.codes),
                       dn.ext.ctypes.data, tile, tile_bytes,
                       dn.scales.ctypes.data, tile_first.ctypes.data,
                       len(dn.scales), int(stages > d), row_ptr(buf, n0),
                       *at)
                if stages > d:
                    launch("cascade", "cascade_deep_launch",
                           row_ptr(buf, n0), tables.base32.data_ptr(),
                           tables.rowstep32.data_ptr(),
                           tables.offs16.data_ptr(), tables.alpha.data_ptr(),
                           tables.thresh.data_ptr(),
                           tables.stage_end.data_ptr(), len(tables.alpha), d,
                           stages, *tables.footprint, *at, sm_count(dev))
            launch("cascade", "cascade_compact_launch", bits.data_ptr(),
                   conf.data_ptr(), tables.out_x.data_ptr(),
                   tables.out_y.data_ptr(), tables.out_w.data_ptr(),
                   tables.out_h.data_ptr(), out.data_ptr(), valid.data_ptr(),
                   overflow.data_ptr(), N, M, int(capacity))
    return dict(x=out[0], y=out[1], width=out[2], height=out[3],
                confidence=out[4], valid=valid, overflow=overflow)
