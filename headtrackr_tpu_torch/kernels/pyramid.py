"""Wrapper of the ``pyramid`` CUDA kernel (``csrc/pyramid.cu``).

  pyramid   replaces headtrackr_tpu/ops/imageproc.py resize_bilinear and
            build_pyramid (with the packing of the planes into the
            detector's flat buffer, models/detector.py)

Dispatch as in kernels/histpdf.py: a CPU tensor takes the plain twin
(ops/imageproc.py pack_pyramid), a CUDA tensor launches the kernel, one
launch a call: a CTA, or a cluster of ``split`` CTAs (16 is past the
portable cluster size: the launch opts in), a (stream, chain) of the
tables' PyramidPlan; any other device raises, and so does a failed
build or launch.  The two are equal to the bit.

The launch policy is this module's: the CTAs a chain (``split``) and each
CTA's shared-memory regions (``pyramid_regions``, sized so that
CTAS_PER_SM CTAs fit an SM), cached on the tables.  The kernel puts the
stream on the grid's y dimension: a batch past 65,535 streams takes a
launch a chunk of at most that many (kernels/histbins.py ``row_chunks``),
each sized by its own streams.
"""

import torch

from ..ops.imageproc import STEP_H, STEP_SOURCE, STEP_W, pack_pyramid
from .histbins import row_chunks
from .launch import launch, on_cuda, row_ptr, sm_count

__all__ = ["pyramid", "split", "pyramid_regions", "held_bytes", "SPLITS",
           "CTAS_PER_SM", "SMEM_BYTES"]

SPLITS = (1, 2, 4, 8, 16)  # CTAs a chain (csrc/pyramid.cu's instances)
CTAS_PER_SM = 2        # resident CTAs an SM (csrc/pyramid.cu kCtasPerSm)
# a CTA's shared memory: its share of an sm_90 SM's 233,472 bytes, less
# the 1,024 the system reserves a CTA (csrc/pyramid.cu kSmemPerCta)
SMEM_BYTES = 233472 // CTAS_PER_SM - 1024


def split(n_streams, chains, sms):
    """CTAs a chain: the most of SPLITS whose clusters all fit one wave of
    CTAS_PER_SM CTAs an SM, else 1 (a chain's time falls with its threads:
    on the H100, 16 CTAs a chain at one stream, 4 at the relock bucket's
    8, one from 23 streams on; tools/torch_detect_variants.py times every
    size).  A pure function of the shapes and the card."""
    best = 1
    for s in SPLITS:
        if n_streams * chains * s <= CTAS_PER_SM * sms:
            best = s
    return best


def held_bytes(step, split):
    """Shared-memory bytes of a step's level on one of ``split`` CTAs that
    share its chain: rows r with r % split == rank, at local row
    r // split."""
    return -(-int(step[STEP_H]) // split) * int(step[STEP_W])


def pyramid_regions(plan, split, limit=SMEM_BYTES):
    """(r0, r1): the bytes of the two shared-memory regions of a ``pyramid``
    CTA when ``split`` CTAs share each chain of the PyramidPlan ``plan`` and
    a CTA has ``limit`` bytes (of which the regions get what the staged
    grids, ``grid_bytes`` after 16-byte alignment, leave).
    A chain's even steps hold their level in region 0, its odd steps in
    region 1 (so a level is read while the next is written); a source step
    is held iff ``held_bytes`` fits its region.  The largest levels are
    dropped until both regions fit: those the next level reads back from
    the packed plane (or the scratch)."""
    sizes = ([], [])
    for c in range(len(plan.chain_first) - 1):
        rows = plan.steps[plan.chain_first[c]:plan.chain_first[c + 1]]
        for j, st in enumerate(rows):
            if st[STEP_SOURCE]:
                sizes[j & 1].append(held_bytes(st, split))
    limit -= plan.grid_bytes + 15
    while True:
        r = [max(s, default=0) for s in sizes]
        if r[0] + r[1] <= limit:
            return r[0], r[1]
        sizes[int(r[1] > r[0])].remove(max(r))


def pyramid(gray, tables):
    """gray (N, H, W) u8 -> (N, tables.L) u8: the pyramid planes and the
    pixel-interleaved quarter planes of ``tables`` (a
    models.detector.DetectorTables on gray's device), flat."""
    spec = tables.spec
    if (gray.dtype != torch.uint8 or gray.dim() != 3
            or tuple(gray.shape[1:]) != (spec.h0, spec.w0)):
        raise ValueError(f"gray must be (N, {spec.h0}, {spec.w0}) uint8, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    gray = gray.contiguous()
    plan = tables.plan
    if not on_cuda(gray, plan.steps):
        return pack_pyramid(gray, spec.interval, tables.plane_keys,
                            tables.geom_levels)
    N = gray.shape[0]
    dev = gray.device
    out = torch.empty((N, tables.L), dtype=torch.uint8, device=dev)
    if N == 0 or tables.L == 0:
        return out
    scratch = (torch.empty((N, plan.S), dtype=torch.uint8, device=dev)
               if plan.S else out)
    with torch.cuda.device(dev):
        for n0, n1 in row_chunks(N):
            s = split(n1 - n0, plan.chains, sm_count(dev))
            key = ("pyramid", s)
            if key not in tables.launch:
                tables.launch[key] = pyramid_regions(plan.host, s)
            r0, r1 = tables.launch[key]
            launch("pyramid", "pyramid_launch", row_ptr(gray, n0),
                   row_ptr(scratch, n0), row_ptr(out, n0),
                   plan.steps.data_ptr(), plan.chain_first.data_ptr(),
                   plan.chain_grid.data_ptr(), plan.xg.data_ptr(),
                   plan.yg.data_ptr(), plan.chains, n1 - n0, spec.w0,
                   spec.h0, plan.S, tables.L, s, r0, r1, plan.grid_bytes)
    return out
