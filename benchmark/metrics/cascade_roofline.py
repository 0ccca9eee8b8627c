"""cascade_roofline: the least time of the profiled ticks' cascade
(dense, deep, compact) over their time, in % (kernels; moves
frames_per_s).  The work: the pyramid planes of each stream pending
before the tick (the streams the bucket serves; padding slots need
nothing), read once, and its candidate slots written (lib/roofline.py);
the planes' bytes are the reference pyramid's at the frame size."""

from benchmark.lib import layers, roofline
from benchmark.reference.imageproc import build_pyramid

import numpy as np


def _plane_bytes(frame):
    pyr = build_pyramid(np.zeros(frame, np.uint8), 5)[0]
    return sum(int(v.size) for v in pyr.values())


def read(ctx):
    p = ctx.get("profile")
    if p is None:
        return None
    n, s = layers.kernel_time(p, ("cascade_dense_kernel",
                                  "cascade_deep_kernel",
                                  "cascade_compact_kernel"))
    served = sum(p["pending"])
    if not n or not served:
        return None
    b, _ = roofline.cascade_work(served, _plane_bytes(ctx["frame"]))
    return 100.0 * roofline.bound_s(b, 0) / s
