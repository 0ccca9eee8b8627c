"""hist_mma_roofline: the least time of the profiled ticks' ``hist_mma``
launches (each the full-frame histogram of every stream: a 4096-bin
histogram's bytes and operations, lib/roofline.py) over the time of its
two kernels, in % (kernels; moves frames_per_s).  A launch is counted at
most once a tick; an escape body's sub-batch launch only adds time."""

from benchmark.lib import layers, roofline


def read(ctx):
    p = ctx.get("profile")
    if p is None:
        return None
    n, _ = layers.kernel_time(p, ("hist_mma_kernel",))
    _, s = layers.kernel_time(p, ("hist_mma_kernel", "hist_mma_reduce"))
    if not n:
        return None
    b, o = roofline.hist4096_work(ctx["n"], ctx["frame"])
    return 100.0 * min(n, p["ticks"]) * roofline.bound_s(b, o) / s
