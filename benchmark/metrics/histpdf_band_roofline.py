"""histpdf_band_roofline: the least time of the profiled ticks'
``histpdf_band`` launches (each over every stream's band: the bytes and
operations of lib/roofline.py) over the time they took, in % (kernels;
moves frames_per_s).  A launch is counted at most once a tick; a launch
beyond that (none in these cells) only adds time."""

from benchmark.lib import layers, roofline


def read(ctx):
    p = ctx.get("profile")
    band = ctx["config"]["tracker"].get("band")
    if p is None or band is None:
        return None
    n, s = layers.kernel_time(p, ("cluster_hist_kernel<true",))
    if not n:
        return None
    b, o = roofline.histpdf_band_work(ctx["n"], band)
    return 100.0 * min(n, p["ticks"]) * roofline.bound_s(b, o) / s
