"""Kernel times of the traced run's profile, by name and by layer.

The port's kernels by layer (their names in ``headtrackr_tpu_torch/csrc``)
as the per-layer metrics group them.  A name matches where it contains one
of a layer's patterns."""

__all__ = ["LAYERS", "kernel_time", "ms_per_tick"]

LAYERS = {
    "sched": ("tick_select_kernel", "escape_select_kernel",
              "scan_commit_kernel", "slot_gather_kernel"),
    "statemachine": ("tick_epilogue", "frame_prep_kernel",
                     "handoff_kernel"),
    "camshift": ("cluster_hist_kernel", "hist_mma_kernel",
                 "hist_mma_reduce", "backproject_kernel",
                 "backproject_rect_kernel", "meanshift_kernel",
                 "meanshift_cluster_kernel"),
    "detector": ("pyramid_kernel", "cascade_dense_kernel",
                 "cascade_deep_kernel", "cascade_compact_kernel",
                 "group_kernel"),
}


def kernel_time(profile, patterns):
    """(launches, seconds) of the profiled device operations whose names
    contain one of ``patterns``."""
    n = s = 0
    for name, (c, t) in profile["kernels"].items():
        if any(p in name for p in patterns):
            n += c
            s += t
    return n, s


def ms_per_tick(ctx, layer):
    """Device ms a profiled tick of the layer's kernels, or None without
    a profile."""
    p = ctx.get("profile")
    if p is None:
        return None
    return 1e3 * kernel_time(p, LAYERS[layer])[1] / p["ticks"]
