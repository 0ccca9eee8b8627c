"""device_idle_pct: 1 - the summed device spans of the window's program
launches (CUDA events just before and after each) over the window's wall
time, in % (device; moves frames_per_s)."""

from benchmark.lib import stats


def read(ctx):
    w = ctx["window"]
    if not w.launch_ms:
        return None
    return stats.idle_pct(1e-3 * sum(w.launch_ms), w.seconds)
