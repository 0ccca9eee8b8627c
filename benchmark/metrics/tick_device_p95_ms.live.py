"""tick_device_p95_ms.live: the 95th percentile over all ticks of the
window of each tick's program launch span (CUDA events just before and
after it), step calls alone (device; moves tick_p95_ms)."""

from benchmark.lib import stats


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["call"]["kind"] != "step" or not w.launch_ms:
        return None
    return stats.p95(w.launch_ms)
