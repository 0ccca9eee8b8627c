"""sched_ms_per_tick: device ms a tick of the sched layer's kernels
(benchmark/lib/layers.py), over two pool passes of one tick a launch
under the profiler (moves frames_per_s)."""

from benchmark.lib import layers


def read(ctx):
    return layers.ms_per_tick(ctx, "sched")
