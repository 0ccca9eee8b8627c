"""tick_p95_ms: the 95th percentile over all ticks of the window of each
tick's latency, from a CUDA event recorded as the ``step_auto`` call
starts to one recorded once its outputs are on the host (step calls
alone).  End to end, device trace."""

from benchmark.lib import stats


def read(ctx):
    ms = ctx["window"].tick_ms
    return stats.p95(ms) if ms else None
