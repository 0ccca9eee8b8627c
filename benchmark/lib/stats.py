"""The arithmetic of the metrics: percentiles, spreads, idle shares."""

import statistics

import numpy as np

__all__ = ["p95", "spread", "union_seconds", "idle_pct"]


def p95(values):
    """The 95th percentile of all values (linear between order
    statistics)."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("p95 of no values")
    return float(np.percentile(v, 95))


def spread(values):
    """(Q3 - Q1) / median, the quartiles as statistics.quantiles gives
    them (n=4, the exclusive method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_seconds(intervals):
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_pct(busy_s, window_s):
    """The share of ``window_s`` in which the device ran nothing, in %."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return 100.0 * (1.0 - busy_s / window_s)
