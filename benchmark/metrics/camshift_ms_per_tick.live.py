"""camshift_ms_per_tick.live: device ms a profiled tick of the camshift
layer's kernels (camshift_ms_per_tick.py's reader), in the cell whose
calls are single ``step_auto`` ticks, where it moves tick_p95_ms."""

from benchmark.lib.readers import reader_of

read = reader_of("camshift_ms_per_tick")
