"""detector_ms_per_tick.live: device ms a profiled tick of the detector
layer's kernels (detector_ms_per_tick.py's reader), in the cell whose
calls are single ``step_auto`` ticks, where it moves tick_p95_ms."""

from benchmark.lib.readers import reader_of

read = reader_of("detector_ms_per_tick")
