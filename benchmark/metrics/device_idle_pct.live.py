"""device_idle_pct.live: the device's idle share of the window, from CUDA
events around each launch (device_idle_pct.py's reader), in the cell
whose calls are single ``step_auto`` ticks, where it moves tick_p95_ms."""

from benchmark.lib.readers import reader_of

read = reader_of("device_idle_pct")
