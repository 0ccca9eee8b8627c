"""relock_tick_pct.live: the share of the window's ticks that ran a bucket
body, from the serving program's own count (relock_tick_pct.py's
reader), in the cell whose calls are single ``step_auto`` ticks, where
it moves tick_p95_ms."""

from benchmark.lib.readers import reader_of

read = reader_of("relock_tick_pct")
