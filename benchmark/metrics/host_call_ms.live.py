"""host_call_ms.live: the harness's span around each ``step_auto`` call
until it returns, over the window's calls (host_call_ms.py's reader), in
the cell whose calls are single ``step_auto`` ticks, where it moves
tick_p95_ms."""

from benchmark.lib.readers import reader_of

read = reader_of("host_call_ms")
