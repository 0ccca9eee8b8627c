"""histpdf_band_roofline.live: the profiled ``histpdf_band`` launches'
share of their roofline (histpdf_band_roofline.py's reader), in the cell
whose calls are single ``step_auto`` ticks, where it moves tick_p95_ms."""

from benchmark.lib.readers import reader_of

read = reader_of("histpdf_band_roofline")
