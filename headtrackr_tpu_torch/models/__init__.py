"""Detector, camshift, head pose and the per-stream state machine."""

from .detector import (DetectorTables, detect_best, detect_objects_padded,
                       detector_tables)

__all__ = ["detect_best", "detect_objects_padded", "DetectorTables",
           "detector_tables"]
