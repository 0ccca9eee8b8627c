"""Debug drawing and profiling helpers."""

from .debugdraw import draw_box, draw_rotated_box, render_debug_frame
from .profiling import StageTimer, trace

__all__ = ["draw_box", "draw_rotated_box", "render_debug_frame",
           "StageTimer", "trace"]
