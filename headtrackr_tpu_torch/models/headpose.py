"""Head-position estimation over a batch of streams (spec: src/headposition.js).

State is two per-stream scalars carried in the tracker state:
  - tan_fov_width (precomputed 2*tan(fov/2), src/headposition.js:87)
  - head_diag_cam (stateful: corner edge-correction reuses the previous frame's
    diagonal, src/headposition.js:111-127)
Inputs are f32 tensors of one shape; python-float constants stay f32.  The
functions are the plain twin's (ops/epilogue.py), whose float order the
serving step's ``tick_epilogue`` kernel reproduces.
"""

from ..ops.epilogue import (COS_HSA, EDGE_MARGIN, HEAD_DIAG_CM,  # noqa: F401
                            HEAD_HEIGHT_CM, HEAD_WIDTH_CM, SIN_HSA, TAN_HSA,
                            estimate_fov_width, track_head)

__all__ = ["estimate_fov_width", "track_head", "HEAD_WIDTH_CM", "HEAD_HEIGHT_CM"]
