"""NumPy oracle: an executable specification of the reference's per-frame math.

Every function here transcribes the *behavior* of auduno/headtrackr (JS) into plain
NumPy, with `file:line` citations into the reference's JS sources.  The oracle is the golden
target for the JAX/Pallas implementation: kernels must match it exactly (integer
paths) or within documented float tolerance.

Two deliberate, documented deviations from the browser reference (see docs/PARITY.md):

1. **Grayscale** — the reference computes ``0.3 r + 0.59 g + 0.11 b`` in float64 and
   relies on Uint8ClampedArray round-half-even (src/ccv.js:29).  We define the
   framework spec as integer arithmetic ``(30 r + 59 g + 11 b + 50) // 100`` which is
   deterministic on every backend and differs from the JS value by at most 1 gray
   level at exact .5 boundaries.  ``grayscale(mode="js64")`` emulates the JS float
   path for sensitivity testing.

2. **Resampler** — the reference uses browser ``drawImage`` antialiased scaling whose
   semantics are unspecified and browser-dependent (src/ccv.js:121-146).  We define a
   bilinear resampler with half-pixel centers computed in float32, identical in the
   oracle and the JAX ops.

The port's copy of headtrackr_tpu/oracle/__init__.py, the same code: the
card has no jax, and headtrackr_tpu_torch imports nothing of the JAX
package (whose __init__ imports jax), so the port keeps its own oracle
and its conformance gate (tools/torch_verify_gpu.py) holds the port
against this copy.
"""

from .imageproc import (
    grayscale,
    draw_image,
    whitebalance,
    build_pyramid,
)
from .detector import detect_objects, array_group
from .camshift import Histogram, Moments, CamshiftTracker
from .smoother import Smoother
from .headposition import HeadPositionTracker
from .pipeline import FaceTracker, HeadTracker

__all__ = [
    "grayscale",
    "draw_image",
    "whitebalance",
    "build_pyramid",
    "detect_objects",
    "array_group",
    "Histogram",
    "Moments",
    "CamshiftTracker",
    "Smoother",
    "HeadPositionTracker",
    "FaceTracker",
    "HeadTracker",
]
