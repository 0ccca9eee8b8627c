"""headtrackr_tpu_torch — the PyTorch and CUDA port of headtrackr_tpu.

Face detection (BBF cascade), camshift color tracking, smoothing and head
position over N camera streams, served on one NVIDIA GPU:

  frames (N, H, W, 3) u8
    -> [whitebalance-stability gate]
    -> cascade detection over every window of every scale
    -> camshift tracking, full frame or band-local (CUDA kernels: hist_mma,
       hist4096, backproject_ratio, histpdf_band, meanshift)
    -> EMA smoothing -> head position (x, y, z cm)
    -> facetrackingEvent / headtrackingEvent / headtrackrStatus callbacks

Entry points: ``Tracker`` (one camera, the reference's headtrackr.Tracker),
``BatchedTracker`` (N streams, sized by ``plan_serving``), ``BatchedSession`` / ``StreamFanout`` /
``IngestRing`` (N streams with per-stream events), ``checkpoint``, and the
reference-parity namespace: ``ccv``, ``camshift`` (its ``Histogram`` runs
the hist_bins kernel), ``facetrackr``, ``headposition``, ``controllers``,
``Smoother``, ``getWhitebalance``.  Each takes ``device=``; None means the
card, and raises when there is none.

The JAX package ``headtrackr_tpu`` is the reference this port is held
against; this package imports torch and numpy, never jax or headtrackr_tpu.
"""

__version__ = "0.1.0"

from .cascade import Cascade, frontalface, toy_cascade
from .config import TrackerConfig
from . import camshift, ccv, controllers, facetrackr, headposition
from .api import Smoother, getWhitebalance
from .runtime import checkpoint, events
from .runtime.fanout import BatchedSession, IngestRing, StreamFanout
from .runtime.serving import BatchedTracker, plan_serving
from .runtime.tracker import Tracker
from .runtime.ui import Ui
from .runtime.video import CameraSource, ClipSource, SyntheticFaceSource

# The bundled model, like headtrackr.cascade (src/cascade.js:19); the
# module stays reachable as ``from headtrackr_tpu_torch.cascade import ...``.
cascade = frontalface
rev = 2  # API-parity counterpart of headtrackr.rev (src/main.js:30)

__all__ = [
    "Cascade", "frontalface", "toy_cascade", "TrackerConfig",
    "ccv", "camshift", "facetrackr", "headposition", "controllers",
    "Smoother", "getWhitebalance", "Tracker", "Ui", "BatchedTracker",
    "plan_serving",
    "StreamFanout", "IngestRing", "BatchedSession",
    "ClipSource", "SyntheticFaceSource", "CameraSource",
    "events", "cascade", "rev", "checkpoint",
]
