"""headtrackr_tpu_torch — the PyTorch and CUDA port of headtrackr_tpu.

Face detection (BBF cascade), camshift color tracking, smoothing and head
position over N camera streams, served on one NVIDIA GPU:

  frames (N, H, W, 3) u8
    -> [whitebalance-stability gate]
    -> cascade detection over every window of every scale
    -> camshift tracking, full frame or band-local (CUDA kernels: hist_mma,
       hist4096, backproject, histpdf_band, take_along)
    -> EMA smoothing -> head position (x, y, z cm)
    -> facetrackingEvent / headtrackingEvent / headtrackrStatus callbacks

Entry points: ``Tracker`` (one camera, the reference's headtrackr.Tracker),
``BatchedTracker`` (N streams), ``BatchedSession`` / ``StreamFanout`` /
``IngestRing`` (N streams with per-stream events), ``checkpoint``.

The JAX package ``headtrackr_tpu`` is the reference this port is held
against; this package imports torch and numpy, never jax or headtrackr_tpu.
"""

__version__ = "0.1.0"

from .cascade import Cascade, frontalface, toy_cascade
from .config import TrackerConfig
from .runtime import checkpoint, events
from .runtime.fanout import BatchedSession, IngestRing, StreamFanout
from .runtime.serving import BatchedTracker
from .runtime.tracker import Tracker
from .runtime.ui import Ui
from .runtime.video import CameraSource, ClipSource, SyntheticFaceSource

__all__ = ["BatchedTracker", "TrackerConfig", "frontalface", "toy_cascade",
           "Cascade", "Tracker", "Ui", "events", "checkpoint",
           "StreamFanout", "IngestRing", "BatchedSession",
           "ClipSource", "SyntheticFaceSource", "CameraSource"]
