"""The runtime: batched multi-stream serving, the session Tracker, events,
frame sources, fanout, network ingest and checkpoints."""

from . import events
from .fanout import BatchedSession, IngestRing, StreamFanout
from .serving import BatchedTracker, plan_serving
from .tracker import Tracker
from .ui import Ui
from .video import CameraSource, ClipSource, SyntheticFaceSource, VideoSource

__all__ = ["events", "ClipSource", "SyntheticFaceSource", "CameraSource",
           "VideoSource", "Tracker", "Ui", "BatchedTracker",
           "StreamFanout", "IngestRing", "BatchedSession"]
