"""Typed configuration mirroring the reference's option objects.

The same fields and defaults as ``headtrackr_tpu.config.TrackerConfig`` (a
test pins the two against each other), so a configuration moves between the
packages unchanged.  Names and defaults follow the reference:
  - Tracker params:      src/main.js:12-24,37-55
  - facetrackr params:   src/facetrackr.js:28-53
  - camshift params:     src/camshift.js:150-151
  - headposition params: src/headposition.js:22-48,69-84

The port reads the reference-behaviour fields and the band-local serving
knobs (bandHist, bandHistAudit, bandHistAuditAction).  The capacity and TPU
formulation knobs (maxCandidates, survivorsStage2, survivorsDeep, histBlock,
sparseHist, histKernel, exactCamshift) are carried for compatibility and do
not change its results: its detector keeps a fixed 256 candidate slots a
stream (models/detector.py CAPACITY) and none of the reference's tile and
window caps, its camshift pdf
is always the exact f32 lookup, and its histogram and backprojection always
run the CUDA kernels on the card.
"""

import dataclasses
from typing import Optional

__all__ = ["TrackerConfig"]


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    # headtrackr.Tracker params (src/main.js:37-55)
    ui: bool = True
    smoothing: bool = True
    debug: bool = False
    altVideo: Optional[object] = None
    detectionInterval: int = 20        # ms between frame steps
    retryDetection: bool = True
    fov: Optional[float] = None        # horizontal FOV degrees; None = estimate
    fadeVideo: bool = False
    cameraOffset: float = 11.5         # cm camera -> screen center
    calcAngles: bool = False
    headPosition: bool = True

    # facetrackr params (src/facetrackr.js:28-53)
    sendEvents: bool = True
    whitebalancing: bool = True

    # headposition params (src/headposition.js:22-48)
    distance_to_screen: float = 60.0
    edgecorrection: bool = True

    # detector work shape (src/facetrackr.js:147-149: interval=5, min_neighbors=1)
    detectorInterval: int = 5
    minNeighbors: int = 1

    # smoother (src/main.js:163: Smoother(0.35, detectionInterval + 15))
    smoothingAlpha: float = 0.35

    # reference-package knobs, carried unchanged (see the module docstring)
    maxCandidates: int = 256
    survivorsStage2: int = 4096
    survivorsDeep: int = 512
    histBlock: Optional[int] = None
    sparseHist: Optional[int] = None
    bandHist: bool = False
    bandHistAudit: bool = True
    bandHistAuditAction: str = "flag"
    histKernel: Optional[str] = None
    exactCamshift: bool = False

    @property
    def smoothingInterval(self) -> int:
        return self.detectionInterval + 15
