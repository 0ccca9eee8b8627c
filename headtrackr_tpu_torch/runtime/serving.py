"""Batched multi-stream serving: N cameras on one GPU.

The reference runs one Tracker per camera in one JS thread.  Here per-stream
state is a ``TrackerState`` of (N, ...) tensors and each tick is scheduled
on the host from one read of the mode vector:

  1. read the (N,) mode vector once (one small device-to-host copy);
  2. every stream tracking: the "track" step on the whole batch;
  3. otherwise the "full" step, which runs camshift on the CS streams and
     whitebalance / detection on the WB / VJ streams, each selected by
     index, and scatters the results back into the batch.

Every pending stream is served on every tick, so the per-stream outputs equal
those of the reference package's device scheduler with ``overload="full"``
(headtrackr_tpu/runtime/serving.py auto_step).
"""

import torch

from ..cascade import frontalface
from ..config import TrackerConfig
from ..models import facetracker as ft

__all__ = ["BatchedTracker"]


class BatchedTracker:
    """Serve N independent streams, one host-scheduled tick per frame batch."""

    def __init__(self, n_streams, frame_shape=(240, 320), params=None,
                 cascade=None, device=None, **kw):
        """params / kw: TrackerConfig fields.  device: where state and
        compute live (default: the current CUDA device if there is one,
        else the CPU)."""
        merged = dict(params or {})
        merged.update(kw)
        # the reference package's batched capacity defaults, carried so the
        # two configurations compare equal (this detector has no caps)
        if n_streams >= 32:
            merged.setdefault("survivorsStage2", 4096)
            merged.setdefault("survivorsDeep", 128)
            merged.setdefault("maxCandidates", 64)
        self.config = TrackerConfig(**merged)
        self.n = n_streams
        self.frame_shape = tuple(frame_shape)
        self.cascade = cascade if cascade is not None else frontalface()
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls and convolutions: the parity contract with
            # the reference has no room for TF32 rounding
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._step_full = ft.make_step(self.cascade, self.config,
                                       self.frame_shape, "full", self.device)
        self._step_track = ft.make_step(self.cascade, self.config,
                                        self.frame_shape, "track", self.device)
        self.reset()

    def reset(self):
        """Re-initialize every stream (fresh cold start)."""
        self.state = ft.init_state(self.n, self.device,
                                   self.config.whitebalancing)

    @property
    def modes(self):
        """Host copy of the (N,) mode vector."""
        return self.state.mode.cpu().numpy()

    def step(self, frames):
        """frames: (N, H, W, 3) u8 (tensor or array).  Returns the
        StepOutput batch of (N,) tensors on the device."""
        frames = torch.as_tensor(frames).to(self.device)
        if tuple(frames.shape) != (self.n,) + self.frame_shape + (3,) \
                or frames.dtype != torch.uint8:
            raise ValueError(f"frames must be ({self.n}, {self.frame_shape[0]}, "
                             f"{self.frame_shape[1]}, 3) uint8, got "
                             f"{tuple(frames.shape)} {frames.dtype}")
        frames = frames.contiguous()
        modes = self.modes
        if (modes == ft.MODE_CS).all():
            self.state, out = self._step_track(self.state, frames)
        else:
            self.state, out = self._step_full(self.state, frames, modes)
        return out

    def step_auto(self, frames):
        """The same tick as ``step`` (the reference package's name for its
        device-scheduled tick, whose per-stream outputs this matches)."""
        return self.step(frames)
