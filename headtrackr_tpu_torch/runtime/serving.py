"""Batched multi-stream serving: N cameras on one GPU.

The reference runs one Tracker per camera in one JS thread.  Here per-stream
state is a ``TrackerState`` of (N, ...) tensors and each tick is scheduled
on the host from one read of the mode vector, with the branch rule of the
reference package's device scheduler (headtrackr_tpu/runtime/serving.py
``auto_step``, ``overload="full"``), with kb = min(bucket, N) and
chunk_cap = max(kb, (min(N, 4 kb) // kb) kb):

  no stream pending (all CS)      -> "track" on the whole batch;
  pending, none in VJ             -> "wbtrack" (whitebalance + camshift);
  1 .. chunk_cap pending          -> camshift for the trackers, the full
                                     WB/VJ machinery for the pending streams
                                     (the reference's bucket/chunk ticks;
                                     every pending stream is served);
  more pending                    -> the "full" step on the whole batch,
                                     whose trackers take FULL-FRAME camshift.

With a band (``band="auto"``: DEFAULT_BAND when it is smaller than the
frame) the first three take the band-local camshift.  Streams whose window
left the band are recomputed from the pre-step state by the full-frame
"track" step and scattered back: one more host read per band tick.  The
reference bounds that recompute's cost with ``escape_bucket``; its
per-stream results are the same whatever the bound, so here exactly the
escaped streams are recomputed.
"""

import torch

from ..cascade import frontalface
from ..config import TrackerConfig
from ..device import resolve_device
from ..models import camshift as cs_mod
from ..models import facetracker as ft
from ..models.detector import detector_tables
from ..ops.histogram import (backprojection_weights, histogram_full,
                             histogram_rect)

__all__ = ["BatchedTracker", "resolve_band", "wants_band_audit"]


def resolve_band(band, frame_shape):
    """Normalize a band knob: "auto" -> DEFAULT_BAND; a band covering the
    whole frame -> None (identical math on the full-frame path)."""
    if band == "auto":
        band = cs_mod.DEFAULT_BAND
    if band is not None and (band[0] >= frame_shape[0]
                             and band[1] >= frame_shape[1]):
        band = None
    return band


def wants_band_audit(config, band):
    """True iff steps built from this (config, resolved band) carry the
    bandHist handoff-audit flag: states fed to them must come from
    ``ft.init_state(..., band_audit=wants_band_audit(config, band))``."""
    return band is not None and config.bandHist and config.bandHistAudit


class BatchedTracker:
    """Serve N independent streams, one host-scheduled tick per frame batch."""

    def __init__(self, n_streams, frame_shape=(240, 320), params=None,
                 cascade=None, device=None, bucket=32, band="auto",
                 overload="full", escape_bucket=8, **kw):
        """params / kw: TrackerConfig fields.  device: where state and
        compute live (default: the current CUDA device; with no card, pass
        device="cpu" to run the kernels' plain twins on the CPU).

        bucket: the reference scheduler's redetect bucket; it sets which
        ticks serve the pending streams beside the trackers (see the
        module docstring).  band: "auto", None (full frame) or (bh, bw).
        overload: only "full" (every pending stream served on every tick).
        escape_bucket: accepted for the reference's signature; it bounds
        cost there and changes no result, so it is not used."""
        if overload != "full":
            raise NotImplementedError(
                f"overload={overload!r}: only 'full' is ported")
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
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls and convolutions: the parity contract with
            # the reference has no room for TF32 rounding
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.band = resolve_band(band, self.frame_shape)
        self._band_audit = wants_band_audit(self.config, self.band)
        self.bucket = max(1, min(int(bucket), n_streams))

        H, W = self.frame_shape
        tables = detector_tables(W, H, self.cascade,
                                 self.config.detectorInterval, self.device)
        audit = self.band if self._band_audit else None

        def mk(variant, band=None):
            return ft.make_step(self.cascade, self.config, self.frame_shape,
                                variant, self.device, band=band,
                                audit_band=audit, tables=tables)

        full, self._track_plain = mk("full"), mk("track")
        b = self.band
        # one step per branch; the banded ones return escaped streams, which
        # the full-frame "track" step recomputes
        self._steps = {"track": mk("track", b) if b else self._track_plain,
                       "wbtrack": mk("wbtrack", b),
                       "bucket": mk("full", b) if b else full,
                       "full": full}
        self._banded = {"track", "wbtrack", "bucket"} if b else set()
        self.reset()

    def _init_state(self, n):
        return ft.init_state(n, self.device, self.config.whitebalancing,
                             band_audit=self._band_audit)

    def reset(self):
        """Re-initialize every stream (fresh cold start)."""
        self.state = self._init_state(self.n)

    def reset_stream(self, i):
        """Re-initialize one stream (a new camera connects)."""
        idx = torch.tensor([int(i)], device=self.device)
        self.state = ft.tree_scatter(self.state, idx, self._init_state(1))

    @property
    def modes(self):
        """Host copy of the (N,) mode vector."""
        return self.state.mode.cpu().numpy()

    def branch(self, modes):
        """The reference scheduler's branch for a host mode vector."""
        npend = int((modes != ft.MODE_CS).sum())
        if npend == 0:
            return "track"
        if not (modes == ft.MODE_VJ).any():
            return "wbtrack"
        kb = self.bucket
        chunk_cap = max(kb, (min(self.n, 4 * kb) // kb) * kb)
        return "bucket" if npend <= chunk_cap else "full"

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
        branch = self.branch(modes)
        if branch not in self._banded:
            self.state, out = self._steps[branch](self.state, frames, modes)
            return out
        state, out, escaped = self._steps[branch](self.state, frames, modes)
        idx = torch.nonzero(escaped.cpu()).flatten()
        if idx.numel():
            idx = idx.to(self.device)
            sub_state, sub_out = self._track_plain(
                ft.tree_index(self.state, idx), frames.index_select(0, idx))
            state = ft.tree_scatter(state, idx, sub_state)
            out = ft.tree_scatter(out, idx, sub_out)
        self.state = state
        return out._replace(escaped=escaped)

    def step_auto(self, frames):
        """The same tick as ``step`` (the reference package's name for its
        device-scheduled tick, whose per-stream outputs this matches)."""
        return self.step(frames)

    def stream_info(self, stream):
        """Per-stream snapshot (host reads; not for the per-tick path):
        mode "wb" | "vj" | "cs", the search window [x, y, w, h], the model's
        distinct nonzero bins, and the bandHist audit flag (None when the
        audit is off)."""
        s = int(stream)
        mode = {ft.MODE_WB: "wb", ft.MODE_VJ: "vj",
                ft.MODE_CS: "cs"}[int(self.state.mode[s])]
        dirty = self.state.cs.band_dirty
        return {
            "stream": s,
            "mode": mode,
            "window": self.state.cs.window[s].tolist(),
            "model_bins": int((self.state.cs.model_hist[s] != 0).sum()),
            "band_dirty": bool(dirty[s]) if dirty is not None else None,
        }

    def band_hist_divergence(self, frames, stream=0):
        """bandHist cross-check for one stream: its current histogram full
        frame (reference-exact) and over its band (the serving
        approximation) at its current window, and the weight divergence
        the band pdf would see.  Returns max_inflation (largest band minus
        full weight over bins present in the band; 0.0 = exact tick),
        contaminated_bins (model bins the band undercounts), model_bins and
        band_dirty."""
        if self.band is None or not self.config.bandHist:
            raise ValueError("band_hist_divergence needs an active band "
                             "path with bandHist=True")
        s = int(stream)
        frame = torch.as_tensor(frames).to(self.device)[s:s + 1].contiguous()
        model = self.state.cs.model_hist[s:s + 1]
        rect = cs_mod.band_rects(*cs_mod.band_rect(
            self.state.cs.window[s:s + 1], self.band, self.frame_shape))
        cur_full = histogram_full(frame)
        cur_band = histogram_rect(frame, rect)
        w_full = backprojection_weights(model, cur_full)
        w_band = backprojection_weights(model, cur_band)
        present = cur_band > 0  # bins the band pdf can read
        infl = torch.where(present, w_band - w_full, 0.0).max()
        contaminated = (model > 0) & (cur_band < cur_full) & present
        dirty = self.state.cs.band_dirty
        return {
            "max_inflation": float(infl),
            "contaminated_bins": int(contaminated.sum()),
            "model_bins": int((model > 0).sum()),
            "band_dirty": bool(dirty[s]) if dirty is not None else None,
            "stream": s,
        }
