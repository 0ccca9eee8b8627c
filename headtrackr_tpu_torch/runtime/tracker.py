"""Session runtime: the headtrackr.Tracker equivalent (spec: src/main.js:35-379).

Owns a frame source, the per-frame step, the timer loop, and event emission;
the port of headtrackr_tpu/runtime/tracker.py.  The browser-isms map as:

  getUserMedia / <video>      -> VideoSource objects (CameraSource / ClipSource)
  canvas (320x240 processing) -> the step's static frame shape
  window.setTimeout loop      -> a daemon thread ticking every detectionInterval
  document.dispatchEvent      -> runtime.events bus (same 3 event types/payloads)
  fadeVideo / debug canvas    -> a fade() hook on the source / get_debug() arrays

The per-frame math runs on the device (models/facetracker.make_step, the
"full" step at N = 1, on the card unless ``device`` says otherwise); one
host read per frame brings its StepOutput (and, debugging, the camshift
pdf) back, one copy per dtype.  That read also refreshes the host's view of
the stream's mode, which the next step dispatches on.
"""

import threading
import time as _time

import numpy as np
import torch

from ..cascade import frontalface
from ..config import TrackerConfig
from ..device import resolve_device
from ..models import facetracker as ft
from . import events as ev
from .host import HostCopy
from .ui import Ui
from .video import (CameraSource, ClipSource, VideoSource,
                    normalize_size, resize_rgb)

__all__ = ["Tracker"]

_STATUS_BITS = ft.STATUS_BITS  # one shared table (models/facetracker)

_MODE_NAMES = {ft.MODE_WB: "WB", ft.MODE_VJ: "VJ", ft.MODE_CS: "CS"}


class Tracker:
    """Usage mirrors the reference (src/main.js:1-27):

        t = Tracker(ui=False, smoothing=True)
        t.init(ClipSource(frames))       # or CameraSource(), or init(None) for camera
        t.start()                        # timer loop; or t.step_once() / t.run_clip()
        ...
        t.stop(); t.stopStream()

    device: where the step runs (default: the card; pass device="cpu" to
    run the kernels' plain twins on the CPU)."""

    def __init__(self, params=None, *, cascade=None, bus=None, device=None,
                 **kw):
        merged = dict(params or {})
        merged.update(kw)
        fields = set(TrackerConfig.__dataclass_fields__)
        unknown = set(merged) - fields
        if unknown:
            raise TypeError(f"unknown Tracker params: {sorted(unknown)}")
        self.config = TrackerConfig(**merged)
        self.device = resolve_device(device)
        self._cascade = cascade if cascade is not None else frontalface()
        self._bus = bus or ev.default_bus

        self.status = ""
        self.stream = None
        self.initialized = False
        self._ui = None
        self._step = None
        self._state = None
        self._modes = None  # host view of the stream's mode (1,) i32
        self._last_out = None
        self._run = False
        self._thread = None
        self._session = 0  # bumped by stop(): in-flight steps discard
        self._detection_timer = None  # wall-clock start of VJ (hints, main.js:188)
        self._hints_sent = False
        self._canvas_size = None

    # -- lifecycle ---------------------------------------------------------

    def _status_event(self, message):
        self.status = message
        self._bus.dispatch_event(ev.STATUS, {"status": message})

    def _reset_state(self):
        """Detection from scratch: a fresh state and its mode view."""
        self._state = ft.init_state(1, self.config.whitebalancing,
                                    device=self.device)
        self._modes = self._state.mode.cpu().numpy()

    def init(self, video=None, canvas=None, setupVideo=True):
        """video: a VideoSource, an (N,H,W,3) u8 array / file path (altVideo
        equivalent), or None to open the camera.  canvas: processing (w, h);
        defaults to the reference's 320/240 normalization of the source size.
        """
        if video is None and setupVideo:
            self._status_event("getUserMedia")
            try:
                video = CameraSource()
                self._status_event("camera found")
                self.stream = video
            except RuntimeError as e:
                self._status_event(str(e))  # "no camera" / "no getUserMedia"
                if self.config.altVideo is not None:
                    # insertAltVideo fallback (src/main.js:132-141): drive the
                    # pipeline from the provided recorded clip instead
                    alt = self.config.altVideo
                    video = (alt if isinstance(alt, VideoSource)
                             else ClipSource(alt))
                else:
                    return False
        elif not isinstance(video, VideoSource):
            video = ClipSource(video)

        self.video = video
        if canvas is None:
            cw, ch = normalize_size(video.width, video.height)
        else:
            cw, ch = canvas
        self._canvas_size = (cw, ch)

        self._step = ft.make_step(self._cascade, self.config, (ch, cw),
                                  "full", with_pdf=self.config.debug,
                                  device=self.device)
        self._reset_state()
        self._last_frame = None
        self._last_pdf = None
        self._video_faded = False

        # re-init drops the previous session's emission state (a second
        # init() must behave like a fresh Tracker: hints can fire again,
        # getFOV/getTrackingObject return nothing until the first frame)
        self._last_out = None
        self._detection_timer = None
        self._hints_sent = False
        self.status = ""
        if self.config.ui and self._ui is None:
            # construct once: each Ui subscribes to the bus, so a per-init
            # construction would leak one listener per re-init
            self._ui = Ui(bus=self._bus)
        self.initialized = True
        return True

    def _capture(self):
        frame = self.video.read()
        if frame is None:
            return None
        ch, cw = self._canvas_size[1], self._canvas_size[0]
        if frame.shape[:2] != (ch, cw):
            frame = resize_rgb(frame, cw, ch)
        return frame

    def step_once(self, frame=None):
        """Process one frame synchronously; returns the StepOutput (host
        scalars).  The core of the track() loop (src/main.js:168-305)."""
        if frame is None:
            frame = self._capture()
            if frame is None:
                return None
        t0 = _time.time()
        gen = self._session
        batch = torch.from_numpy(np.ascontiguousarray(frame)[None])
        res = self._step(self._state, batch.to(self.device), self._modes)
        state, out = res[0], res[1]
        # the frame's one host read: every output (and the pdf), one copy
        # per dtype
        host = HostCopy(list(out) + list(res[2:])).arrays()
        out = ft.StepOutput(*(a[0] for a in host[:len(out)]))
        if self.config.debug:
            self._last_pdf = host[-1][0]
            self._last_frame = np.asarray(frame)
        if gen != self._session:
            # stop() ran while this step was in flight: keep stop()'s
            # detection-from-scratch contract -- discard the result and
            # emit nothing
            self._reset_state()
            return None
        self._state = state
        self._modes = host[ft.StepOutput._fields.index("mode_after")]
        elapsed_ms = int((_time.time() - t0) * 1000)
        self._last_out = out
        self._emit(out, elapsed_ms)
        return out

    def _emit(self, out, elapsed_ms):
        status = int(out.status)
        det = int(out.detection)
        if det == ft.MODE_CS:
            self.status = "tracking"  # src/main.js:227 (attribute only, no event)
            if self._detection_timer is not None:
                self._detection_timer = None
                self._hints_sent = False
            # fadeVideo: on first CS lock the reference fades the displayed
            # video element to 30% opacity (src/main.js:221-224, 368-378);
            # headless equivalent is a fade() hook on the video source.
            if self.config.fadeVideo and not self._video_faded:
                self._video_faded = True
                fade = getattr(self.video, "fade", None)
                if callable(fade):
                    fade()
        if det == ft.MODE_VJ:
            # hints after 5 s of VJ without a lock (src/main.js:188-194)
            if self._detection_timer is None:
                self._detection_timer = _time.time()
            elif (not self._hints_sent
                  and _time.time() - self._detection_timer > 5.0):
                self._status_event("hints")
                self._hints_sent = True
        for bit, name in _STATUS_BITS:
            if status & bit:
                self._status_event(name)
        if bool(out.event_face):
            self._bus.dispatch_event(ev.FACETRACKING, {
                "height": float(out.face_h), "width": float(out.face_w),
                "angle": float(out.face_angle), "x": float(out.face_x),
                "y": float(out.face_y), "confidence": float(out.face_conf),
                "detection": "CS", "time": elapsed_ms,
            })
        if bool(out.head_valid):
            self._bus.dispatch_event(ev.HEADTRACKING, {
                "x": float(out.head_x), "y": float(out.head_y),
                "z": float(out.head_z),
            })
        if bool(int(out.status) & ft.STATUS_LOST):
            self.stop()

    def _loop(self):
        interval = self.config.detectionInterval / 1000.0
        while self._run:
            t0 = _time.time()
            out = self.step_once()
            if out is None:  # end of clip/stream
                self._run = False
                break
            sleep = interval - (_time.time() - t0)
            if sleep > 0:
                _time.sleep(sleep)

    def _starter(self):
        """starter() safety checks (src/main.js:307-326): re-poll every
        100 ms INDEFINITELY until the source yields a non-blank frame
        (whitebalance > 0) -- the reference never gives up; ``stop()``
        cancels the poll.  Returns the first good frame, or None if
        stopped / source exhausted while still blank."""
        while self._run:
            frame = self._capture()
            if frame is None:  # exhausted before ever going non-blank
                return None
            if float(np.mean(frame)) > 0:
                return frame
            _time.sleep(0.1)
        return None

    def start(self):
        """src/main.js:328-345: returns immediately; the starter poll and
        the track loop run on the timer thread (the reference's setTimeout
        chain is likewise asynchronous)."""
        if not self.initialized:
            return False
        if self._run:
            return True  # already running: one loop thread only
        if self._thread is not None and self._thread.is_alive():
            # a stop()-orphaned loop is still finishing an in-flight step
            # (its result discards via _session); a second loop would race
            # it on the session state -- refuse, retry later
            return False
        self._run = True

        def boot():
            first = self._starter()
            if first is not None and self._run:
                self.step_once(first)
                self._loop()
            else:
                self._run = False

        self._thread = threading.Thread(target=boot, daemon=True)
        self._thread.start()
        return True

    def run_clip(self, max_frames=None):
        """Synchronously drive the source to exhaustion (deterministic path
        for tests/benchmarks; no timer thread).  Mutually exclusive with the
        ``start()`` timer loop: two loops would race on the session state
        (src/main.js keeps one setTimeout chain for the same reason)."""
        if self._run or (self._thread is not None and self._thread.is_alive()):
            raise RuntimeError(
                "run_clip() while the start() loop is running: one loop at "
                "a time -- call stop() first")
        n = 0
        while max_frames is None or n < max_frames:
            out = self.step_once()
            if out is None:
                break
            n += 1
            if self.status == "stopped":
                break
        return n

    def stop(self):
        """src/main.js:347-355: stop loop, reset detection from scratch."""
        self._run = False
        self._session += 1  # in-flight steps discard their result
        if (self._thread is not None and self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=5.0)
        self._status_event("stopped")
        if self._state is not None:
            self._reset_state()
        self._detection_timer = None
        self._hints_sent = False
        return True

    def stopStream(self):
        if self.stream is not None:
            self.stream.stop()

    def getFOV(self):
        if self._last_out is None:
            return 0.0
        return float(self._last_out.fov_deg)

    # -- debug / introspection --------------------------------------------

    def get_debug(self):
        """Debug surface (requires Tracker(debug=True)): the reference paints
        the VJ rect (blue) / rotated CS rect (green) and the camshift
        backprojection on the debug canvas every frame
        (src/main.js:199-219, src/facetrackr.js:194-196).

        Returns None before the first frame, else a dict:
          frame          (H, W, 3) u8 -- the processed frame
          overlay        (H, W, 3) u8 -- frame with the VJ/CS rect drawn
          backprojection (H, W, 3) u8 grayscale pdf image
                         floor(255 clip(pdf, 0, 1)), or None (non-CS)
          tracking       the raw tracking dict (getTrackingObject)
        """
        if not self.config.debug:
            raise RuntimeError("get_debug() requires Tracker(debug=True)")
        if self._last_out is None or self._last_frame is None:
            return None
        from ..utils import debugdraw as dd
        out = self._last_out
        is_cs = int(out.detection) == ft.MODE_CS
        overlay = dd.render_debug_frame(self._last_frame, out)
        bp = None
        if is_cs and self._last_pdf is not None:
            val = np.floor(255 * np.clip(self._last_pdf, 0.0, 1.0)
                           ).astype(np.uint8)
            bp = np.stack([val, val, val], axis=-1)
        return dict(frame=np.array(self._last_frame), overlay=overlay,
                    backprojection=bp, tracking=self.getTrackingObject())

    def getTrackingObject(self):
        """Last raw tracking result (facetrackr.getTrackingObject equivalent)."""
        o = self._last_out
        if o is None:
            return None
        return dict(
            detection=_MODE_NAMES[int(o.detection)],
            x=float(o.face_x), y=float(o.face_y),
            width=float(o.face_w), height=float(o.face_h),
            angle=float(o.face_angle), confidence=float(o.face_conf))
