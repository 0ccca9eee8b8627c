"""Frame sources: the getUserMedia / <video> / altVideo equivalents.

The reference acquires frames from a webcam (src/main.js:99-151) with an
``altVideo`` recorded-clip fallback (src/main.js:79-97) — its only
fixture/fake-backend mechanism.  Here sources are explicit objects with a
uniform interface; the runtime normalizes them to the reference's working
resolution (width -> 320 landscape / height -> 240 portrait,
src/main.js:144-150).  The port's copy of headtrackr_tpu/runtime/video.py,
all host NumPy; OpenCV is optional and imported only to open a camera or
decode a video file.
"""

import numpy as np

__all__ = ["VideoSource", "ClipSource", "SyntheticFaceSource", "CameraSource",
           "resize_rgb", "normalize_size"]


def normalize_size(w, h):
    """src/main.js:144-150: landscape videos are scaled to width 320,
    portrait to height 240 (aspect preserved, rounded)."""
    if w > h:
        return 320, max(1, round(h * 320 / w))
    return max(1, round(w * 240 / h)), 240


class VideoSource:
    """Interface: read() -> (H, W, 3) u8 frame or None at end-of-stream."""

    width = 0
    height = 0

    def read(self):
        raise NotImplementedError

    def stop(self):
        pass

    @property
    def playing(self):
        return True


class ClipSource(VideoSource):
    """Frames from an in-memory array/list, a .npy/.npz file, or a video
    file (any container OpenCV can decode) — the altVideo equivalent
    (src/main.js:79-97) and the deterministic test fixture.

    Video files are decoded eagerly to one (T, H, W, 3) u8 array so read()
    and rewind() keep array semantics (`max_frames` bounds memory for long
    files).  Decoding requires OpenCV: like CameraSource, a missing cv2
    raises RuntimeError("no getUserMedia") so the runtime's support-status
    mapping applies."""

    def __init__(self, frames, loop=False, max_frames=None):
        if isinstance(frames, str):
            if frames.endswith(".npz"):
                frames = np.load(frames)["frames"]
            elif frames.endswith(".npy"):
                frames = np.load(frames)
            else:
                frames = _decode_video(frames, max_frames)
        self.frames = np.asarray(frames)
        if (self.frames.ndim != 4 or self.frames.shape[-1] != 3
                or self.frames.dtype != np.uint8):
            raise ValueError(f"clip must be (T, H, W, 3) uint8, got "
                             f"{self.frames.shape} {self.frames.dtype}")
        self.loop = loop
        self.pos = 0
        self.height, self.width = self.frames.shape[1:3]

    def read(self):
        if self.pos >= len(self.frames):
            if not self.loop:
                return None
            self.pos = 0
        f = self.frames[self.pos]
        self.pos += 1
        return f

    def rewind(self):
        self.pos = 0


def _decode_video(path, max_frames=None):
    """Decode a video file to (T, H, W, 3) u8 RGB via OpenCV (optional).
    Raises RuntimeError on missing cv2 / unreadable file so callers get the
    same support-status mapping as CameraSource."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("no getUserMedia") from e
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video file: {path}")
    out = []
    try:
        while max_frames is None or len(out) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            out.append(np.ascontiguousarray(frame[..., ::-1]))  # BGR -> RGB
    finally:
        cap.release()
    if not out:
        raise RuntimeError(f"no decodable frames in: {path}")
    return np.stack(out)


class SyntheticFaceSource(VideoSource):
    """A moving bright square on a dark background — drives the toy cascade
    through the full WB -> VJ -> CS lifecycle without real imagery."""

    def __init__(self, width=320, height=240, size=48, speed=1.0,
                 color=(230, 80, 60), bg=40, n_frames=None, still_frames=20):
        self.width = width
        self.height = height
        self.size = size
        self.speed = speed
        self.color = color
        self.bg = bg
        self.n_frames = n_frames
        self.still_frames = still_frames
        self.t = 0

    def read(self):
        if self.n_frames is not None and self.t >= self.n_frames:
            return None
        f = np.full((self.height, self.width, 3), self.bg, np.uint8)
        tt = max(0, self.t - self.still_frames)  # hold still for WB + VJ lock
        cx = int(self.width * 0.35 + (tt * self.speed) % (self.width * 0.3))
        cy = int(self.height * 0.45 + 10 * np.sin(tt * 0.05))
        s = self.size // 2
        f[max(0, cy - s):cy + s, max(0, cx - s):cx + s] = self.color
        self.t += 1
        return f


class CameraSource(VideoSource):
    """Webcam via OpenCV when available; the getUserMedia equivalent.

    Raises RuntimeError("no getUserMedia") without OpenCV and
    RuntimeError("no camera") when the device fails to open — the runtime
    maps that to the status + altVideo fallback (src/main.js:132-135)."""

    def __init__(self, index=0):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("no getUserMedia") from e
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(index)
        if not self._cap.isOpened():
            raise RuntimeError("no camera")
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def read(self):
        ok, frame = self._cap.read()
        if not ok:
            return None
        return np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB

    def stop(self):
        self._cap.release()


def resize_rgb(frame, w, h):
    """Host source -> canvas normalization (shared by Tracker._capture and
    BatchedSession._fill_batch): the reference's interpolated ``drawImage``
    capture scaling (src/main.js:144-150,168-170), realized with the defined
    bilinear resampler of the pyramid (docs/PARITY.md deviation 2:
    half-pixel centers, f32 weights, round-half-even to u8), per channel."""
    frame = np.asarray(frame)
    H, W = frame.shape[:2]
    if (H, W) == (h, w):
        return frame
    rx = np.float32(W) / np.float32(w)
    ry = np.float32(H) / np.float32(h)
    xs = np.clip((np.arange(w, dtype=np.float32) + np.float32(0.5)) * rx
                 - np.float32(0.5), 0, W - 1)
    ys = np.clip((np.arange(h, dtype=np.float32) + np.float32(0.5)) * ry
                 - np.float32(0.5), 0, H - 1)
    x0 = np.floor(xs).astype(np.int32)
    y0 = np.floor(ys).astype(np.int32)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = (xs - x0.astype(np.float32)).astype(np.float32)[None, :, None]
    fy = (ys - y0.astype(np.float32)).astype(np.float32)[:, None, None]
    s = frame.astype(np.float32)
    top = s[np.ix_(y0, x0)] * (1 - fx) + s[np.ix_(y0, x1)] * fx
    bot = s[np.ix_(y1, x0)] * (1 - fx) + s[np.ix_(y1, x1)] * fx
    val = top * (1 - fy) + bot * fy
    return np.rint(np.clip(val, 0, 255)).astype(np.uint8)
