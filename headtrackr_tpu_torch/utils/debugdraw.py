"""Debug rendering: the reference's debug-canvas equivalent.

The reference paints the VJ rect in blue and the rotated CS rect in green on a
caller-provided canvas (src/main.js:199-219) plus the camshift backprojection
image (src/facetrackr.js:194-196).  These helpers produce the same overlays on
NumPy frames for headless inspection / video dumps.  The port's copy of
headtrackr_tpu/utils/debugdraw.py (host NumPy).
"""

import numpy as np

__all__ = ["draw_box", "draw_rotated_box", "render_debug_frame"]

VJ_COLOR = (0, 0, 204)    # #0000CC (src/main.js:201)
CS_COLOR = (0, 204, 0)    # #00CC00 (src/main.js:215)


def draw_box(frame, x, y, w, h, color=VJ_COLOR, thickness=1):
    """Stroke an axis-aligned rect (corner x,y) in place; returns frame."""
    H, W = frame.shape[:2]
    x0, y0 = int(round(x)), int(round(y))
    x1, y1 = int(round(x + w)), int(round(y + h))
    x0, x1 = np.clip([x0, x1], 0, W - 1)
    y0, y1 = np.clip([y0, y1], 0, H - 1)
    for t in range(thickness):
        frame[np.clip(y0 + t, 0, H - 1), x0:x1 + 1] = color
        frame[np.clip(y1 - t, 0, H - 1), x0:x1 + 1] = color
        frame[y0:y1 + 1, np.clip(x0 + t, 0, W - 1)] = color
        frame[y0:y1 + 1, np.clip(x1 - t, 0, W - 1)] = color
    return frame


def draw_rotated_box(frame, cx, cy, w, h, angle, color=CS_COLOR):
    """Stroke a rotated rect centered at (cx, cy); the reference rotates by
    (angle - pi/2) around the center (src/main.js:213-218)."""
    H, W = frame.shape[:2]
    a = angle - np.pi / 2
    c, s = np.cos(a), np.sin(a)
    corners = np.array([[-w / 2, -h / 2], [w / 2, -h / 2],
                        [w / 2, h / 2], [-w / 2, h / 2]])
    rot = corners @ np.array([[c, -s], [s, c]]).T + [cx, cy]
    for i in range(4):
        x0, y0 = rot[i]
        x1, y1 = rot[(i + 1) % 4]
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
        xs = np.clip(np.linspace(x0, x1, n).round().astype(int), 0, W - 1)
        ys = np.clip(np.linspace(y0, y1, n).round().astype(int), 0, H - 1)
        frame[ys, xs] = color
    return frame


def render_debug_frame(frame, out, backprojection=None):
    """Compose the reference's debug view for one StepOutput: VJ rect (blue) or
    rotated CS rect (green) over the frame; optionally paste the backprojection
    image alongside.  Returns a new array."""
    img = np.array(frame)
    det = int(out.detection)
    if det == 1 and float(out.face_conf) > -10000:  # VJ
        draw_box(img, float(out.face_x), float(out.face_y),
                 float(out.face_w), float(out.face_h), VJ_COLOR)
    elif det == 2:  # CS: x,y is the center
        draw_rotated_box(img, float(out.face_x), float(out.face_y),
                         float(out.face_w), float(out.face_h),
                         float(out.face_angle) if np.isfinite(
                             float(out.face_angle)) else np.pi / 2)
    if backprojection is not None:
        bp = (np.floor(255 * np.asarray(backprojection))
              .astype(np.uint8)[..., None].repeat(3, -1))
        img = np.concatenate([img, bp], axis=1)
    return img
