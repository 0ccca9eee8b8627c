"""Head-position estimator oracle (transcription of src/headposition.js).

Pinhole geometry: assumes a 16x19 cm head at 60 cm on init to estimate the camera
FOV from the face diagonal, then per-frame computes (x, y, z) in cm relative to
the center of the screen.  ``head_diag_cam`` is *stateful*: edge-correction corner
cases reuse the previous frame's diagonal (src/headposition.js:111-127).

The benchmark's frozen copy of the port's NumPy oracle
(headtrackr_tpu_torch/oracle/headposition.py): the yardstick that decides
``correct``, kept apart from the program so that no later change to the
program changes it.  It imports numpy alone.  Added to the copy: ``q``,
a rounding of the head position (the lower-precision control's).
"""

import numpy as np

from .precision import exact

__all__ = ["HeadPositionTracker"]

HEAD_WIDTH_CM = 16.0    # src/headposition.js:53
HEAD_HEIGHT_CM = 19.0   # src/headposition.js:54


class HeadPositionTracker:
    def __init__(self, face, camwidth, camheight, fov=None, distance_to_screen=None,
                 edgecorrection=True, distance_from_camera_to_screen=11.5,
                 q=exact):
        self.q = q
        self.camwidth_cam = camwidth
        self.camheight_cam = camheight
        self.edgecorrection = edgecorrection
        self.camera_offset = distance_from_camera_to_screen

        self.head_small_angle = np.arctan(HEAD_WIDTH_CM / HEAD_HEIGHT_CM)
        self.head_diag_cm = np.sqrt(HEAD_WIDTH_CM ** 2 + HEAD_HEIGHT_CM ** 2)
        self.sin_hsa = np.sin(self.head_small_angle)
        self.cos_hsa = np.cos(self.head_small_angle)
        self.tan_hsa = np.tan(self.head_small_angle)

        init_w = face["width"]
        init_h = face["height"]
        self.head_diag_cam = np.sqrt(init_w * init_w + init_h * init_h)
        if fov is None:
            # estimate FOV from face diagonal (src/headposition.js:69-81)
            head_width_cam = self.sin_hsa * self.head_diag_cam
            camwidth_at_default_face_cm = (camwidth / head_width_cam) * HEAD_WIDTH_CM
            if distance_to_screen is None:
                distance_to_screen = 60.0
            self.fov_width = np.arctan((camwidth_at_default_face_cm / 2) / distance_to_screen) * 2
        else:
            self.fov_width = fov * np.pi / 180.0
        self.tan_fov_width = 2 * np.tan(self.fov_width / 2)
        self.x = self.y = self.z = None

    def track(self, face):
        w = face["width"]
        h = face["height"]
        fx = face["x"]
        fy = face["y"]

        if self.edgecorrection:
            margin = 11
            left = fx - w / 2
            right = self.camwidth_cam - (fx + w / 2)
            top = fy - h / 2
            bottom = self.camheight_cam - (fy + h / 2)
            on_v = left < margin or right < margin
            on_h = top < margin or bottom < margin

            if on_h:
                if on_v:
                    # corner: keep previous head_diag_cam (src/headposition.js:111-127)
                    if left < margin:
                        fx = w - (self.head_diag_cam * self.sin_hsa / 2)
                    else:
                        fx = fx - w / 2 + self.head_diag_cam * self.sin_hsa / 2
                    if top < margin:
                        fy = h - (self.head_diag_cam * self.cos_hsa / 2)
                    else:
                        fy = fy - h / 2 + self.head_diag_cam * self.cos_hsa / 2
                else:
                    if top < margin:
                        ow = top / margin
                        ew = (margin - top) / margin
                        fy = h - (ow * h / 2 + ew * ((w / self.tan_hsa) / 2))
                        self.head_diag_cam = ew * (w / self.sin_hsa) + ow * np.sqrt(w * w + h * h)
                    else:
                        ow = bottom / margin
                        ew = (margin - bottom) / margin
                        fy = fy - h / 2 + (ow * h / 2 + ew * ((w / self.tan_hsa) / 2))
                        self.head_diag_cam = ew * (w / self.sin_hsa) + ow * np.sqrt(w * w + h * h)
            elif on_v:
                if left < margin:
                    ow = left / margin
                    ew = (margin - left) / margin
                    self.head_diag_cam = ew * (h / self.cos_hsa) + ow * np.sqrt(w * w + h * h)
                    fx = w - (ow * w / 2 + ew * (h * self.tan_hsa / 2))
                else:
                    ow = right / margin
                    ew = (margin - right) / margin
                    self.head_diag_cam = ew * (h / self.cos_hsa) + ow * np.sqrt(w * w + h * h)
                    fx = fx - w / 2 + (ow * w / 2 + ew * (h * self.tan_hsa / 2))
            else:
                self.head_diag_cam = np.sqrt(w * w + h * h)
        else:
            self.head_diag_cam = np.sqrt(w * w + h * h)

        z = (self.head_diag_cm * self.camwidth_cam) / (self.tan_fov_width * self.head_diag_cam)
        x = -((fx / self.camwidth_cam) - 0.5) * z * self.tan_fov_width
        y = -((fy / self.camheight_cam) - 0.5) * z * self.tan_fov_width \
            * (self.camheight_cam / self.camwidth_cam)
        y = y + self.camera_offset

        x, y, z = self.q(x), self.q(y), self.q(z)
        self.x, self.y, self.z = x, y, z
        return dict(x=x, y=y, z=z)

    def get_fov(self):
        return self.fov_width * 180 / np.pi
