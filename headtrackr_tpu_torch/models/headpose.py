"""Head-position estimation over a batch of streams (spec: src/headposition.js).

State is two per-stream scalars carried in the tracker state:
  - tan_fov_width (precomputed 2*tan(fov/2), src/headposition.js:87)
  - head_diag_cam (stateful: corner edge-correction reuses the previous frame's
    diagonal, src/headposition.js:111-127)
Inputs are f32 tensors of one shape; python-float constants stay f32.
"""

import numpy as np
import torch

__all__ = ["estimate_fov_width", "track_head", "HEAD_WIDTH_CM", "HEAD_HEIGHT_CM"]

HEAD_WIDTH_CM = 16.0   # src/headposition.js:53
HEAD_HEIGHT_CM = 19.0  # src/headposition.js:54
_HSA = float(np.arctan(HEAD_WIDTH_CM / HEAD_HEIGHT_CM))
HEAD_DIAG_CM = float(np.sqrt(HEAD_WIDTH_CM ** 2 + HEAD_HEIGHT_CM ** 2))
SIN_HSA = float(np.sin(_HSA))
COS_HSA = float(np.cos(_HSA))
TAN_HSA = float(np.tan(_HSA))
EDGE_MARGIN = 11.0     # src/headposition.js:101


def estimate_fov_width(face_w, face_h, camwidth, distance_to_screen=60.0):
    """FOV estimate from the face diagonal (src/headposition.js:66-81), radians.
    camwidth is an f32 tensor (kept f32 like the face sizes)."""
    head_diag_cam = torch.sqrt(face_w * face_w + face_h * face_h)
    head_width_cam = SIN_HSA * head_diag_cam
    camwidth_at_default_face_cm = (camwidth / head_width_cam) * HEAD_WIDTH_CM
    return torch.atan((camwidth_at_default_face_cm / 2) / distance_to_screen) * 2


def track_head(face_x, face_y, face_w, face_h, head_diag_cam, tan_fov_width,
               camwidth, camheight, camera_offset=11.5, edgecorrection=True):
    """One head-position step (src/headposition.js:91-191).

    Returns (x, y, z, new_head_diag_cam).  face_x/face_y are the face center,
    face_w/face_h the face box size, all in camera px; camwidth/camheight are
    f32 tensors."""
    w, h, fx, fy = face_w, face_h, face_x, face_y
    diag = torch.sqrt(w * w + h * h)

    if edgecorrection:
        m = EDGE_MARGIN
        left = fx - w / 2
        right = camwidth - (fx + w / 2)
        top = fy - h / 2
        bottom = camheight - (fy + h / 2)
        on_v = (left < m) | (right < m)
        on_h = (top < m) | (bottom < m)

        # corner: keep previous diagonal (src/headposition.js:111-127)
        c_fx = torch.where(left < m, w - head_diag_cam * SIN_HSA / 2,
                           fx - w / 2 + head_diag_cam * SIN_HSA / 2)
        c_fy = torch.where(top < m, h - head_diag_cam * COS_HSA / 2,
                           fy - h / 2 + head_diag_cam * COS_HSA / 2)

        # top/bottom edge (src/headposition.js:130-143)
        t_ow = torch.where(top < m, top, bottom) / m
        t_ew = 1.0 - t_ow
        hb_fy = torch.where(
            top < m,
            h - (t_ow * h / 2 + t_ew * ((w / TAN_HSA) / 2)),
            fy - h / 2 + (t_ow * h / 2 + t_ew * ((w / TAN_HSA) / 2)))
        hb_diag = t_ew * (w / SIN_HSA) + t_ow * diag

        # left/right edge (src/headposition.js:144-156)
        v_ow = torch.where(left < m, left, right) / m
        v_ew = 1.0 - v_ow
        v_fx = torch.where(
            left < m,
            w - (v_ow * w / 2 + v_ew * (h * TAN_HSA / 2)),
            fx - w / 2 + (v_ow * w / 2 + v_ew * (h * TAN_HSA / 2)))
        v_diag = v_ew * (h / COS_HSA) + v_ow * diag

        new_fx = torch.where(on_h & on_v, c_fx,
                             torch.where(on_v & ~on_h, v_fx, fx))
        new_fy = torch.where(on_h & on_v, c_fy,
                             torch.where(on_h & ~on_v, hb_fy, fy))
        new_diag = torch.where(
            on_h & on_v, head_diag_cam,
            torch.where(on_h, hb_diag, torch.where(on_v, v_diag, diag)))
        fx, fy, head_diag_cam = new_fx, new_fy, new_diag
    else:
        head_diag_cam = diag

    z = (HEAD_DIAG_CM * camwidth) / (tan_fov_width * head_diag_cam)
    x = -((fx / camwidth) - 0.5) * z * tan_fov_width
    y = (-((fy / camheight) - 0.5) * z * tan_fov_width * (camheight / camwidth)
         + camera_offset)
    return x, y, z, head_diag_cam
