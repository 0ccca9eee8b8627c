"""Head-coupled-perspective camera controllers (spec: src/controllers.js);
the port's copy of headtrackr_tpu/controllers.py (host math, no device work).

The reference drives a THREE.js PerspectiveCamera from headtrackingEvent to
create a pseudo-3D "window" effect.  Here the same math is exposed as pure
functions event -> camera pose (position, asymmetric-frustum view offset, fov),
renderer-agnostic; plus subscription helpers that mirror the reference's
addEventListener wiring.

Poses use the reference's conventions: ``fixed_position`` is the screen's
position in model space, ``scaling`` the model-units-per-cm factor,
``screen_height`` the physical screen height in cm (default 20,
src/controllers.js:26-31).
"""

import dataclasses
import math

from .runtime import events as ev

__all__ = ["CameraPose", "realistic_absolute_camera_pose",
           "realistic_relative_camera_offset",
           "RealisticAbsoluteCameraControl", "RealisticRelativeCameraControl",
           "three"]


@dataclasses.dataclass
class CameraPose:
    position: tuple          # (x, y, z) in model space
    view_offset: tuple       # (full_w, full_h, offset_x, offset_y, w, h)
    fov: float               # degrees (vertical)


def realistic_absolute_camera_pose(head, scaling, fixed_position, aspect,
                                   screen_height=20.0, damping=1.0):
    """src/controllers.js:48-67: screen fixed in world space.

    head: object/dict with x, y, z (cm, from headtrackingEvent)."""
    hx, hy, hz = _xyz(head)
    wh = screen_height * scaling
    ww = wh * aspect

    x_off = 0.0 if hx > 0 else -hx * 2 * damping * scaling
    y_off = hy * 2 * damping * scaling if hy >= 0 else 0.0
    view_offset = (ww + abs(hx * 2 * damping * scaling),
                   wh + abs(hy * damping * 2 * scaling),
                   x_off, y_off, ww, wh)
    position = (fixed_position[0] + hx * scaling * damping,
                fixed_position[1] + hy * scaling * damping,
                fixed_position[2] + hz * scaling)
    fov = math.atan((wh / 2 + abs(hy * scaling * damping))
                    / abs(hz * scaling)) * 360 / math.pi
    return CameraPose(position, view_offset, fov)


def realistic_relative_camera_offset(head, scaling, relative_fixed_distance,
                                     aspect, screen_height=20.0):
    """src/controllers.js:113-137: screen fixed relative to the camera rig.

    Returns (offset_translation, view_offset, fov): the offset object's local
    translation (applied in camera rotation frame by the caller)."""
    hx, hy, hz = _xyz(head)
    wh = screen_height * scaling
    ww = wh * aspect

    x_off = 0.0 if hx > 0 else -hx * 2 * scaling
    y_off = 0.0 if hy > 0 else -hy * 2 * scaling
    view_offset = (ww + abs(hx * 2 * scaling), wh + abs(hy * 2 * scaling),
                   x_off, y_off, ww, wh)
    translation = (hx * scaling, hy * scaling,
                   hz * scaling + relative_fixed_distance)
    fov = math.atan((wh / 2 + abs(hy * scaling))
                    / abs(hz * scaling)) * 360 / math.pi
    return translation, view_offset, fov


def _xyz(head):
    if isinstance(head, dict):
        return head["x"], head["y"], head["z"]
    return head.x, head.y, head.z


class RealisticAbsoluteCameraControl:
    """Subscription wrapper mirroring
    headtrackr.controllers.three.realisticAbsoluteCameraControl
    (src/controllers.js:28-68).  ``camera`` is any object accepting
    apply(pose: CameraPose); a THREE-like adapter works directly."""

    def __init__(self, camera, scaling, fixed_position, look_at=None,
                 params=None, bus=None):
        params = params or {}
        self.camera = camera
        self.scaling = scaling
        self.fixed_position = tuple(fixed_position)
        self.screen_height = params.get("screenHeight", 20.0)
        self.damping = params.get("damping", 1.0)
        self.last_pose = None
        self._bus = bus or ev.default_bus
        self._bus.add_event_listener(ev.HEADTRACKING, self._on_head)

    def _on_head(self, event):
        pose = realistic_absolute_camera_pose(
            event, self.scaling, self.fixed_position,
            getattr(self.camera, "aspect", 16 / 9),
            self.screen_height, self.damping)
        self.last_pose = pose
        if hasattr(self.camera, "apply"):
            self.camera.apply(pose)

    def close(self):
        self._bus.remove_event_listener(ev.HEADTRACKING, self._on_head)


class RealisticRelativeCameraControl:
    """src/controllers.js:85-138 equivalent."""

    def __init__(self, camera, scaling, relative_fixed_distance, params=None,
                 bus=None):
        params = params or {}
        self.camera = camera
        self.scaling = scaling
        self.relative_fixed_distance = relative_fixed_distance
        self.screen_height = params.get("screenHeight", 20.0)
        self.last = None
        self._bus = bus or ev.default_bus
        self._bus.add_event_listener(ev.HEADTRACKING, self._on_head)

    def _on_head(self, event):
        out = realistic_relative_camera_offset(
            event, self.scaling, self.relative_fixed_distance,
            getattr(self.camera, "aspect", 16 / 9), self.screen_height)
        self.last = out
        if hasattr(self.camera, "apply_relative"):
            self.camera.apply_relative(*out)

    def close(self):
        self._bus.remove_event_listener(ev.HEADTRACKING, self._on_head)


class _ThreeNamespace:
    """headtrackr.controllers.three parity aliases."""
    realisticAbsoluteCameraControl = RealisticAbsoluteCameraControl
    realisticRelativeCameraControl = RealisticRelativeCameraControl


three = _ThreeNamespace()
