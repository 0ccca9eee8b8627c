"""The plain PyTorch twin of the ``tick_epilogue`` CUDA kernel
(kernels/epilogue.py, csrc/epilogue.cu): the end of a tick, from the mean
shift's moments (or the branches' merged result) to the new state and the
step's outputs, used for CPU tensors and as the kernel's reference on the
card.

  * ``finish_plain``: camshift's size and orientation from the central
    moments, the output box and the 1.1x window growth
    (src/camshift.js:230-258; headtrackr_tpu/models/camshift.py ``_finish``).
  * ``supervise_plain``: the supervision after the mode branches
    (src/main.js:168-305; headtrackr_tpu/models/facetracker.py
    ``full_step``, lines 288-397): status bits, loss and retry, face_found,
    EMA smoothing, the 6-deep head-diagonal ring and its stability gate,
    FOV caching, head position (``estimate_fov_width``, ``track_head``:
    src/headposition.js).
  * ``track_plain``: the "track" step's whole end, both of the above with
    the freeze of the streams not in CS between them.

Float order (F17): each expression is evaluated as Python parses it, one
f32 rounding an operation (no fused multiply-add): ``a * b / 2`` is the
product, then the halving; ``alpha * cur + (1 - alpha) * sp0`` rounds
``1 - alpha`` on its own.  A Python float enters as its f32 value.  A
quotient by a constant divides by a 0-dim tensor of its f32 value on the
operands' device (``_const``): IEEE division on every device, where
PyTorch's CUDA ops would multiply by the reciprocal of a Python scalar
divisor (F6).  ``sqrt``, ``atan2``, ``atan`` and ``tan`` are PyTorch's,
which on the card call the CUDA math library's ``sqrtf``, ``atan2f``,
``atanf`` and ``tanf``, the kernel's own: the kernel equals this twin run
on the card to the bit.  On the CPU these four are the CPU's, within an
ulp of the card's; the camshift angle is held by F11 (1e-5), every other
float field to rtol 1e-5 / atol 1e-4.  A zero-mass stream's angle is NaN
(F3: its sizes are 0).
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Epilogue", "epilogue_config", "finish_plain", "supervise_plain",
           "track_plain", "estimate_fov_width", "track_head", "VARIANTS",
           "HEAD_WIDTH_CM", "HEAD_HEIGHT_CM", "HEAD_DIAG_CM", "SIN_HSA",
           "COS_HSA", "TAN_HSA", "EDGE_MARGIN", "DIAG_LENGTH"]

MODE_WB, MODE_VJ, MODE_CS = 0, 1, 2
STATUS_WHITEBALANCE, STATUS_DETECTING, STATUS_FOUND = 1, 2, 4
STATUS_REDETECTING, STATUS_LOST = 8, 16
DIAG_LENGTH = 6                # src/main.js:271

HEAD_WIDTH_CM = 16.0   # src/headposition.js:53
HEAD_HEIGHT_CM = 19.0  # src/headposition.js:54
_HSA = float(np.arctan(HEAD_WIDTH_CM / HEAD_HEIGHT_CM))
HEAD_DIAG_CM = float(np.sqrt(HEAD_WIDTH_CM ** 2 + HEAD_HEIGHT_CM ** 2))
SIN_HSA = float(np.sin(_HSA))
COS_HSA = float(np.cos(_HSA))
TAN_HSA = float(np.tan(_HSA))
EDGE_MARGIN = 11.0     # src/headposition.js:101

# the step variants whose supervision differs: "track" freezes the streams
# not in CS (no status), "wbtrack" its VJ streams; "full" and "pending"
# report every stream
VARIANTS = ("full", "pending", "track", "wbtrack")

_F32 = torch.float32
_I32 = torch.int32


class Epilogue(NamedTuple):
    """What the epilogue reads of a step's static configuration
    (TrackerConfig's flags and constants, the frame's size)."""
    calc_angles: bool
    retry: bool                 # retryDetection
    smoothing: bool
    head_position: bool         # headPosition
    fov: Optional[float]        # degrees, or None: estimated at activation
    edgecorrection: bool
    send_events: bool           # sendEvents
    alpha: float                # smoothingAlpha
    camera_offset: float        # cameraOffset
    distance: float             # distance_to_screen
    H: int
    W: int


def epilogue_config(config, frame_shape):
    """The ``Epilogue`` of a TrackerConfig and a frame shape (H, W)."""
    H, W = frame_shape
    return Epilogue(
        calc_angles=bool(config.calcAngles),
        retry=bool(config.retryDetection), smoothing=bool(config.smoothing),
        head_position=bool(config.headPosition),
        fov=None if config.fov is None else float(config.fov),
        edgecorrection=bool(config.edgecorrection),
        send_events=bool(config.sendEvents),
        alpha=float(config.smoothingAlpha),
        camera_offset=float(config.cameraOffset),
        distance=float(config.distance_to_screen), H=int(H), W=int(W))


def _const(v, like):
    """``v`` as a 0-dim f32 tensor on ``like``'s device (a divisor)."""
    return torch.full((), v, dtype=_F32, device=like.device)


def _sqrt_shl2(v, bad):
    """JS ``Math.sqrt(v) << 2``: trunc(sqrt(v)) * 4; NaN (v<0 or zero-mass) -> 0."""
    ok = (~bad) & (v >= 0) & torch.isfinite(v)
    r = torch.sqrt(torch.clamp(v, min=0.0))
    return torch.where(ok, torch.trunc(r) * 4, 0.0).to(_I32)


def finish_plain(win, m, zero_mass, calc_angles, H, W):
    """Size/orientation from central moments + output box + 1.1x window
    growth (src/camshift.js:230-258).  win (N, 4) i32, the mean shift's
    window; m its moments ({"mu20", "mu02", "mu11", "invM00": (N,) f32}),
    zero_mass (N,) bool.  Returns (window (N, 4) i32, track_x, track_y,
    track_w, track_h (N,) i32, track_angle (N,) f32)."""
    a = m["mu20"] * m["invM00"]
    c = m["mu02"] * m["invM00"]
    if calc_angles:
        b = m["mu11"] * m["invM00"]
        d = a + c
        e = torch.sqrt((4 * b * b) + ((a - c) * (a - c)))
        tw = _sqrt_shl2((d - e) * 0.5, zero_mass)
        th = _sqrt_shl2((d + e) * 0.5, zero_mass)
        ang = torch.atan2(2 * b, a - c + e)
        ang = torch.where(ang < 0, ang + math.pi, ang)
        ang = torch.where(zero_mass, math.nan, ang)
    else:
        tw = _sqrt_shl2(a, zero_mass)
        th = _sqrt_shl2(c, zero_mass)
        ang = torch.full_like(a, math.pi / 2)

    fw = win[:, 2].to(_F32)
    fh = win[:, 3].to(_F32)
    tx = torch.floor(torch.clamp(win[:, 0].to(_F32) + fw / 2, 0, W)).to(_I32)
    ty = torch.floor(torch.clamp(win[:, 1].to(_F32) + fh / 2, 0, H)).to(_I32)
    new_w = torch.floor(1.1 * tw.to(_F32)).to(_I32)
    new_h = torch.floor(1.1 * th.to(_F32)).to(_I32)
    win = torch.stack([win[:, 0], win[:, 1], new_w, new_h], dim=1)
    return win, tx, ty, tw, th, ang.to(_F32)


def estimate_fov_width(face_w, face_h, camwidth, distance_to_screen=60.0):
    """FOV estimate from the face diagonal (src/headposition.js:66-81),
    radians.  camwidth is an f32 tensor; distance_to_screen a float or an
    f32 tensor."""
    if not torch.is_tensor(distance_to_screen):
        distance_to_screen = _const(distance_to_screen, face_w)
    head_diag_cam = torch.sqrt(face_w * face_w + face_h * face_h)
    head_width_cam = SIN_HSA * head_diag_cam
    camwidth_at_default_face_cm = (camwidth / head_width_cam) * HEAD_WIDTH_CM
    return torch.atan((camwidth_at_default_face_cm / 2) / distance_to_screen) * 2


def track_head(face_x, face_y, face_w, face_h, head_diag_cam, tan_fov_width,
               camwidth, camheight, camera_offset=11.5, edgecorrection=True):
    """One head-position step (src/headposition.js:91-191).

    Returns (x, y, z, new_head_diag_cam).  face_x/face_y are the face
    center, face_w/face_h the face box size, all in camera px;
    camwidth/camheight are f32 tensors."""
    w, h, fx, fy = face_w, face_h, face_x, face_y
    diag = torch.sqrt(w * w + h * h)

    if edgecorrection:
        m = EDGE_MARGIN
        m_t = _const(m, w)
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
        t_ow = torch.where(top < m, top, bottom) / m_t
        t_ew = 1.0 - t_ow
        w_tan = (w / _const(TAN_HSA, w)) / 2
        hb_fy = torch.where(
            top < m,
            h - (t_ow * h / 2 + t_ew * w_tan),
            fy - h / 2 + (t_ow * h / 2 + t_ew * w_tan))
        hb_diag = t_ew * (w / _const(SIN_HSA, w)) + t_ow * diag

        # left/right edge (src/headposition.js:144-156)
        v_ow = torch.where(left < m, left, right) / m_t
        v_ew = 1.0 - v_ow
        v_fx = torch.where(
            left < m,
            w - (v_ow * w / 2 + v_ew * (h * TAN_HSA / 2)),
            fx - w / 2 + (v_ow * w / 2 + v_ew * (h * TAN_HSA / 2)))
        v_diag = v_ew * (h / _const(COS_HSA, h)) + v_ow * diag

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


def supervise_plain(state, entry_mode, res, ep, variant="full",
                    escaped=None):
    """The supervision after the mode branches (src/main.js:168-305) for
    every stream: ``state`` the branches' merged TrackerState, entry_mode
    (N,) i32 the mode each stream entered the step in, ``res`` the merged
    result (x, y, w, h, angle, conf, wb: (N,) f32), ``ep`` an Epilogue,
    ``variant`` one of VARIANTS, ``escaped`` (N,) bool or None (the band
    step's flags).

    Returns (state', the StepOutput's fields as a dict, escaped & in CS or
    None).  A leaf the supervision leaves alone is passed through as the
    same tensor (wb_ring, wb_n, cs, pend_age; stopped under retry; sm_sp
    and sm_init without smoothing), and the result's fields are the
    output's."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    dev = entry_mode.device
    N = entry_mode.shape[0]
    # copies: an output must not alias the input state, which a caller
    # may overwrite in place (the serving graphs' donated buffers)
    detection = entry_mode.clone()
    zeros_i = torch.zeros((N,), dtype=_I32, device=dev)
    camw = _const(ep.W, res.x)
    camh = _const(ep.H, res.x)

    status = torch.where(detection == MODE_WB, STATUS_WHITEBALANCE, zeros_i)
    status = status | torch.where(
        state.first_run & (detection == MODE_VJ), STATUS_DETECTING, zeros_i)
    if variant == "track":  # frozen non-CS streams emit nothing
        status = torch.where(detection == MODE_CS, status, zeros_i)
    elif variant == "wbtrack":  # frozen VJ streams emit nothing
        status = torch.where(detection != MODE_VJ, status, zeros_i)

    is_cs = detection == MODE_CS
    conf_gate = res.conf != 0  # src/main.js:186
    lost = is_cs & conf_gate & ((res.w == 0) | (res.h == 0))
    tracking = is_cs & conf_gate & ~lost

    # --- loss / retry (src/main.js:230-248)
    if ep.retry:
        status = status | torch.where(lost, STATUS_REDETECTING, zeros_i)
        mode_after = torch.where(lost, MODE_VJ, state.mode).to(_I32)
        stopped = state.stopped
    else:
        status = status | torch.where(lost, STATUS_LOST, zeros_i)
        mode_after = state.mode.clone()
        stopped = state.stopped | lost
    face_found = state.face_found & ~lost
    headpose_active = state.headpose_active & ~lost

    # --- found + smoothing (src/main.js:250-261)
    status = status | torch.where(tracking & ~state.face_found,
                                  STATUS_FOUND, zeros_i)
    face_found = face_found | tracking

    zero = torch.zeros_like(res.x)
    cur = torch.stack([res.x, res.y, zero, res.w, res.h], dim=1)
    if ep.smoothing:
        alpha = _const(ep.alpha, res.x)
        t1 = tracking[:, None]
        sp0 = torch.where(state.sm_init[:, None], state.sm_sp, cur)
        sp1 = alpha * cur + (1 - alpha) * sp0
        sm_sp = torch.where(t1, sp1, state.sm_sp)
        sm_init = state.sm_init | tracking
        smoothed = torch.where(t1, sp1, cur)
    else:
        sm_sp = state.sm_sp
        sm_init = state.sm_init
        smoothed = cur
    sx, sy, sw, sh = (smoothed[:, 0], smoothed[:, 1], smoothed[:, 3],
                      smoothed[:, 4])

    # --- head-diagonal stability gate + FOV (src/main.js:263-297)
    diag = torch.sqrt(sw * sw + sh * sh)
    gate = tracking & ~headpose_active & ep.head_position
    ring_full = state.diag_n >= DIAG_LENGTH
    rolled = torch.cat([state.diag_ring[:, 1:], diag[:, None]], dim=1)
    slot = torch.clamp(state.diag_n, max=DIAG_LENGTH - 1).long()
    filled = state.diag_ring.scatter(1, slot[:, None], diag[:, None])
    pushed = torch.where(ring_full[:, None], rolled, filled)
    diag_ring = torch.where(gate[:, None], pushed, state.diag_ring)
    diag_n = torch.where(gate, torch.clamp(state.diag_n + 1, max=DIAG_LENGTH),
                         state.diag_n)
    stable = gate & ring_full & (
        (pushed.amax(dim=1) - pushed.amin(dim=1)) < 5.0)

    if ep.fov is not None:
        fov_est = torch.full_like(sw, ep.fov * math.pi / 180.0)
    else:
        fov_est = estimate_fov_width(sw, sh, camw, ep.distance)
    activate = stable
    first = activate & state.first_run
    fov_width = torch.where(first, fov_est, state.fov_width)
    tan_fov = torch.where(first, 2 * torch.tan(fov_est / 2), state.tan_fov)
    first_run = state.first_run & ~activate
    # constructor resets head_diag_cam from the activation faceObj
    # (src/headposition.js:66-68)
    head_diag_cam = torch.where(activate, torch.sqrt(sw * sw + sh * sh),
                                state.head_diag_cam)
    headpose_active = headpose_active | activate

    run_head = activate | (tracking & headpose_active & ep.head_position)
    hx, hy, hz, new_diag_cam = track_head(
        sx, sy, sw, sh, head_diag_cam,
        torch.where(tan_fov > 0, tan_fov, 1.0),  # guard; masked by run_head
        camw, camh, ep.camera_offset, ep.edgecorrection)
    head_diag_cam = torch.where(run_head, new_diag_cam, head_diag_cam)

    out = dict(
        detection=detection, wb=res.wb,
        face_x=res.x, face_y=res.y, face_w=res.w, face_h=res.h,
        face_angle=res.angle, face_conf=res.conf,
        smooth_x=sx, smooth_y=sy, smooth_w=sw, smooth_h=sh,
        head_valid=run_head,
        head_x=torch.where(run_head, hx, 0.0),
        head_y=torch.where(run_head, hy, 0.0),
        head_z=torch.where(run_head, hz, 0.0),
        status=status,
        event_face=is_cs & ep.send_events,
        fov_deg=fov_width * _const(180.0 / math.pi, res.x),
        mode_after=mode_after,
        escaped=torch.zeros((N,), dtype=torch.bool, device=dev),
    )
    new_state = state._replace(
        mode=mode_after, sm_sp=sm_sp, sm_init=sm_init,
        face_found=face_found, first_run=first_run,
        diag_ring=diag_ring, diag_n=diag_n,
        headpose_active=headpose_active, tan_fov=tan_fov,
        fov_width=fov_width, head_diag_cam=head_diag_cam, stopped=stopped)
    return new_state, out, None if escaped is None else escaped & is_cs


class _CsResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    angle: torch.Tensor
    conf: torch.Tensor
    wb: torch.Tensor


def track_plain(state, win, m, zero_mass, escaped, dirty, ep):
    """The "track" step's end for every stream, from the mean shift's
    outputs (win (N, 4) i32, moments, zero_mass (N,) bool; escaped (N,)
    bool or None off the band, dirty the state's band_dirty when the
    "escape" audit action reports it escaped, else None): ``finish_plain``,
    then the freeze of the streams not in CS (their camshift state kept,
    conf 0), then ``supervise_plain`` as the "track" variant.  The result
    fields are the finished camshift's on every stream.  Returns as
    ``supervise_plain``, the escaped flags ORed with ``dirty``."""
    is_cs = state.mode == MODE_CS
    window, tx, ty, tw, th, ang = finish_plain(
        win, m, zero_mass, ep.calc_angles, ep.H, ep.W)
    old = state.cs

    def keep(new, prev):
        v = (-1,) + (1,) * (new.dim() - 1)
        return torch.where(is_cs.view(v), new, prev)

    cs = old._replace(window=keep(window, old.window),
                      track_x=keep(tx, old.track_x),
                      track_y=keep(ty, old.track_y),
                      track_w=keep(tw, old.track_w),
                      track_h=keep(th, old.track_h),
                      track_angle=keep(ang, old.track_angle))
    one = torch.ones_like(ang)
    res = _CsResult(x=tx.to(_F32), y=ty.to(_F32), w=tw.to(_F32),
                    h=th.to(_F32), angle=ang,
                    conf=torch.where(is_cs, one, 0.0),
                    wb=torch.zeros_like(one))
    if escaped is not None and dirty is not None:
        escaped = escaped | dirty
    return supervise_plain(state._replace(cs=cs), state.mode, res, ep,
                           "track", escaped)
