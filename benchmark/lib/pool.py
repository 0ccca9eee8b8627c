"""The traffic's frames, made on the device from the seed.

N streams of H x W RGB u8, each with the 24 x 24 synthetic face
(``data/synthface.npz``, a preimage of the frontal-face cascade) drawn
``face_scale`` times as large (each pixel a square of face_scale^2) on
a flat background.  Each stream's face sits at its own place (x a
multiple of 4, y of 8, drawn from the seed: the cascade finds the 96 px
face of ``face_scale`` 4 at every such place that a pool can hold, and
at rows of 8 k + 4 misses some) and moves +-``step`` px a tick along a
ping-pong path over the pool's ticks, so no tick reuses the previous
tick's pixels and the pool repeats.  The traffic's ``texture``
(``{"vectors": [a, b], "amplitude": k, "keep_gray": bool}``) overlays a
static chroma texture a stream, u a + v b with u, v drawn from [-k, k] a
pixel, clipped to [0, 255]: it spreads the camshift model over ~90-100 of
the 4096 bins, as a webcam face's palette does.  With ``keep_gray`` each
pixel's green then moves by the fewest steps that bring its integer gray
(30 r + 59 g + 11 b + 50) // 100 back to the plain face's, so the cascade
sees every face exactly as the plain one (whose every place it finds).  A stream that loses its face at a tick sees a blue
frame there (no bin shared with the face or the background: a zero-mass
camshift loss), and its face again on the next.

Which streams lose their face, and when, is the traffic's ``loss``:
``{"kind": "fixed", "share": s, "tick": t}``: round(s N) streams at pool
tick t; ``{"kind": "rotating", "share": s}``: at every pool tick a
different round(s N) streams, each at most once a pass.  The streams are
drawn from the seed; their number is not.  The lock frame is the first
tick's faces with no loss.
"""

import os

import numpy as np
import torch

__all__ = ["FACE_PATH", "BACKGROUND", "BLUE", "face_rgb", "offsets",
           "lost_streams", "Pool", "build_pool"]

FACE_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "synthface.npz")
BACKGROUND = (120, 100, 90)
BLUE = (0, 0, 250)


def face_rgb(scale=1):
    """The synthetic face drawn ``scale`` times as large, (24 scale,
    24 scale, 3) u8."""
    with np.load(FACE_PATH) as d:
        rgb = d["rgb"]
    return np.repeat(np.repeat(rgb, int(scale), 0), int(scale), 1)


def offsets(ticks, step):
    """The faces' x offset at each pool tick: 0, step, ... up, then back."""
    half = ticks // 2
    return ([step * t for t in range(half)]
            + [step * (ticks - t) for t in range(half, ticks)])


def lost_streams(n, ticks, loss, perm):
    """[(pool tick, stream indices)] of the traffic's ``loss``, the
    streams taken in the order of ``perm`` (a permutation of range(n))."""
    kind = loss["kind"]
    m = int(round(float(loss["share"]) * n))
    if kind == "fixed":
        return [(int(loss["tick"]), perm[:m])] if m else []
    if kind == "rotating":
        if m * ticks > n:
            raise ValueError(f"{m} streams a tick over {ticks} ticks exceed "
                             f"{n} streams")
        return [(t, perm[t * m:(t + 1) * m]) for t in range(ticks)] \
            if m else []
    raise ValueError(f"unknown loss kind {kind!r}")


def _luma(rgb):
    return (30 * rgb[..., 0] + 59 * rgb[..., 1] + 11 * rgb[..., 2])


def _keep_gray(faces, face):
    """faces (N, h, w, 3) i32 with each pixel's green moved by the fewest
    steps (c, c' = ceil, floor) that give the integer gray of ``face``
    (h, w, 3) i32 again."""
    q = (_luma(face) + 50) // 100
    lo = 100 * q - 50 - _luma(faces)          # 59 c >= lo
    hi = lo + 99                              # 59 c <= hi
    c = torch.minimum(torch.clamp(-(-lo // 59), min=0), hi // 59)
    faces = faces.clone()
    faces[..., 1] += c
    if ((faces[..., 1] < 0) | (faces[..., 1] > 255)).any():
        raise ValueError("the texture leaves no green to keep the gray")
    return faces


class Pool:
    """A cell's frames: ``lock`` (N, H, W, 3), ``ticks`` (P, N, H, W, 3),
    ``losses`` [(pool tick, stream indices (host ints))], ``places`` (N, 2)
    the faces' (x, y) at offset 0 (host)."""

    def __init__(self, lock, ticks, losses, places):
        self.lock, self.ticks = lock, ticks
        self.losses, self.places = losses, places

    def stream(self, i):
        """Stream i's frames on the host: (lock (H, W, 3), pool (P, H, W,
        3)) u8."""
        return (self.lock[i].cpu().numpy(),
                self.ticks[:, i].cpu().numpy())

    def lost_set(self):
        """The streams that lose their face in the pool (host ints)."""
        if not self.losses:
            return np.zeros((0,), np.int64)
        return np.unique(np.concatenate([s for _, s in self.losses]))


def build_pool(n, frame_shape, traffic, seed, device):
    """The traffic's ``Pool`` of n streams of ``frame_shape`` (H, W) on
    ``device``, drawn from ``seed`` with a generator on that device."""
    H, W = frame_shape
    P = int(traffic["pool_ticks"])
    tex_spec = traffic["texture"]
    k = int(tex_spec["amplitude"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    face = torch.as_tensor(face_rgb(traffic.get("face_scale", 1)),
                           device=device).to(torch.int32)
    fh, fw = face.shape[:2]
    offs = offsets(P, int(traffic["step"]))
    if (W - 2 * fw) // 4 <= 2 or (H - fh - 8) // 8 <= 1:
        raise ValueError(f"frames of {H}x{W} leave the faces no room")
    px = 4 * torch.randint(2, (W - 2 * fw) // 4, (n,), generator=g,
                           device=device)
    py = 8 * torch.randint(1, (H - fh - 8) // 8, (n,), generator=g,
                           device=device)
    if k:
        t = torch.randint(-k, k + 1, (2, n, fh, fw, 1), generator=g,
                          device=device, dtype=torch.int32)
        a, b = (torch.tensor(v, dtype=torch.int32, device=device)
                for v in tex_spec["vectors"])
        faces = (face[None] + t[0] * a + t[1] * b).clamp_(0, 255)
        if tex_spec.get("keep_gray"):
            faces = _keep_gray(faces, face)
        faces = faces.to(torch.uint8)
    else:
        faces = face.to(torch.uint8)[None].expand(n, fh, fw, 3)
    perm = torch.randperm(n, generator=g, device=device).cpu().numpy()
    losses = lost_streams(n, P, traffic["loss"], perm)

    bg = torch.tensor(BACKGROUND, dtype=torch.uint8, device=device)
    blue = torch.tensor(BLUE, dtype=torch.uint8, device=device)
    rows = (py.view(n, 1, 1) + torch.arange(fh, device=device).view(1, fh, 1))
    cols0 = px.view(n, 1, 1) + torch.arange(fw, device=device).view(1, 1, fw)
    streams = torch.arange(n, device=device).view(n, 1, 1)

    def fill(f, off):
        f.copy_(bg.expand_as(f))
        f[streams, rows, cols0 + off] = faces
        return f

    ticks = torch.empty((P, n, H, W, 3), dtype=torch.uint8, device=device)
    for t in range(P):
        fill(ticks[t], offs[t])
    for t, s in losses:
        ticks[t, torch.as_tensor(s, device=device)] = blue
    lock = fill(torch.empty((n, H, W, 3), dtype=torch.uint8, device=device),
                offs[0])
    places = torch.stack([px, py], 1).cpu().numpy()
    return Pool(lock, ticks, losses, places)
