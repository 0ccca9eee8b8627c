"""The reference's facetracking.html demo, headless, on the PyTorch port.

Drives a Tracker session over a synthetic clip (or a real .npy clip / webcam
if available), printing status transitions and a live line per
head-tracking event: create tracker, init, listen, start, as in the
reference README.  The port of examples/facetracking.py.

Run:  python examples/torch_facetracking.py                  # on the GPU
      python examples/torch_facetracking.py --device cpu     # plain twins
      python examples/torch_facetracking.py --toy --device cpu
                                   # toy cascade, a 120x160 bright square
      python examples/torch_facetracking.py --clip myclip.npy  # (N,H,W,3) u8
      python examples/torch_facetracking.py --camera           # needs OpenCV
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.cascade import DATA_DIR
from headtrackr_tpu_torch.runtime.video import CameraSource, ClipSource

TOY_SHAPE = (120, 160)


def synthetic_clip(n=60):
    """A clip with the synthesized real-cascade-detectable face moving around."""
    face = np.load(os.path.join(DATA_DIR, "synthface.npz"))["rgb"]
    H, W = 240, 320
    frames = np.full((n, H, W, 3), (120, 100, 90), np.uint8)
    for t in range(n):
        px = 148 + (0 if t < 16 else (t - 16) * 2) % 80
        py = 108
        frames[t, py:py + 24, px:px + 24] = face
    return frames


def toy_clip(n=60):
    """A clip the toy cascade locks on: a still bright square (whitebalance
    and detection), then panning right."""
    H, W = TOY_SHAPE
    frames = np.full((n, H, W, 3), 40, np.uint8)
    for t in range(n):
        x = 48 + (0 if t < 16 else (t - 16) % 60)
        frames[t, 38:62, x:x + 24] = (230, 80, 60)
    return frames


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", help=".npy/.npz clip file")
    ap.add_argument("--camera", action="store_true")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--toy", action="store_true",
                    help="the toy cascade on a 120x160 bright-square clip")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain twins)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    canvas = None
    if args.camera:
        source = CameraSource()
    elif args.clip:
        source = ClipSource(args.clip)
    elif args.toy:
        source = ClipSource(toy_clip(args.frames))
        canvas = TOY_SHAPE[::-1]
    else:
        source = ClipSource(synthetic_clip(args.frames))

    bus = pt.events.EventBus()
    tracker = pt.Tracker(ui=True, bus=bus, device=args.device,
                         cascade=pt.toy_cascade() if args.toy else None)

    bus.add_event_listener("headtrackrStatus",
                           lambda e: print(f"[status] {e.status}"))
    bus.add_event_listener(
        "facetrackingEvent",
        lambda e: print(f"[face] x={e.x:6.1f} y={e.y:6.1f} "
                        f"w={e.width:5.1f} h={e.height:5.1f} ({e.time} ms)"))
    bus.add_event_listener(
        "headtrackingEvent",
        lambda e: print(f"[head] x={e.x:+6.2f} y={e.y:+6.2f} z={e.z:6.2f} cm"))

    assert tracker.init(source, canvas=canvas)
    n = tracker.run_clip()
    print(f"processed {n} frames; final status: {tracker.status}; "
          f"fov={tracker.getFOV():.1f} deg")
    return tracker


if __name__ == "__main__":
    main()
