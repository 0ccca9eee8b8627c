"""The reference's three.js head-coupled-perspective demos, on the PyTorch
port.

Subscribes a RealisticAbsoluteCameraControl to headtrackingEvent and prints
the computed camera poses (position / asymmetric view offset / fov): the
values the reference feeds THREE.PerspectiveCamera (src/controllers.js:
48-67).  The port of examples/head_coupled_camera.py.

Run:  python examples/torch_head_coupled_camera.py               # on the GPU
      python examples/torch_head_coupled_camera.py --device cpu
      python examples/torch_head_coupled_camera.py --toy --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.controllers import RealisticAbsoluteCameraControl
from headtrackr_tpu_torch.runtime.video import ClipSource
from torch_facetracking import TOY_SHAPE, synthetic_clip, toy_clip


class PrintCamera:
    aspect = 4 / 3

    def __init__(self):
        self.poses = 0

    def apply(self, pose):
        self.poses += 1
        px, py, pz = pose.position
        print(f"[camera] pos=({px:+6.2f},{py:+6.2f},{pz:6.2f}) "
              f"fov={pose.fov:5.2f} view_offset={tuple(round(v, 1) for v in pose.view_offset)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--toy", action="store_true",
                    help="the toy cascade on a 120x160 bright-square clip")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    bus = pt.events.EventBus()
    tracker = pt.Tracker(ui=False, bus=bus, device=args.device,
                         cascade=pt.toy_cascade() if args.toy else None)
    camera = PrintCamera()
    ctl = RealisticAbsoluteCameraControl(
        camera, scaling=1.0, fixed_position=(0, 0, 0), bus=bus)
    if args.toy:
        tracker.init(ClipSource(toy_clip(args.frames)), canvas=TOY_SHAPE[::-1])
    else:
        tracker.init(ClipSource(synthetic_clip(args.frames)))
    tracker.run_clip()
    ctl.close()
    print("final status:", tracker.status)
    return camera.poses


if __name__ == "__main__":
    main()
