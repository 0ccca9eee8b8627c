"""Serving on a mesh with the PyTorch port: N camera streams split over
devices.  The port of examples/mesh_serving.py.

The algorithm has no cross-stream communication, so several devices are
pure data parallelism (SURVEY §2): ``BatchedTracker(N, mesh=...)`` splits
the stream axis over a 1-D mesh, one equal shard a mesh entry, and each
shard runs the device scheduler on its own slice (its own redetect bucket,
no cross-shard reads).  The code is the one-device code plus ``mesh=``;
the capacity knobs come from ``plan_serving``.

With ``--device cpu`` the mesh names the CPU 8 times (8 shards of 4
streams, as the reference example's 8 virtual CPU devices); without it the
mesh takes every visible card, one shard each.

Run (GPU):  python examples/torch_mesh_serving.py
Run (CPU):  python examples/torch_mesh_serving.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import headtrackr_tpu_torch as pt
from headtrackr_tpu_torch.models.facetracker import STATUS_REDETECTING
from headtrackr_tpu_torch.parallel import stream_mesh

H, W = 120, 160
N = 32


def fr(cx, cy, blue=False):
    f = np.full((H, W, 3), 40, np.uint8)
    if blue:
        f[:] = (0, 0, 250)
    else:
        f[cy - 12:cy + 12, cx - 12:cx + 12] = (230, 80, 60)
    return f


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for a mesh of 8 CPU shards (default: every "
                         "visible GPU, one shard each)")
    args = ap.parse_args(argv)
    mesh = stream_mesh(None if args.device is None else [args.device] * 8)
    k = mesh.devices.size
    print(f"mesh: {k} shards {[str(d) for d in mesh.devices]}, axis "
          f"{mesh.axis_names[0]!r}")

    plan = pt.plan_serving(N, frame_shape=(H, W), max_face_px=24)
    print(f"plan_serving: {plan}")
    bt = pt.BatchedTracker(N, frame_shape=(H, W), cascade=pt.toy_cascade(),
                           mesh=mesh, band=plan["band"],
                           bucket=plan["bucket"], overload=plan["overload"],
                           ui=False)

    base = [fr(40 + (3 * i) % 80, 40 + (2 * i) % 60) for i in range(N)]
    batch0 = np.stack(base)
    for _ in range(17):  # lock: WB stabilization, each shard's detect, CS
        bt.step_auto(batch0)
    print(f"lock: {int((bt.modes == 2).sum())}/{N} streams tracking, "
          f"{N // k} a shard")

    # 16 ticks a call; two streams on the first and last shard lose track
    # at tick 8 and relock through their own shard's bucket
    seq = np.stack([batch0] * 16)
    seq[8, 3] = fr(0, 0, blue=True)
    seq[8, N - 1] = fr(0, 0, blue=True)
    out = bt.run_scan(seq)
    st = out.status.cpu().numpy()
    lost = np.nonzero(st[8] & STATUS_REDETECTING)[0].tolist()
    modes = bt.modes
    per = N // k
    redetects = (st & STATUS_REDETECTING) != 0
    for j, dev in enumerate(mesh.devices.flat):
        s = slice(j * per, (j + 1) * per)
        print(f"  shard {j} ({dev}): streams {s.start}-{s.stop - 1}, modes "
              f"{modes[s].tolist()}, redetect ticks "
              f"{int(redetects[:, s].sum())}")
    xs = out.face_x.cpu().numpy()
    for i in lost:
        print(f"  stream {i}: lost at tick 8, track x "
              f"{xs[:, i].astype(int).tolist()}")
    print(f"run_scan: 16 ticks a call; streams {lost} lost track at tick 8 "
          f"and relocked in their shards; end modes all CS: "
          f"{bool((modes == 2).all())}; escapes "
          f"{int(out.escaped.sum())} stream-ticks (band {plan['band']})")
    return modes.tolist(), lost, k


if __name__ == "__main__":
    main()
