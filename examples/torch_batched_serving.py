"""Batched serving on the PyTorch port: N camera streams -> per-stream
events, on one GPU.  The port of examples/batched_serving.py.

Three tiers shown, lowest latency to highest throughput:
  1. BatchedSession: sources in, reference-shaped events out (easiest).
  2. step_auto:      device-scheduled tick at a time (no host mode reads;
                     the all-tracking tick replays one CUDA graph).
  3. run_scan:       K ticks a call (in this port one graph replay a tick,
                     so K saves nothing on the card yet).

Run (GPU):  python examples/torch_batched_serving.py
Run (CPU):  python examples/torch_batched_serving.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import headtrackr_tpu_torch as pt

H, W = 120, 160
N = 4


def clip(cx, cy, n=40):
    """A synthetic stream: still face (lock), then panning (track)."""
    def fr(x):
        f = np.full((H, W, 3), 40, np.uint8)
        f[cy - 12:cy + 12, x - 12:x + 12] = (230, 80, 60)
        return f
    return np.stack([fr(cx)] * 16 + [fr(cx + t) for t in range(n - 16)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)
    clips = [clip(40 + 10 * i, 40 + 6 * i) for i in range(N)]

    # --- 1. BatchedSession: sources -> tracker -> per-stream event buses
    sess = pt.BatchedSession(N, sources=[c.copy() for c in clips],
                             frame_shape=(H, W), cascade=pt.toy_cascade(),
                             ui=False, device=args.device)
    heads = [[] for _ in range(N)]
    for i in range(N):
        sess.fanout.add_event_listener(
            i, pt.events.HEADTRACKING, lambda e, i=i: heads[i].append(e))
    ticks = sess.run()
    print(f"session: {ticks} ticks, status={sess.fanout.status}")
    for i in range(N):
        if heads[i]:
            e = heads[i][-1]
            print(f"  stream {i}: {len(heads[i])} head events, "
                  f"last xyz=({e.x:.1f}, {e.y:.1f}, {e.z:.1f}) cm")

    # --- 2/3. Device scheduling: step_auto and run_scan.
    # plan_serving sizes the capacity knobs (camshift band, redetect bucket,
    # overload policy) from the workload.
    plan = pt.plan_serving(N, frame_shape=(H, W), max_face_px=24)
    print(f"plan_serving: {plan}")
    bt = pt.BatchedTracker(N, frame_shape=(H, W), cascade=pt.toy_cascade(),
                           band=plan["band"], bucket=plan["bucket"],
                           overload=plan["overload"], device=args.device)
    batch0 = np.stack([c[0] for c in clips])
    for _ in range(17):                      # lock phase, tick at a time
        out = bt.step_auto(batch0)
    print(f"step_auto: modes={bt.modes.tolist()} (2 = camshift tracking)")

    seq = np.stack([np.stack([c[min(t, len(c) - 1)] for c in clips])
                    for t in range(17, 33)])  # (16, N, H, W, 3)
    out = bt.run_scan(seq)                   # 16 ticks, one call
    xs = out.face_x.cpu().numpy()            # (16, N)
    print(f"run_scan: 16 ticks/call, stream-0 track x: "
          f"{xs[:, 0].astype(int).tolist()}")
    # several devices: examples/torch_mesh_serving.py (mesh=)
    return heads, bt.modes.tolist(), xs


if __name__ == "__main__":
    main()
