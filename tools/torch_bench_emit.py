"""Host-side event emission of the port's serving tick.

The counterpart of tools/bench_emit.py for headtrackr_tpu_torch: times
``StreamFanout.emit`` over the port's ``StepOutput`` at 256 streams for a
steady tick (every stream tracking: one facetrackingEvent and one
headtrackingEvent a stream, one listener a bus) and for the worst tick
(every stream also carrying the found and redetecting status bits).  The
outputs are CPU tensors, so ``emit``'s one host copy a dtype is a CPU copy:
pure host work, run anywhere:

    python3 tools/torch_bench_emit.py [--streams 256] [--iters 200]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import time  # noqa: E402


def fake_out(n, steady=True):
    """A StepOutput batch of CPU tensors shaped like a serving tick."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft
    z = torch.zeros(n, dtype=torch.float32)
    one = torch.ones(n, dtype=torch.bool)
    status = (ft.STATUS_FOUND | ft.STATUS_REDETECTING) if not steady else 0
    return ft.StepOutput(
        detection=torch.full((n,), ft.MODE_CS, dtype=torch.int32),
        wb=z, face_x=z + 100, face_y=z + 80, face_w=z + 40, face_h=z + 44,
        face_angle=z + 1.5, face_conf=z + 1,
        smooth_x=z + 100, smooth_y=z + 80, smooth_w=z + 40, smooth_h=z + 44,
        head_valid=one, head_x=z, head_y=z + 11.5, head_z=z + 60,
        status=torch.full((n,), status, dtype=torch.int32),
        event_face=one, fov_deg=z + 40,
        mode_after=torch.full((n,), ft.MODE_CS, dtype=torch.int32),
        escaped=~one)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    from headtrackr_tpu_torch.runtime.fanout import StreamFanout

    n = args.streams
    sink = []
    fan = StreamFanout(n)
    for i in range(n):
        fan.add_event_listener(i, "facetrackingEvent",
                               lambda e: sink.append(e.x))
        fan.add_event_listener(i, "headtrackingEvent",
                               lambda e: sink.append(e.z))
    res = {}
    for name, steady in (("steady(face+head)", True),
                         ("worst(+2 status)", False)):
        out = fake_out(n, steady)
        fan.emit(out)  # warm
        t0 = time.perf_counter()
        for _ in range(args.iters):
            cnt = fan.emit(out, time_ms=6)
        dt = (time.perf_counter() - t0) / args.iters
        res[name] = (1e3 * dt, cnt)
        print(f"emit {name:18s} {n} streams: {1e3 * dt:.3f} ms/tick "
              f"({cnt} events)")
    return res


if __name__ == "__main__":
    main()
