#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build: nvcc builds the CUDA kernels from headtrackr_tpu_torch/csrc/;
  3. kernels: hist4096 and backproject on the card at N=256 x 240x320 must be
     bit-equal to their plain PyTorch twins on the same inputs (tolerance 0),
     each timed beside its twin;
  4. serving: BatchedTracker(256, (240, 320)) with the real cascade, the
     bench protocol (16 lock ticks, then 32 ticks over a 16-batch pool with
     4 loss streams): >= 99% locked, loss streams relock, both kernels
     launched by the main path, no NaN outside the zero-mass angle;
  5. card vs CPU: 2 streams x 24 ticks through the port on the card and on
     the CPU (plain twins) agree: integer outputs exactly, floats within
     rtol 1e-5 / atol 1e-4.

The line before last is the nvidia-smi name/power line; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or headtrackr_tpu.
"""

import json
import os
import subprocess
import sys
import time

H, W = 240, 320
N_STREAMS = 256
POOL = 16
LOSS_STREAMS = 4
RTOL, ATOL = 1e-5, 1e-4


def log(msg):
    print(msg, flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20):
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def interleaved_ms(kernel, plain):
    """plain, kernel, kernel, plain on one card: (kernel ms, plain ms)."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(pools, dev):
    import torch
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.ops import histogram as hg

    g = torch.Generator().manual_seed(7)
    inputs = {f"face_noise={k}": torch.as_tensor(p[1]).to(dev)
              for k, p in pools.items()}
    inputs["random"] = torch.randint(0, 256, (N_STREAMS, H, W, 3), generator=g,
                                     dtype=torch.uint8).to(dev)
    full = hg.full_rects(N_STREAMS, (H, W), dev)
    xy = torch.randint(-20, 300, (N_STREAMS, 2), generator=g)
    wh = torch.randint(0, 120, (N_STREAMS, 2), generator=g)
    boxes = torch.cat([xy, wh], 1).to(torch.int32).to(dev)
    err = {"hist4096": 0.0, "backproject": 0.0}
    times = {}
    for name, fr in inputs.items():
        for rects in (full, boxes):
            got = K.hist4096(fr, rects)
            want = hg.hist4096_plain(fr, rects).to(torch.float32)
            torch.cuda.synchronize()
            err["hist4096"] = max(err["hist4096"],
                                  float((got - want).abs().max()))
        model = K.hist4096(fr, boxes)
        for w in (hg.backprojection_weights(model, K.hist4096(fr, full)),
                  torch.rand((N_STREAMS, 4096), generator=g).to(dev)):
            got = K.backproject(fr, w)
            want = hg.backproject_plain(fr, w)
            torch.cuda.synchronize()
            err["backproject"] = max(err["backproject"],
                                     float((got - want).abs().max()))
        w = hg.backprojection_weights(model, K.hist4096(fr, full))
        times[name] = {
            "hist4096": interleaved_ms(lambda: K.hist4096(fr, full),
                                       lambda: hg.hist4096_plain(fr, full)),
            "backproject": interleaved_ms(lambda: K.backproject(fr, w),
                                          lambda: hg.backproject_plain(fr, w)),
        }
    for name, e in err.items():
        if e != 0.0:
            raise AssertionError(f"{name} differs from its plain twin: "
                                 f"max abs err {e}")
    for name, t in times.items():
        log(f"kernels [{name}] N={N_STREAMS} {H}x{W}: "
            + "; ".join(f"{k} {v[0]:.4f} ms (plain {v[1]:.4f} ms)"
                        for k, v in t.items()))
    log(f"kernels: bit-equal to their plain twins (max abs err {err})")
    return err, times


def phase_serving(pool, dev):
    import numpy as np
    import torch
    from headtrackr_tpu_torch import BatchedTracker
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.models import facetracker as ft

    bt = BatchedTracker(N_STREAMS, (H, W), device=dev)
    frames = torch.as_tensor(pool).to(dev)          # staged on the card
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    outs = []
    for _ in range(16):
        outs.append(bt.step_auto(frames[0]))
    locked = float((bt.modes == ft.MODE_CS).mean())
    torch.cuda.synchronize()
    t_lock = time.perf_counter() - t0
    if locked < 0.99:
        raise AssertionError(f"only {100 * locked:.1f}% of streams locked")
    n_ticks = 2 * POOL
    t0 = time.perf_counter()
    for t in range(n_ticks):
        outs.append(bt.step_auto(frames[t % POOL]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: {counts}")

    status = np.stack([o.status.cpu().numpy() for o in outs[16:]])
    redet = (status[:, :LOSS_STREAMS] & ft.STATUS_REDETECTING) != 0
    found = (status[:, :LOSS_STREAMS] & ft.STATUS_FOUND) != 0
    modes = bt.modes
    for s in range(LOSS_STREAMS):
        r = np.nonzero(redet[:, s])[0]
        if r.size == 0 or not found[r[0]:, s].any() or modes[s] != ft.MODE_CS:
            raise AssertionError(f"loss stream {s} did not redetect and relock")
    for o in outs:
        for name, v in zip(o._fields, o):
            if v.is_floating_point():
                nan = torch.isnan(v)
                if name == "face_angle":
                    nan &= ~((o.detection == ft.MODE_CS) & (o.face_w == 0))
                if bool(nan.any()):
                    raise AssertionError(f"NaN in output {name}")
    ms = 1000 * dt / n_ticks
    log(f"serving: {100 * locked:.1f}% of {N_STREAMS} streams locked after 16 "
        f"ticks ({t_lock:.2f} s, {16 * N_STREAMS / t_lock:.0f} frames/s cold "
        f"start); {n_ticks} steady ticks {ms:.3f} ms/tick, "
        f"{N_STREAMS * n_ticks / dt:.0f} frames/s; {LOSS_STREAMS} loss streams "
        f"relocked; launches {counts}")
    return counts, ms


def phase_card_vs_cpu(pool, dev):
    import numpy as np
    import torch
    from headtrackr_tpu_torch import BatchedTracker

    ticks = [0] * 16 + list(range(4, 12))           # lock, track, lose, relock
    res = []
    for d in (dev, torch.device("cpu")):
        bt = BatchedTracker(2, (H, W), device=d)
        res.append([[t.cpu().numpy() for t in bt.step_auto(pool[i, :2])]
                    for i in ticks])
    from headtrackr_tpu_torch.models.facetracker import StepOutput
    for k, (a, b) in enumerate(zip(*res)):
        for name, x, y in zip(StepOutput._fields, a, b):
            if x.dtype.kind in "biu":
                ok = np.array_equal(x, y)
            else:
                ok = np.allclose(x, y, rtol=RTOL, atol=ATOL, equal_nan=True)
            if not ok:
                raise AssertionError(f"card vs CPU: tick {k} {name}: {x} vs {y}")
    log(f"card vs CPU: 2 streams x {len(ticks)} ticks agree (integers exact, "
        f"floats rtol {RTOL} / atol {ATOL})")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    from bench import build_pool
    from headtrackr_tpu_torch.kernels.build import load_library

    card = smi()
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    log(f"build: {time.perf_counter() - t0:.2f} s ({lib.path.name}; "
        f"{' | '.join(regs)})")

    pools = {k: build_pool(N_STREAMS, H, W, POOL, LOSS_STREAMS,
                           np.random.default_rng(0), face_noise=k)
             for k in (0, 20)}
    err, times = phase_kernels(pools, dev)
    counts, _ = phase_serving(pools[0], dev)
    phase_card_vs_cpu(pools[0], dev)

    src = "headtrackr_tpu_torch/csrc/histpdf.cu"
    replaces = {"hist4096": "headtrackr_tpu/kernels/histpdf.py:109",
                "backproject": "headtrackr_tpu/kernels/histpdf.py:123"}
    t0 = times["face_noise=0"]
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": counts[k], "max_abs_err": err[k],
         "ms": t0[k][0], "plain_ms": t0[k][1]} for k in ("hist4096",
                                                         "backproject")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
