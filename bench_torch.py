"""Benchmark of the PyTorch port: batched detect+track serving on one GPU.

The counterpart of bench.py for ``headtrackr_tpu_torch``, on the same
workload (``bench.build_pool``, NumPy): N streams of WxH frames whose faces
move +-2 px a tick along a ping-pong path, so no tick reuses the previous
tick's pixels; each pool pass, ``--loss-streams`` streams see one blue
frame (zero backprojection mass), redetect on the next tick and relock, so
the bucketed redetect tick runs inside the timed region.  Scheduling is on
the device (``BatchedTracker.run_scan``; on the card every all-tracking
tick is one CUDA graph replay).

Protocol (``measure_serving``, bench.py's): warmup; a 16-tick lock phase
of ``step_auto`` on pool[0] (the % locked, the model palette, and its
frames/s as the cold start); the pool staged on the device before timing;
one ``run_scan`` pass before timing; the timed ``run_scan`` chunks, ending
in a host read of the last tick's ``mode_after``; then the telemetry:
redetects and relocks in the timed region, % tracking at the end, escapes
a tick.

Arms, as bench.py runs them: the headline (bandHist on); the
reference-exact arm (bandHist off, a fresh tracker, same protocol); latency
mode (``step_auto`` and a host read of ``mode_after`` every tick: p50 and
p99, beside the floor of a 4-byte device-to-host read, not subtracted);
``--h2d``: fresh host frames every tick through ``step_auto(frames)`` on
all N streams (pageable NumPy frames, then pinned host tensors as a second
number); the cold start (frames/s of the lock phase).  Kernel builds (nvcc
at first use) are timed apart from ``warmup``, and ``warmup`` runs the
eager steps too (``host_sched=True``), so the cold start holds no build
and no first-call cost of the eager "full" and "track" steps; it still
holds the first ``wbtrack`` ticks and the first detect tick's allocations.

Left out of bench.py's flags: ``--sparse-hist``, ``--k1``, ``--k2`` and
``--deep-dtype``.  They are TPU knobs or capacity caps that the port does
not have (its histograms are dense, its detector keeps a fixed 256
candidate slots a stream and has no tile or window caps).

Prints one JSON line last, with bench.py's keys where they apply (metric,
value, unit, exact_value, cold_start_value, cold_start_unit) and
latency_p50_ms, latency_p99_ms, h2d_value, locked, relocks, redetects,
escapes, device (the card's name and power limit as nvidia-smi gives
them) and vs_limit (value over PERF.md's limit: 256 streams at 30 fps);
launches counts each kernel's launches in the headline's lock phase and
timed region (exact_launches the exact arm's; 0 for each on the CPU,
where the plain twins run).
A run that misses the gate (fewer than 99% of streams locked after the
lock phase, or, with loss streams, none relocking in the timed region)
exits 1 after printing its line.

Run on the card:  python3 bench_torch.py
CPU smoke:        python3 bench_torch.py --device cpu --streams 2 --pool 4 \\
                      --ticks 8 --latency-ticks 4
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from bench import build_pool

LIMIT_FPS = 7680.0  # 256 streams at 30 fps (PERF.md section 2)
LOCK_TICKS = 16
LOCKED_MIN = 0.99
H2D_TICKS = 30


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device):
    """The card's name and power limit as nvidia-smi prints them (its line
    for ``device``), or the device's own name where nvidia-smi is absent."""
    import torch
    if device.type != "cuda":
        return str(device)
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        return lines[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def measure_serving(bt, pool, scan_len, n_ticks, tag=""):
    """Lock phase and timed steady state on a warmed ``BatchedTracker``:
    bench.measure_serving's protocol.  pool: (P, N, H, W, 3) u8, staged on
    the tracker's device.  Returns a dict: fps, lock_fps, ms_per_tick,
    locked (share of streams in CS after the lock phase), ticks,
    redetects and relocks (stream-ticks with STATUS_REDETECTING /
    STATUS_FOUND in the timed region), tracking (share in CS at the end),
    escapes (stream-ticks recomputed full-frame), escapes_mean and
    escapes_max (a tick), palette (min, median, max distinct model bins)."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft

    N = int(pool.shape[1])
    pool_len = int(pool.shape[0])
    t_l0 = time.perf_counter()
    for _ in range(LOCK_TICKS):
        bt.step_auto(pool[0])
    locked = float((bt.modes == ft.MODE_CS).mean())  # a host read: a sync
    dt_l = time.perf_counter() - t_l0
    lock_fps = LOCK_TICKS * N / dt_l
    print(f"#{tag} lock: {LOCK_TICKS * N} frames in {dt_l:.2f}s "
          f"({lock_fps:.0f} fps cold-start), {100 * locked:.1f}% locked",
          file=sys.stderr)
    nbins = (bt.state.cs.model_hist != 0).sum(-1).cpu().numpy()
    palette = (int(nbins.min()), int(np.median(nbins)), int(nbins.max()))
    print(f"#{tag} model palette: {palette[0]}-{palette[2]} distinct bins "
          f"(median {palette[1]})", file=sys.stderr)

    chunks = max(1, n_ticks // scan_len)
    reps = scan_len // pool_len
    seq = torch.cat([pool] * reps) if reps > 1 else pool
    ticks = chunks * int(seq.shape[0])
    bt.run_scan(seq).mode_after[-1].cpu()  # one pass before timing
    outs = []
    t0 = time.perf_counter()
    for _ in range(chunks):
        outs.append(bt.run_scan(seq))
    outs[-1].mode_after[-1].cpu()  # the timed window ends in a host read
    dt = time.perf_counter() - t0
    fps = N * ticks / dt

    status = torch.cat([o.status for o in outs]).cpu().numpy()
    redetects = int((status & ft.STATUS_REDETECTING != 0).sum())
    relocks = int((status & ft.STATUS_FOUND != 0).sum())
    tracking = float((bt.modes == ft.MODE_CS).mean())
    esc = torch.cat([o.escaped for o in outs]).cpu().numpy().sum(1)
    print(f"#{tag} steady state: {ticks} ticks x {N} streams in {dt:.3f}s "
          f"({1000 * dt / ticks:.3f} ms/tick); {redetects} losses, "
          f"{relocks} relocks in timed region; {100 * tracking:.0f}% "
          f"tracking at end", file=sys.stderr)
    print(f"#{tag} full-frame fallback (band escape): {esc.mean():.2f} "
          f"streams/tick mean, {int(esc.max())} max, {int(esc.sum())} "
          f"stream-ticks total", file=sys.stderr)
    return {"fps": fps, "lock_fps": lock_fps, "ms_per_tick": 1e3 * dt / ticks,
            "locked": locked, "ticks": ticks, "redetects": redetects,
            "relocks": relocks, "tracking": tracking,
            "escapes": int(esc.sum()), "escapes_mean": float(esc.mean()),
            "escapes_max": int(esc.max()), "palette": palette}


def d2h_floor_ms(device, reps=200):
    """p50 ms of reading one i32 from ``device`` to the host."""
    import torch
    x = torch.zeros((1,), dtype=torch.int32, device=device)
    x.cpu()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x.cpu()
        t.append(time.perf_counter() - t0)
    return 1e3 * float(np.percentile(t, 50))


def measure_latency(bt, pool, n_ticks):
    """ms of ``step_auto`` plus a host read of its ``mode_after``, one
    tick at a time over the staged pool: (p50, p99)."""
    lat = []
    for i in range(n_ticks):
        f = pool[i % pool.shape[0]]
        t0 = time.perf_counter()
        bt.step_auto(f).mode_after.cpu()
        lat.append(time.perf_counter() - t0)
    ms = 1e3 * np.asarray(lat)
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def measure_h2d(bt, batches, n_ticks=H2D_TICKS):
    """frames/s of ``step_auto`` fed host frames, one batch of
    ``batches`` a tick in turn; the window ends in a host read."""
    N = batches[0].shape[0]
    for b in batches[:2]:
        bt.step_auto(b)
    t0 = time.perf_counter()
    for t in range(n_ticks):
        o = bt.step_auto(batches[t % len(batches)])
    o.mode_after.cpu()
    return N * n_ticks / (time.perf_counter() - t0)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--pool", type=int, default=16,
                    help="staged frame batches; also ticks per run_scan call")
    ap.add_argument("--scan", type=int, default=None,
                    help="ticks per run_scan call (default: --pool)")
    ap.add_argument("--loss-streams", type=int, default=4,
                    help="streams losing track once per pool pass")
    ap.add_argument("--bucket", type=int, default=8,
                    help="redetect bucket (BatchedTracker bucket)")
    ap.add_argument("--band", type=str, default="96x128",
                    help="camshift band: 'auto', 'none' (full frame) or HxW")
    ap.add_argument("--face-noise", type=int, default=0,
                    help="static per-stream chroma texture on the faces "
                         "(bench.build_pool; 20 = the realistic palette)")
    ap.add_argument("--size", type=str, default="320x240",
                    help="frame size WxH")
    ap.add_argument("--overload", type=str, default="full",
                    choices=["full", "rotate"],
                    help="the device scheduler's mass-pending policy")
    ap.add_argument("--band-hist", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="TrackerConfig.bandHist: band-local current "
                         "histograms (the serving mode); --no-band-hist is "
                         "the reference-exact arm alone")
    ap.add_argument("--exact-arm", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --band-hist, also measure the "
                         "reference-exact arm (bandHist off) as exact_value")
    ap.add_argument("--hist-kernel", type=str, default=None,
                    choices=["pallas"],
                    help="TrackerConfig.histKernel: 'pallas' runs hist4096 "
                         "for full-frame histograms (default: hist_mma)")
    ap.add_argument("--latency-ticks", type=int, default=50)
    ap.add_argument("--h2d", action="store_true",
                    help="also time step_auto fed fresh host frames every "
                         "tick on all streams, pageable and pinned")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain twins)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the bench; print its JSON line last and return it as a dict
    (``gate_ok`` False when the run missed the gate)."""
    args = parse_args(argv)
    scan_len = args.scan or args.pool
    if scan_len % args.pool:
        scan_len = max(args.pool, (scan_len // args.pool) * args.pool)
        print(f"# --scan rounded to {scan_len} (multiple of --pool)",
              file=sys.stderr)
    try:
        W, H = (int(v) for v in args.size.split("x"))
    except ValueError:
        raise SystemExit(f"--size must be WxH (e.g. 320x240); got "
                         f"{args.size!r}")

    import torch

    import headtrackr_tpu_torch as pt
    from headtrackr_tpu_torch.device import resolve_device
    from headtrackr_tpu_torch.kernels import launch as L
    from headtrackr_tpu_torch.models.camshift import parse_band

    device = resolve_device(args.device)
    card = card_name(device)
    print(f"# device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    build_s = None
    if device.type == "cuda":
        from headtrackr_tpu_torch.kernels.build import load_library
        t_b0 = time.perf_counter()
        load_library()
        build_s = time.perf_counter() - t_b0
        print(f"# kernel build: {build_s:.2f}s", file=sys.stderr)

    N = args.streams
    band = parse_band(args.band)
    pool_np = build_pool(N, H, W, args.pool, args.loss_streams,
                         np.random.default_rng(0), face_noise=args.face_noise)

    def tracker(band_hist):
        bt = pt.BatchedTracker(N, frame_shape=(H, W), ui=False,
                               bucket=args.bucket, band=band,
                               overload=args.overload,
                               histKernel=args.hist_kernel,
                               bandHist=band_hist, device=device)
        t0 = time.perf_counter()
        bt.warmup(scan_len=scan_len, host_sched=True)
        warm_s = time.perf_counter() - t0
        print(f"# warmup (bandHist={band_hist}): {warm_s:.2f}s",
              file=sys.stderr)
        return bt, warm_s

    bt, warm_s = tracker(args.band_hist)
    t_u0 = time.perf_counter()
    pool = torch.as_tensor(pool_np).to(device)
    _sync(device)
    print(f"# pool staged: {pool_np.nbytes / 1e6:.0f} MB in "
          f"{time.perf_counter() - t_u0:.2f}s", file=sys.stderr)

    def measured(bt, tag=""):
        """measure_serving, with the kernel launches it made."""
        L.reset_launches()
        r = measure_serving(bt, pool, scan_len, args.ticks, tag)
        r["launches"] = dict(L.launches)
        return r

    head = measured(bt)
    arms = [head]
    exact = None
    if args.band_hist and args.exact_arm:
        bt_x, _ = tracker(False)
        exact = measured(bt_x, " [exact]")
        arms.append(exact)
        del bt_x

    floor = d2h_floor_ms(device)
    p50 = p99 = None
    if args.latency_ticks > 0:
        p50, p99 = measure_latency(bt, pool, args.latency_ticks)
        print(f"# latency mode (step_auto + host read every tick, {N} "
              f"streams): p50 {p50:.3f} ms, p99 {p99:.3f} ms over "
              f"{args.latency_ticks} ticks; 4-byte device-to-host read "
              f"p50 {floor:.4f} ms (not subtracted)", file=sys.stderr)

    h2d = h2d_pinned = None
    if args.h2d:
        del pool  # the h2d ticks read host frames
        mb = N * H * W * 3 / 1e6
        h2d = measure_h2d(bt, list(pool_np))
        pinned = [torch.from_numpy(b).pin_memory()
                  if device.type == "cuda" else torch.from_numpy(b)
                  for b in pool_np[:4]]
        h2d_pinned = measure_h2d(bt, pinned)
        print(f"# end-to-end incl. H2D ({N} streams, {mb:.1f} MB a tick): "
              f"pageable {h2d:.0f} frames/s ({h2d * mb / N:.0f} MB/s), "
              f"pinned {h2d_pinned:.0f} frames/s "
              f"({h2d_pinned * mb / N:.0f} MB/s)", file=sys.stderr)

    bh_tag = ", band-local hist" if args.band_hist else ""
    fps = head["fps"]
    gate_ok = all(a["locked"] >= LOCKED_MIN
                  and (args.loss_streams == 0 or a["relocks"] > 0)
                  for a in arms)
    value = round(fps, 1)
    record = {
        "metric": f"{W}x{H} detect+track frames/sec/card ({N}-stream "
                  "serving; fresh frame content every tick, losses+redetects "
                  f"in timed region, device-scheduled{bh_tag})",
        "value": value,
        "unit": "frames/sec/card",
        # of the value as printed, so a reader's ratio matches to the digit
        "vs_limit": round(value / LIMIT_FPS, 4),
        "exact_value": round(exact["fps"], 1) if exact else None,
        "cold_start_value": round(head["lock_fps"], 1),
        "cold_start_unit": "frames/sec/card (16-tick lock phase)",
        "latency_p50_ms": p50,
        "latency_p99_ms": p99,
        "d2h_floor_ms": floor,
        "h2d_value": round(h2d, 1) if h2d else None,
        "h2d_pinned_value": round(h2d_pinned, 1) if h2d_pinned else None,
        "h2d_unit": "frames/sec/card (step_auto fed host frames)",
        "ms_per_tick": head["ms_per_tick"],
        "locked": head["locked"],
        "relocks": head["relocks"],
        "redetects": head["redetects"],
        "escapes": head["escapes"],
        "tracking": head["tracking"],
        "exact_locked": exact["locked"] if exact else None,
        "exact_relocks": exact["relocks"] if exact else None,
        "launches": head["launches"],
        "exact_launches": exact["launches"] if exact else None,
        "build_s": build_s,
        "warmup_s": warm_s,
        "gate_ok": gate_ok,
        "device": card,
    }
    if not gate_ok:
        print("# GATE MISSED: fewer than 99% locked, or no loss stream "
              "relocked in the timed region", file=sys.stderr)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    sys.exit(0 if main()["gate_ok"] else 1)
