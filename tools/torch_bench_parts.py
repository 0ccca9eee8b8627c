"""Part timers of the port's steady serving tick on the card.

The counterpart of tools/bench_parts.py for headtrackr_tpu_torch.  It
locks a BatchedTracker on the bench pool (``bench.build_pool``: N streams
of 320x240, the headline configuration by default: 96x128 band, bandHist,
bucket 8) and times each part of the steady tick on the locked tracker's
state and frames: by CUDA-graph replay (20 calls captured in one graph,
timed with events) where the part can be captured, by CUDA events around
20 calls otherwise, and by the host clock where the part is host work.

Parts (``--parts``, comma list; default all):
  rtt        a 4-byte device-to-host read (host clock, p50);
  h2d        one frame batch host-to-device, pageable and pinned (events);
  track      the full-frame "track" step (graph);
  trackband  the banded "track" step (graph);
  bandparts  the banded step built up: the band's bins and histogram; then
             with the weights and the band pdf; then with ``meanshift``;
             then the whole step (graph; differences give the split);
  histpdf    the full-frame histogram, weights and pdf (graph);
  hist       the full-frame histogram (the configured histKernel; graph);
  pdfonly    the full-frame pdf given the weights (graph);
  meanshift  ``meanshift`` over the full-frame pdf at the tracker's windows
             (graph);
  dispatch   one all-tracking ``step_auto`` on an idle card (host
             clock: the whole call, and its enqueue alone);
  bucket     a tick with 8 streams redetecting (after a blue frame): one
             launch of the serving program (events and host clock);
  bucket_eager  the same tick run eagerly on the per-tick path
             (``_Steps.scheduled`` off for it; events and host clock).

Prints one ``<part>_ms_per_tick`` line a part (ms for N streams), then the
parts as one JSON line.  tools/profile_chip.py's per-stage camshift times
are these parts; tools/bench_histpdf.py's XLA-versus-Pallas question is
chip_smoke.py phase 3 (each kernel against its plain twin and a library
call).

Run on the card:  python3 tools/torch_bench_parts.py [--streams 256]
                      [--parts all] [--band 96x128] [--no-band-hist]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

PARTS = ("rtt", "h2d", "track", "trackband", "bandparts", "histpdf", "hist",
         "pdfonly", "meanshift", "dispatch", "bucket", "bucket_eager")
REPS = 20
POOL = 16
LOCK_TICKS = 16
BUCKET = 8


def redetect_ms(bt, pool, dev, eager=False):
    """(events ms, host ms), medians over 5 reps, of a tick in which BUCKET
    streams redetect (a blue frame just unlocked them): track on the batch
    and the full step on the BUCKET streams.  eager=True runs that tick
    eagerly on the per-tick path instead of launching the serving
    program."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft
    lost = pool[1].clone()
    lost[:BUCKET] = torch.tensor([0, 0, 250], dtype=torch.uint8, device=dev)
    ev, host = [], []
    for rep in range(6):
        bt.step_auto(lost)  # BUCKET streams lose track
        if int((bt.modes != ft.MODE_CS).sum()) != BUCKET:
            raise SystemExit("the blue frame did not unlock 8 streams")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        bt._steps.scheduled = not eager
        t0 = time.perf_counter()
        a.record()
        bt.step_auto(pool[2])  # they redetect: track + full on BUCKET
        b.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        bt._steps.scheduled = True
        ev.append(a.elapsed_time(b))
        for _ in range(2):
            bt.step_auto(pool[2])
    return float(np.median(ev[1:])), 1e3 * float(np.median(host[1:]))


def events_ms(fn, reps=REPS):
    """ms of one call of fn: CUDA events around ``reps`` calls."""
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


def graph_ms(fn, reps=REPS):
    """Device ms of one call of fn: ``reps`` calls captured in one CUDA
    graph, replayed once under events (fn must not read the card from the
    host)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--parts", type=str, default="all",
                    help="comma list of " + ",".join(PARTS))
    ap.add_argument("--band", type=str, default="96x128")
    ap.add_argument("--band-hist", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--hist-kernel", type=str, default=None,
                    choices=["pallas"])
    args = ap.parse_args(argv)
    want = set(PARTS) if args.parts == "all" else set(args.parts.split(","))
    if want - set(PARTS):
        raise SystemExit(f"unknown parts: {sorted(want - set(PARTS))}")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_parts: no CUDA device")
    from bench import build_pool
    from bench_torch import card_name, d2h_floor_ms
    import headtrackr_tpu_torch as pt
    from headtrackr_tpu_torch.kernels.build import load_library
    from headtrackr_tpu_torch.kernels.meanshift import mean_shift
    from headtrackr_tpu_torch.models import camshift as cs
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.ops.histogram import (backprojection_weights,
                                                    histogram_full,
                                                    histogram_rects)
    from headtrackr_tpu_torch.kernels.histpdf import (backproject,
                                                      backproject_ratio,
                                                      histpdf_band)

    dev = torch.device("cuda", 0)
    N, H, W = args.streams, 240, 320
    band = cs.parse_band(args.band)
    print(f"# device: {card_name(dev)}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {N} streams x {H}x{W}, band {band}, "
          f"bandHist {args.band_hist}, histKernel {args.hist_kernel}",
          file=_sys.stderr)
    load_library()
    pool_np = build_pool(N, H, W, POOL, 4, np.random.default_rng(0))
    pool = torch.as_tensor(pool_np).to(dev)
    bt = pt.BatchedTracker(N, (H, W), bucket=BUCKET, band=band,
                           bandHist=args.band_hist,
                           histKernel=args.hist_kernel, device=dev).warmup()
    for _ in range(LOCK_TICKS):
        bt.step_auto(pool[0])
    if not (bt.modes == ft.MODE_CS).all():
        raise SystemExit("the tracker did not lock every stream")
    state = ft.tree_index(bt.state, torch.arange(N, device=dev))  # a copy
    frames = pool[1]
    hk = bt.config.histKernel
    res = {}

    def report(name, ms, how):
        res[name] = ms
        print(f"{name}_ms_per_tick {ms:.4f}  ({how})", flush=True)

    if "rtt" in want:
        report("rtt", d2h_floor_ms(dev), "4-byte device-to-host read, p50")
    if "h2d" in want:
        mb = N * H * W * 3 / 1e6
        pageable = [torch.from_numpy(b) for b in pool_np[:4]]
        pinned = [b.pin_memory() for b in pageable]
        for name, bufs, nb in (("h2d", pageable, False),
                               ("h2d_pinned", pinned, True)):
            it = iter(range(1 << 30))
            ms = events_ms(lambda: bufs[next(it) % 4].to(dev,
                                                         non_blocking=nb))
            report(name, ms, f"{mb:.1f} MB, {mb / ms:.2f} GB/s, events")

    def step(variant, with_band):
        return ft.make_step(bt.cascade, bt.config, (H, W), variant,
                            band=band if with_band else None, device=dev)

    if "track" in want:
        track = step("track", False)
        report("track", graph_ms(lambda: track(state, frames)),
               "full-frame track step, graph")
    if "trackband" in want and band is not None:
        trackb = step("track", True)
        report("trackband", graph_ms(lambda: trackb(state, frames)),
               "banded track step, graph")
    if "bandparts" in want and band is not None:
        win, model = state.cs.window, state.cs.model_hist

        def upto_hist():
            if args.band_hist:  # the band's counts, at band_rect's rects
                return histogram_rects(
                    frames, cs.band_rects(*cs.band_rect(win, band, (H, W))))
            return histogram_full(frames, hk)

        b = (min(band[0], H), min(band[1], W))

        def upto_pdf():  # the band kernels place the band from win
            if args.band_hist:
                return histpdf_band(frames, win, model, b)[1]
            return backproject_ratio(frames, model,
                                     histogram_full(frames, hk), win, b)

        def upto_ms():
            return mean_shift(upto_pdf(), win, (H, W))

        trackb = step("track", True)
        for name, fn in (("bins_hist", upto_hist),
                         ("plus_band_pdf", upto_pdf),
                         ("plus_meanshift", upto_ms),
                         ("band_step", lambda: trackb(state, frames))):
            report(name, graph_ms(fn), "bandparts, graph")
    model = state.cs.model_hist
    if "histpdf" in want:
        def histpdf():
            return backproject_ratio(frames, model,
                                     histogram_full(frames, hk))
        report("histpdf", graph_ms(histpdf),
               "full-frame histogram + weights and pdf, graph")
    if "hist" in want:
        report("hist", graph_ms(lambda: histogram_full(frames, hk)),
               f"full-frame histogram ({'hist4096' if hk else 'hist_mma'}), "
               "graph")
    weights = backprojection_weights(model, histogram_full(frames, hk))
    pdf = backproject(frames, weights)
    if "pdfonly" in want:
        report("pdfonly", graph_ms(lambda: backproject(frames, weights)),
               "full-frame pdf given the weights, graph")
    if "meanshift" in want:
        win = state.cs.window
        report("meanshift", graph_ms(lambda: mean_shift(pdf, win)),
               "meanshift over the full-frame pdf, graph")
    if "dispatch" in want:
        whole, begin = [], []
        for t in range(3 * POOL // 2):
            f = pool[t % (POOL // 2)]  # the batches before the loss frame
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt.step_auto(f)
            whole.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tick = bt._auto_begin(f)
            begin.append(time.perf_counter() - t0)
            bt._auto_end(tick)
        report("dispatch", 1e3 * float(np.median(whole[4:])),
               "step_auto on an idle card, host clock, median")
        report("dispatch_enqueue", 1e3 * float(np.median(begin[4:])),
               "its enqueue alone (_auto_begin), host clock, median")
    for part in ("bucket", "bucket_eager"):
        if part in want:
            ev, host = redetect_ms(bt, pool, dev, eager=part != "bucket")
            report(part, ev, f"8 redetects, events, median; host clock "
                   f"{host:.4f} ms")
    print(json.dumps({"parts_ms_per_tick": res, "streams": N,
                      "device": card_name(dev)}))
    return res


if __name__ == "__main__":
    main()
