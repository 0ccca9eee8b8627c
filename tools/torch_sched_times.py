"""The device-scheduled serving path's ticks on the card, in the checkout at
``--root`` (default: this one), through the public entry points only, so
that two checkouts compare on one card.  tools/torch_compare.sh runs it
for a parent checkout and this one in turns.

At 256 streams of 320x240 (``bench.build_pool``, the real cascade, bucket
8), each tracker after ``warmup(scan_len=16)``:

  scan       run_scan of K = 16 all-tracking ticks (the pool's batches
             before its loss frame) in the headline (96x128 band, bandHist),
             full-frame (histKernel="pallas") and band configurations;
  cold       the headline's cold start from ``reset()``: run_scan of 16
             ticks of one batch (15 wbtrack ticks and a full tick);
  cold wbtrack, cold full
             its ticks by kind: step_auto on the batch from the initial
             state (a wbtrack tick), and from the state after 15 such
             ticks (every stream in VJ: the full tick), each state
             restored before each call (``cold_cases``);
  relock     the headline's tick in which 8 streams redetect (step_auto
             after a frame that turned them blue);
  rotate     the headline under overload="rotate": from ``reset()``, 15
             wbtrack ticks, then run_scan of 8 ticks of the burst (256
             pending streams, chunk_cap = 32 served a tick);
  step_auto  one all-tracking headline tick (latency-sensitive serving);
  tick band, tick full-frame
             one all-tracking step_auto tick of the band and full-frame
             configurations (their one-tick ``ops`` listing);
  escape     the headline's tick in which ESCAPES streams escape the band
             within escape_bucket (the escape fallback's few body): their
             faces stretched to 120 rows of the face's color, as
             chip_smoke.py's sched_frames stretches them, from a locked
             state, until a step_auto tick escapes exactly ESCAPES streams;
             each call replays that tick from the state before it (restored
             into the program's state buffers, untimed);
  many E     the headline's tick in which E streams (MANY: 12, 32, 256)
             escape the band beyond escape_bucket (the escape fallback's
             many body): from the locked state, the search windows of E
             streams spread over the batch (the first and the last among
             them) made TALL rows high, taller than the band, so that
             exactly those escape on the next step_auto tick (checked once
             a case: their escaped flags and a run of the many body);
             each call replays that tick from that state (restored,
             untimed); also its device span with the host's enqueue
             hidden behind a spin (``busy_span``), which every chunk of
             the many body's loop is in;
  split      that tick in parts: the all-CS tick's body graph
             (``BatchedTracker._graph``) replayed alone (device span, CUDA
             events), and the host time of step_auto's enqueue
             (``_auto_begin``) and of its finish (``_auto_end``, timed once
             the card is idle), median of 15 each.  The tick's span less
             the body's is what scheduling it costs the card, the commit
             of the body's results included: a body keeps its own results
             (since the bodies stopped writing the shared buffers, its
             span holds no writes).  In a checkout whose bodies still
             wrote them (``_Buffers.write``), ``writes`` gives those
             writes captured alone: their graph nodes, replay span and
             bytes.

Each: host ms a tick (host clock around the call, which ends in its host
read, median of 5, step_auto of 15; cold and rotate: one run each) and the
device's span a tick (CUDA events around the call: device work and the
gaps in it), every case before any profiling; then under torch.profiler
one more run of each: device ms and device operations a tick (the sum of
the device operations' times; a one-tick case also each operation by
name, its count and device ms), host launch calls (kernels and graphs)
and host reads (stream and event synchronizations) a call; then step_auto
timed again ("step_auto after profiler").  A first profiler session in a
process lost device events on the card, so one is spent on a throwaway.

    python3 tools/torch_sched_times.py [--root build/parent] [--big]
        [--only many] [--chunk M] [--tail S]

``--big`` instead times the headline at BIG streams (the pool's 256
tiled on the card, as chip_smoke.py phase 15 runs it): the cold start's
ticks by kind (``cold wbtrack``, ``cold full``, as above); after a cold
start of 16 ticks of one batch in run_scan calls of BIG_K ticks, all-tracking
run_scan calls of BIG_K ticks (the pool's batches before its loss frame),
host ms and device span a tick, each of REPS calls; the bytes of each
body's commit table (``commit_tables``, tools/torch_graph_nodes.py); then
the all-CS step_auto tick (``tick``) and the many E tick at BIG streams
for E in BIG_MANY (12, 100, 1,000), timed and profiled as above.

``tracker_mb`` (``tracker_mb <configuration>`` at 256 streams) is the
device memory that building and warming the tracker took (its state,
buffers and bodies' graphs and results).

``--only NAME,...`` runs only the cases whose names start with one of the
NAMEs (``--only many``: the many E ticks alone, on the headline tracker
alone; with ``--big`` no all-tracking scan is timed).  ``--chunk M`` and
``--tail S`` set the many escape body's big and small chunks on each
tracker before its programs are built (``_Steps.escape_chunk`` and
``escape_tail``, which a checkout without chunks ignores: the sweeps).

Prints the card's name and power limit, one line a case, then one JSON
line.  Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W, POOL, K = 256, 240, 320, 16, 16
LOSS_AT = POOL // 2
REPS = 5
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize")
BIG, BIG_K = 10240, 4
ESCAPES = 3  # the escape case's escaping streams (the few body: <= 8)
MANY = (12, 32, 256)  # the many cases' escaping streams (past escape_bucket)
BIG_MANY = (12, 100, 1000)  # the same at BIG streams
TALL = 120  # rows of an escaping window: taller than the band's 96
SPIN_CYCLES = 5_000_000  # busy_span's spin, ~2.5 ms: longer than an enqueue
CONFIGS = {"headline": dict(band=(96, 128), bandHist=True),
           "full-frame": dict(band=None, bandHist=False, histKernel="pallas"),
           "band": dict(band=(96, 128), bandHist=False)}


def profiled(fn, ticks):
    """fn() once under torch.profiler: device ms and operations a tick,
    host launch calls and host reads a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"device_ms_per_tick": sum(e.device_time_total for e in dev)
           / 1e3 / ticks,
           "device_ops_per_tick": len(dev) / ticks,
           "host_launches": sum(e.name in LAUNCHES for e in events),
           "host_reads": sum(e.name in SYNCS for e in events)}
    if ticks == 1:  # a single tick's operations by name: [count, device ms]
        ops = {}
        for e in dev:
            k = ops.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.device_time_total / 1e3
        out["ops"] = ops
    return out


def host_ms(fn, ticks, reps, before=None):
    """Median (host ms, device span ms) a tick of fn() (after
    ``before()``, untimed)."""
    import numpy as np
    import torch
    host, span = [], []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0) / ticks)
        span.append(a.elapsed_time(b) / ticks)
    return float(np.median(host)), float(np.median(span))


def split(bt, frames, reps):
    """The single all-CS tick in parts (see the module docstring): median
    body span ms, enqueue host ms and finish host ms."""
    import numpy as np
    import torch
    graph = bt._graph.graph
    body, enqueue, finish = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        body.append(a.elapsed_time(b))
        t0 = time.perf_counter()
        tick = bt._auto_begin(frames)
        enqueue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt._auto_end(tick)
        finish.append(1e3 * (time.perf_counter() - t0))
    return {"body_span_ms": float(np.median(body)),
            "enqueue_host_ms": float(np.median(enqueue)),
            "finish_host_ms": float(np.median(finish)),
            "writes": writes(bt, reps)}


def writes(bt, reps):
    """In a checkout whose bodies write their results into the shared
    buffers (``_Buffers.write``, before the bodies kept their own results):
    those writes of the all-CS body alone, captured as a graph of their
    own from one eager run's results: its nodes by kind and its median
    replay span ms.  None in a checkout without them."""
    import collections
    import numpy as np
    import torch
    steps = bt._steps
    bufs = steps.buffers(bt.state)
    if not hasattr(bufs, "write"):
        return None
    results = steps._auto_track(bufs.state_in, bufs.frames)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bufs.write(*results)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        bufs.write(*results)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    nodes = dict(collections.Counter(cs.node_kinds(graph)))
    span = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b))

    def nbytes(tree):
        if isinstance(tree, tuple):
            return sum(nbytes(v) for v in tree)
        return 0 if tree is None else tree.nbytes

    return {"nodes": nodes, "span_ms": float(np.median(span)),
            "bytes": nbytes(results)}


def stretched(pool, n_last):
    """The pool's batches before its loss frame, the faces of the last
    ``n_last`` streams stretched to 120 rows of the face's color (their
    bin), as chip_smoke.py's sched_frames stretches them: a window grows
    to the face and escapes the band once taller than it."""
    import numpy as np
    import torch
    from bench import _face_rgb
    seq = pool[:LOSS_AT].clone()
    skin = torch.as_tensor(np.median(_face_rgb().reshape(-1, 3), 0)
                           .astype(np.uint8)).to(pool.device)
    for t in range(seq.shape[0]):
        for s in range(seq.shape[1] - n_last, seq.shape[1]):
            f = seq[t, s]
            rows, cols = torch.nonzero((f // 16 == skin // 16).all(-1),
                                       as_tuple=True)
            if rows.numel():
                cy = int(rows.float().mean())
                f[max(0, cy - 60):cy + 60, int(cols.min()):int(cols.max())
                  + 1] = skin
    return seq


def escape_tick(bt, pool):
    """From ``bt``'s (locked) state, step_auto ticks on ``stretched``
    frames until one escapes exactly ESCAPES streams: (the state before
    that tick, cloned, its host modes, the tick's frames).  ``bt``'s state
    is left as it was."""
    import torch
    from headtrackr_tpu_torch.runtime.serving import _clone
    start, modes0 = _clone(bt.state), bt.modes.copy()
    seq = stretched(pool, ESCAPES)
    found = None
    for t in range(4 * LOSS_AT):
        before, modes = _clone(bt.state), bt.modes.copy()
        frame = seq[t % LOSS_AT]
        out = bt.step_auto(frame)
        nesc = int(out.escaped.sum())
        if nesc == ESCAPES:
            found = (before, modes, frame)
            break
        if nesc > ESCAPES:
            raise SystemExit(f"escape: {nesc} streams escaped at once")
    restore(bt, start, modes0)
    if found is None:
        raise SystemExit("escape: no tick escaped the stretched faces")
    torch.cuda.synchronize()
    return found


def restore(bt, state, modes):
    """``state`` copied into ``bt``'s state buffers (the program's, after a
    step_auto), so that the next tick launches no copy of its own."""
    import torch
    from headtrackr_tpu_torch.runtime.serving import _leaves
    torch._foreach_copy_(_leaves(bt.state), _leaves(state))
    bt.set_state(bt.state, modes)


def spread(n, e):
    """E streams of n spread evenly, the first and the last among them."""
    if e >= n:
        return list(range(n))
    return sorted({round(i * (n - 1) / (e - 1)) for i in range(e)})


def many_ticks(bt, frame, counts):
    """{E: state} for E in ``counts``: ``bt``'s (locked) state with the
    search windows of ``spread(N, E)`` streams made TALL rows high around
    their centres, from which the step_auto tick on ``frame`` escapes
    exactly those streams through the escape fallback's many body (checked
    here, once each).  ``bt``'s state is left as it was."""
    import torch
    from headtrackr_tpu_torch.runtime.serving import _clone
    n = frame.shape[0]
    clean, modes = _clone(bt.state), bt.modes.copy()
    states = {}
    for e in counts:
        state = _clone(clean)
        idx = torch.tensor(spread(n, e), device=frame.device)
        win = state.cs.window
        cy = win[idx, 1] + win[idx, 3] // 2
        win[idx, 1] = torch.clamp(cy - TALL // 2, 0, H - TALL)
        win[idx, 3] = TALL
        restore(bt, state, modes)
        esc = bt.step_auto(frame).escaped
        many = bt._steps._programs[n].runs[10]
        if sorted(torch.nonzero(esc).flatten().tolist()) != idx.tolist() \
                or many != 1:
            raise SystemExit(f"many {e}: the tick escaped "
                             f"{int(esc.sum())} streams, many body runs "
                             f"{many}")
        states[e] = state
    restore(bt, clean, modes)
    torch.cuda.synchronize()
    return states


def cold_cases(bt, frame):
    """The cold start's ticks by kind from ``bt``'s initial state (which
    ``bt`` is left in): {"cold wbtrack": the step_auto tick on ``frame``
    from that state, "cold full": the one from the state after 15 such
    ticks, every stream in VJ} as (call, 1, REPS, set-up)."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft
    from headtrackr_tpu_torch.runtime.serving import _clone
    if (bt.modes != ft.MODE_WB).any():
        raise SystemExit("cold: the tracker is not in its initial state")
    cold = _clone(bt.state), bt.modes.copy()
    for _ in range(15):
        bt.step_auto(frame)
    if (bt.modes != ft.MODE_VJ).any():
        raise SystemExit("cold: 15 wbtrack ticks left streams outside VJ")
    vj = _clone(bt.state), bt.modes.copy()
    restore(bt, *cold)
    torch.cuda.synchronize()
    return {"cold wbtrack": (lambda: bt.step_auto(frame), 1, REPS,
                             lambda: restore(bt, *cold)),
            "cold full": (lambda: bt.step_auto(frame), 1, REPS,
                          lambda: restore(bt, *vj))}


def many_cases(bt, frame, counts, modes):
    """The many E cases of ``many_ticks``: {"many E": (call, 1, REPS,
    set-up)}."""
    states = many_ticks(bt, frame, counts)
    return {f"many {e}": (lambda: bt.step_auto(frame), 1, REPS,
                          lambda s=s: restore(bt, s, modes))
            for e, s in states.items()}


def busy_span(fn, ticks, reps, before=None):
    """Median device span ms a tick of fn() with the host's enqueue hidden:
    the stream spins SPIN_CYCLES first (``torch.cuda._sleep``) and the
    first event waits behind the spin, by which time the host has
    enqueued the call, so the span is the device's from the call's first
    operation to its last.  (torch.profiler sees a WHILE node's first
    iteration only: this sees every chunk of a many tick.)"""
    import numpy as np
    import torch
    span = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b) / ticks)
    return float(np.median(span))


def run_cases(cases, res):
    """Each case timed (host_ms, busy_span), then profiled (a throwaway
    session first), into ``res``."""
    for name, (fn, ticks, reps, before) in cases.items():
        host, span = host_ms(fn, ticks, reps, before)
        res[name] = {"host_ms_per_tick": host, "span_ms_per_tick": span,
                     "busy_span_ms_per_tick": busy_span(fn, ticks, reps,
                                                        before)}
    import torch
    profiled(lambda: torch.ones(1, device="cuda").sum(), 1)  # a first
    # session loses events
    for name, (fn, ticks, reps, before) in cases.items():
        if before is not None:
            before()
        res[name].update(profiled(fn, ticks))
        print(f"{name}: {json.dumps(res[name])}", flush=True)


def _tool(name):
    """This checkout's tools/<name>.py (a script, loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tracker(n, dev, chunks, **kw):
    """A BatchedTracker of n streams of H x W, bucket 8, with the many
    escape body's big and small chunks ``chunks`` (0: the checkout's)
    set before its programs are built."""
    from headtrackr_tpu_torch import BatchedTracker
    bt = BatchedTracker(n, (H, W), device=dev, bucket=8, **kw)
    big, small = chunks
    if big:
        bt._steps.escape_chunk = big
    if small:
        bt._steps.escape_tail = small
    return bt


def big(pool, dev, card, root, only, chunks):
    """The --big case: {"big": {"host_ms_per_tick": [...],
    "span_ms_per_tick": [...], "pending": pending streams over the timed
    calls}, "many E": ...} (``only``: the many cases alone)."""
    import torch
    from headtrackr_tpu_torch.models import facetracker as ft
    tile = BIG // N
    before = torch.cuda.memory_allocated(dev)
    bt = tracker(BIG, dev, chunks, **CONFIGS["headline"])
    bt.warmup(scan_len=BIG_K)
    held = torch.cuda.memory_allocated(dev) - before
    cold = pool[[0] * BIG_K].repeat(1, tile, 1, 1, 1)
    cold_frame = cold[0].contiguous()
    ticks = {} if only else cold_cases(bt, cold_frame)
    for _ in range(16 // BIG_K):
        bt.run_scan(cold)
    del cold
    steady = pool[[t % LOSS_AT for t in range(BIG_K)]].repeat(
        1, tile, 1, 1, 1)
    bt.run_scan(steady)
    res = {"tracker_mb": held / 2 ** 20,
           "host_ms_per_tick": [], "span_ms_per_tick": [], "pending": 0,
           "commit_tables": _tool("torch_graph_nodes").commit_tables(bt)}
    for _ in range(0 if only else REPS):
        host, span = host_ms(lambda: bt.run_scan(steady), BIG_K, 1)
        res["host_ms_per_tick"].append(host)
        res["span_ms_per_tick"].append(span)
        res["pending"] += int((bt.modes != ft.MODE_CS).sum())
    print(f"big {BIG}: {json.dumps(res)}", flush=True)
    many = {}
    frame = steady[1].contiguous()
    del steady
    from headtrackr_tpu_torch.runtime.serving import _clone
    clean, modes = _clone(bt.state), bt.modes.copy()
    run_cases({**ticks, "tick": (lambda: bt.step_auto(frame), 1, REPS,
                                 lambda: restore(bt, clean, modes)),
               **many_cases(bt, frame, BIG_MANY, modes)}, many)
    print(json.dumps({"card": card, "root": root, "big": res, **many}))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose headtrackr_tpu_torch to time")
    p.add_argument("--big", action="store_true",
                   help=f"time the headline at {BIG} streams instead")
    p.add_argument("--only", default="",
                   help="comma-separated case name prefixes to run")
    p.add_argument("--chunk", type=int, default=0,
                   help="the many escape body's big chunk (0: the "
                   "checkout's)")
    p.add_argument("--tail", type=int, default=0,
                   help="its small chunk (0: the checkout's)")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_sched_times: no CUDA device", file=sys.stderr)
        return 1
    from bench import build_pool
    from headtrackr_tpu_torch.models import facetracker as ft
    chunks = (args.chunk, args.tail)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    pool = torch.as_tensor(build_pool(N, H, W, POOL, 4,
                                      np.random.default_rng(0))).to(dev)
    only = [x for x in args.only.split(",") if x]
    if args.big:
        return big(pool, dev, card, os.path.abspath(args.root),
                   only == ["many"], chunks)
    if only == ["many"]:  # the headline tracker alone
        before = torch.cuda.memory_allocated(dev)
        bt = tracker(N, dev, chunks, **CONFIGS["headline"])
        bt.warmup(scan_len=K)
        held = torch.cuda.memory_allocated(dev) - before
        for _ in range(16):
            bt.step_auto(pool[0])
        bt.run_scan(pool[[t % LOSS_AT for t in range(K)]].contiguous())
        res = {"tracker_mb": held / 2 ** 20}
        run_cases(many_cases(bt, pool[1], MANY, bt.modes.copy()), res)
        print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                          **res}))
        return 0
    steady = pool[[t % LOSS_AT for t in range(K)]].contiguous()
    cold = pool[[0] * K].contiguous()
    lost = pool[1].clone()
    lost[:8] = torch.tensor([0, 0, 250], dtype=torch.uint8, device=dev)
    wb = pool[[0] * 15].contiguous()
    burst = pool[[0] * 8].contiguous()
    trackers, held = {}, {}
    for name, kw in CONFIGS.items():
        before = torch.cuda.memory_allocated(dev)
        bt = tracker(N, dev, chunks, **kw)
        bt.warmup(scan_len=K)
        held[f"tracker_mb {name}"] = \
            (torch.cuda.memory_allocated(dev) - before) / 2 ** 20
        for _ in range(16):
            bt.step_auto(pool[0])
        if (bt.modes != ft.MODE_CS).mean() > 0.01:
            raise SystemExit(f"{name}: the pool did not lock")
        bt.run_scan(steady)
        trackers[name] = bt
    rot = tracker(N, dev, chunks, overload="rotate", **CONFIGS["headline"])
    rot.warmup(scan_len=K)
    head = trackers["headline"]

    def relocked():
        for _ in range(3):
            head.run_scan(steady)

    def unlock():
        head.step_auto(lost)
        if int((head.modes != ft.MODE_CS).sum()) != 8:
            raise SystemExit("the blue frame did not unlock 8 streams")

    def to_burst():
        rot.reset()
        rot.run_scan(wb)
        if int((rot.modes == ft.MODE_VJ).sum()) != N:
            raise SystemExit("the cold start did not leave every stream VJ")

    from headtrackr_tpu_torch.runtime.serving import _clone
    clean, clean_modes = _clone(head.state), head.modes.copy()
    head.reset()
    cold_ticks = cold_cases(head, pool[0])
    restore(head, clean, clean_modes)
    esc_state, esc_modes, esc_frame = escape_tick(head, pool)

    def escaping():
        return head.step_auto(esc_frame)

    # name -> (call, ticks, timing repetitions, set-up before each)
    cases = {f"scan {name}": (lambda bt=bt: bt.run_scan(steady), K, REPS,
                              None) for name, bt in trackers.items()}
    cases.update({
        "step_auto": (lambda: head.step_auto(pool[1]), 1, 3 * REPS, None),
        **{f"tick {name}": (lambda bt=trackers[name]: bt.step_auto(pool[1]),
                            1, 3 * REPS, None)
           for name in ("band", "full-frame")},
        "cold": (lambda: head.run_scan(cold), K, 1, head.reset),
        **cold_ticks,
        "relock": (lambda: head.step_auto(pool[2]), 1, REPS, unlock),
        "rotate": (lambda: rot.run_scan(burst), 8, 1, to_burst),
        "escape": (escaping, 1, REPS,
                   lambda: restore(head, esc_state, esc_modes)),
        **many_cases(head, pool[1], MANY, clean_modes)})
    if only:
        cases = {k: v for k, v in cases.items()
                 if any(k.startswith(o) for o in only)}
    res = dict(held)
    # the host clock first: once torch.profiler has run in a process, a
    # launch of a graph with conditional nodes costs the host far more
    for name, (fn, ticks, reps, before) in cases.items():
        if name == "relock":
            relocked()
        host, span = host_ms(fn, ticks, reps, before)
        res[name] = {"host_ms_per_tick": host, "span_ms_per_tick": span}
        if name == "step_auto":
            res["split"] = split(head, head._frames(pool[1]), 3 * REPS)
            print(f"split: {json.dumps(res['split'])}", flush=True)
    profiled(lambda: steady.sum(), 1)  # a first session loses events
    for name, (fn, ticks, reps, before) in cases.items():
        if name == "relock":
            relocked()
        if before is not None:
            before()
        res[name].update(profiled(fn, ticks))
        print(f"{name}: {json.dumps(res[name])}", flush=True)
    restore(head, esc_state, esc_modes)
    if int(escaping().escaped.sum()) != ESCAPES or \
            head._steps._programs[N].runs[9] != 1:
        raise SystemExit(f"escape: the replayed tick did not escape "
                         f"{ESCAPES} streams through the few body")
    restore(head, clean, clean_modes)
    host, span = host_ms(*cases["step_auto"][:3])
    res["step_auto after profiler"] = {"host_ms_per_tick": host,
                                       "span_ms_per_tick": span}
    print(f"step_auto after profiler: "
          f"{json.dumps(res['step_auto after profiler'])}", flush=True)
    print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
