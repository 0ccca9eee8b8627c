"""The cell's run: the tracker and its set-up, the measured window, the
traced phases.

A cell's calls are one of two kinds (the traffic's ``call``):
``{"kind": "scan", "ticks": K}``: ``BatchedTracker.run_scan`` over the K
pool ticks (K = the pool's length), or ``{"kind": "step"}``:
``BatchedTracker.step_auto`` of one tick.  Every call reads to the host
the outputs a user consumes (``reference.serving.FIELDS``) for every tick
of the call; the call's ticks are done when that read ends.  Run tick t
(counted from the end of the lock phase) sees pool tick t % P.
"""

import time

import numpy as np
import torch

from ..reference.serving import FIELDS, MODES
from . import stats

__all__ = ["make_tracker", "body_runs", "Reader", "Window",
           "lock_and_warm", "run_window", "profile_ticks"]

MODE_CS = MODES["CS"]


def make_tracker(config, device):
    """The configuration's ``BatchedTracker`` on ``device``, its serving
    program built (``warmup(host_sched=False)``: the program this cell
    launches, nothing eager)."""
    import headtrackr_tpu_torch as pt
    kw = dict(config["tracker"])
    if kw.get("band") is not None:
        kw["band"] = tuple(kw["band"])
    bt = pt.BatchedTracker(int(config["streams"]),
                           frame_shape=tuple(config["frame"]),
                           device=device, **kw)
    if device.type != "cuda":
        # the CPU runs the program's twin (the select kernels' twins and
        # the bodies uncaptured), not the per-tick path
        bt._steps.scheduled = True
    bt.warmup(host_sched=False)
    return bt


def program_of(bt):
    """The tracker's serving program at its batch size."""
    return bt._steps._programs[bt.n]


def relock_bodies(bt):
    """Indices into the program's ``runs`` of the bucket bodies (the ticks
    that serve pending streams: detector, handoff, slot_gather, merge)."""
    return [i for i, k in enumerate(bt._steps.body_keys(bt.n))
            if isinstance(k, int) and k > 0]


def body_runs(bt, window):
    """{body: runs in the window} of the program's tick bodies (its
    ``body_keys``) and its escape bodies (the few and many recomputes of
    streams whose mean shift left the band), from its own counts."""
    from headtrackr_tpu_torch.kernels import schedule
    keys = [str(k) for k in bt._steps.body_keys(bt.n)]
    keys += ["escape_" + e for e in ("none", "few", "many")]
    at = list(range(len(keys) - 3)) + [schedule.ESCAPE_RUNS + i
                                       for i in range(3)]
    return {k: sum(r[i] for r in window.runs) for k, i in zip(keys, at)}


class Reader:
    """Reads a call's outputs to the host, every field for every stream
    and tick, and keeps the sampled streams' rows, the last tick's modes
    and the most streams pending after any kept tick (those not in CS,
    which the next tick serves)."""

    def __init__(self, device, sample):
        self.device = device
        self.sample = np.asarray(sample, dtype=np.int64)
        self.rows, self.ticks = [], []
        self._bufs = {}
        self.last_mode = None
        self.pending_max = 0
        self.done = (torch.cuda.Event() if device.type == "cuda" else None)

    def read(self, out, first_tick, keep=True):
        """Copy every field of ``out`` (leaves (K, N) or (N,)) to the
        host and wait for it; keep the sample's rows for run ticks
        first_tick .. first_tick + K - 1."""
        leaves = [getattr(out, f) for f in FIELDS]
        shape = tuple(leaves[0].shape)
        if self.device.type == "cuda":
            bufs = self._bufs.get(shape)
            if bufs is None:
                bufs = [torch.empty(shape, dtype=v.dtype, pin_memory=True)
                        for v in leaves]
                self._bufs[shape] = bufs
            for b, v in zip(bufs, leaves):
                b.copy_(v, non_blocking=True)
            self.done.record()
            self.done.synchronize()
            host = [b.numpy() for b in bufs]
        else:
            host = [v.numpy() for v in leaves]
        if len(shape) == 1:
            host = [h[None] for h in host]
        modes = host[FIELDS.index("mode_after")]
        self.last_mode = modes[-1].copy()
        if keep:
            self.pending_max = max(self.pending_max,
                                   int((modes != MODE_CS).sum(1).max()))
            k = host[0].shape[0]
            self.rows.append(np.stack([h[:, self.sample] for h in host],
                                      -1).astype(np.float64))
            self.ticks.append(np.arange(first_tick, first_tick + k))
        return host

    def sampled(self):
        """(rows (T, S, len(FIELDS)) float64, run ticks (T,))."""
        return np.concatenate(self.rows), np.concatenate(self.ticks)


class _LaunchSpans:
    """CUDA events just before and after each launch of the serving
    program (its graph's ``launch`` wrapped on this tracker), read after
    each call."""

    def __init__(self, bt):
        self.graph = program_of(bt).graph
        self.inner = self.graph.launch
        self.pairs = []
        self.ms = []

        def launch():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self.inner()
            b.record()
            self.pairs.append((a, b))

        self.graph.launch = launch

    def collect(self):
        """The device ms of the launches since the last collect (their
        events are complete once the call's read has ended)."""
        got = [a.elapsed_time(b) for a, b in self.pairs]
        self.pairs = []
        self.ms.extend(got)
        return got

    def close(self):
        self.graph.launch = self.inner


class Window:
    """What a window measured: ticks, wall seconds, each call's host span
    (its start, its return, its read's end) and ticks, the program's runs
    a call, each tick's latency from device events (step calls), each
    launch's device ms (traced)."""

    def __init__(self):
        self.ticks = 0
        self.seconds = 0.0
        self.calls = []       # (t_start, t_return, t_read_end, ticks)
        self.runs = []        # the program's runs of each call
        self.tick_ms = []     # step calls: call start to read end, events
        self.launch_ms = []   # traced: each launch's device ms


def _call(bt, pool, kind, tick):
    if kind == "scan":
        return bt.run_scan(pool.ticks), pool.ticks.shape[0]
    return bt.step_auto(pool.ticks[tick % pool.ticks.shape[0]]), 1


def lock_and_warm(bt, pool, traffic, reader):
    """The lock phase (``lock_ticks`` step_auto ticks of the lock frame)
    and one pass of the cell's own calls over the pool, read as the
    window reads them (run ticks 0 .. P - 1).  Returns the next run
    tick."""
    for _ in range(int(traffic["lock_ticks"])):
        reader.read(bt.step_auto(pool.lock), 0, keep=False)
    kind = traffic["call"]["kind"]
    tick, P = 0, pool.ticks.shape[0]
    while tick < P:
        out, k = _call(bt, pool, kind, tick)
        reader.read(out, tick)
        tick += k
    return tick


def run_window(bt, pool, traffic, reader, tick, seconds, trace=False):
    """Whole calls of the cell's kind from run tick ``tick`` until
    ``seconds`` have passed; the window ends with the last call's read.
    Returns (Window, next run tick)."""
    kind = traffic["call"]["kind"]
    cuda = reader.device.type == "cuda"
    w = Window()
    spans = _LaunchSpans(bt) if trace and cuda else None
    ev = ((torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) if cuda else None)
    prog = program_of(bt)
    try:
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            if ev is not None and kind == "step":
                ev[0].record()
            out, k = _call(bt, pool, kind, tick)
            c1 = time.perf_counter()
            reader.read(out, tick)
            c2 = time.perf_counter()
            if kind == "step":
                if ev is not None:
                    ev[1].record()
                    ev[1].synchronize()
                    w.tick_ms.append(ev[0].elapsed_time(ev[1]))
                else:
                    w.tick_ms.append(1e3 * (c2 - c0))
            if spans is not None:
                spans.collect()
            w.calls.append((c0, c1, c2, k))
            w.runs.append(list(prog.runs))
            tick += k
            w.ticks += k
            if c2 - t0 >= seconds:
                break
        w.seconds = c2 - t0
    finally:
        if spans is not None:
            w.launch_ms = spans.ms
            spans.close()
    return w, tick


_LABELS = ("enqueue", "read")


def profile_ticks(bt, pool, reader, tick, n_ticks):
    """``n_ticks`` ticks from run tick ``tick``, one ``step_auto`` a
    launch (the profiler keeps a CUDA graph WHILE node's first iteration
    alone, so a K-tick launch hides its later ticks), under
    ``torch.profiler``.  The bodies are the same captured graphs as the
    cell's.  Returns (profile dict, next run tick); a session that
    records no device event is made once more, and raises if empty
    again."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for attempt in range(2):
        pending = []  # pending streams before each profiled tick
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                pending.append(int((reader.last_mode != 2).sum()))
                with record_function("enqueue"):
                    out = bt.step_auto(pool.ticks[tick % pool.ticks.shape[0]])
                with record_function("read"):
                    reader.read(out, tick)
                tick += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        p = _parse(prof.events(), wall, n_ticks)
        p["pending"] = pending
        if p["device_events"]:
            return p, tick
    raise RuntimeError("two profiler sessions recorded no device event")


def _short(name):
    """A kernel's name without its return type, namespace and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


def _parse(events, wall, n_ticks):
    """The profile of a session: each device operation's launches and
    seconds by name, the device's busy seconds, the idle gaps labelled
    by what the host was doing, the window's wall seconds."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        name = e.name
        if e.device_type == DeviceType.CUDA:
            if name in _LABELS or name.startswith("ProfilerStep"):
                continue  # the host's ranges mirrored on the device
            dev.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                        name))
        elif name in _LABELS:
            host.append((e.time_range.start * 1e-6,
                         e.time_range.end * 1e-6, name))
    kernels = {}
    for a, b, name in dev:
        c, s = kernels.get(name, (0, 0.0))
        kernels[name] = (c + 1, s + (b - a))
    spans = sorted((a, b) for a, b, _ in dev)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = []
    host.sort()
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = "host, outside the harness's calls"
        for i, (a, b, name) in enumerate(host):
            if a <= mid <= b:
                label = (f"step_auto call, enqueue" if name == "enqueue"
                         else "reading the outputs to the host")
                break
        gaps.append((label, s1 - e0))
    gaps.sort(key=lambda g: -g[1])
    top = sorted(((_short(n), s) for n, (c, s) in kernels.items()),
                 key=lambda x: -x[1])
    return {"kernels": kernels, "busy_s": stats.union_seconds(spans),
            "window_s": wall, "ticks": n_ticks,
            "device_events": len(dev),
            "device_ops": [[n, s] for n, s in top[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}

