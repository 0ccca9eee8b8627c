"""The benchmark of headtrackr_tpu_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration (its
file: the streams, the frame, the tracker's knobs, the limits of the
check) and a traffic mix (``benchmark/traffic/<traffic>.json``: the pool,
the face losses, the lock phase, the calls).  Set-up: the kernels' build
or load, the tracker and its serving program, the pool made on the card
from the seed, the lock phase and one pass of the cell's calls.  The
window: whole calls until ``--seconds`` have passed, each ending in a
host read of the outputs users consume.  ``--trace 1`` measures the
per-layer metrics instead: the cell's calls with CUDA events around each
program launch for ``--seconds``, then two pool passes of one tick a
launch under ``torch.profiler``.  Every metric is read by its file
``benchmark/metrics/<name>.py`` (``read(ctx)``: a number, or None where it
finds nothing to read).

After the window the sampled streams' outputs are held against the plain
reference (``benchmark/lib/check.py``), each number beside its limit on
standard error and under ``checks``, the last key of the result.  The run
fails, printing no result, with no card (or fewer than the cell asks
for), or with jax, jaxlib, flax, the JAX package or its bench scripts
among the loaded modules once the window has closed.

``--device cpu`` runs the kernels' plain twins on the CPU at whatever size
the configuration gives: the harness's own tests use it with small
configurations (``--root``: a directory holding their BENCHMARK.json).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# keep libraries that the port may load from pulling in JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

PROFILED_PASSES = 2


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_spec(root, workload):
    """(spec, cell, config, traffic) of ``workload`` from root's
    BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"({', '.join(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return spec, cell, config, traffic


def cell_metrics(spec, cell, trace):
    """The cell's metrics: the end-to-end ones (trace off) or the
    per-layer ones (trace on) whose ``workloads`` name it or that have
    none."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def card_lines():
    """nvidia-smi's name, power limit and clocks of each card, or why it
    could not be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the plain twins (the harness's tests)")
    ap.add_argument("--root", default=ROOT,
                    help="the directory holding BENCHMARK.json")
    ap.add_argument("--workers", type=int, default=None,
                    help="processes of the reference check")
    return ap.parse_args(argv)


def main(argv=None, hook=None):
    """Run one cell; return (exit code, result dict or None).  ``hook``,
    if given, is called with the tracker once it is built (the harness's
    fault tests break the timed path there)."""
    args = parse_args(argv)
    spec, cell, config, traffic = load_spec(args.root, args.workload)

    import torch

    from benchmark.lib import check, drive, guard
    from benchmark.lib.readers import reader_of
    from benchmark.lib.pool import build_pool

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(cell["chips"]):
            log(f"# no result: the cell needs {cell['chips']} CUDA "
                f"device(s), this machine has {have}")
            return 2, None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(device)}")
        from headtrackr_tpu_torch.kernels.build import load_library
        t = time.perf_counter()
        load_library()
        log(f"# kernels loaded in {time.perf_counter() - t:.2f}s, "
            f"{time.perf_counter() - T_START:.2f}s from the start")
    else:
        device = torch.device("cpu")
    torch.manual_seed(0)

    t = time.perf_counter()
    bt = drive.make_tracker(config, device)
    log(f"# tracker and program built in {time.perf_counter() - t:.2f}s")
    if hook is not None:
        hook(bt)
    t = time.perf_counter()
    pool = build_pool(bt.n, tuple(config["frame"]), traffic, args.seed,
                      device)
    sample = check.sample_streams(bt.n, pool.lost_set(), args.seed,
                                  **config["check"]["sample"])
    log(f"# pool of {pool.ticks.shape[0]} ticks made in "
        f"{time.perf_counter() - t:.2f}s; {pool.lost_set().size} streams "
        f"lose their face; sample {sample.tolist()}")
    reader = drive.Reader(device, sample)
    t = time.perf_counter()
    tick = drive.lock_and_warm(bt, pool, traffic, reader)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"# lock phase and warm pass in {time.perf_counter() - t:.2f}s; "
        f"set-up {setup_s:.2f}s; locked "
        f"{float((reader.last_mode == 2).mean()):.4f}")

    window, tick = drive.run_window(bt, pool, traffic, reader, tick,
                                    args.seconds, trace=bool(args.trace))
    log(f"# window: {window.ticks} ticks x {bt.n} streams in "
        f"{window.seconds:.3f}s, {len(window.calls)} calls; bodies run "
        f"{drive.body_runs(bt, window)}")
    profile = None
    if args.trace and device.type == "cuda":
        profile, tick = drive.profile_ticks(
            bt, pool, reader, tick, PROFILED_PASSES * pool.ticks.shape[0])
        log(f"# profiled {profile['ticks']} ticks: "
            f"{profile['device_events']} device events")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    ctx = dict(n=bt.n, frame=tuple(config["frame"]), config=config,
               traffic=traffic, setup_s=setup_s, window=window,
               profile=profile, relock_bodies=drive.relock_bodies(bt),
               device=device.type)
    frames = [pool.stream(int(s)) for s in sample]
    got, ticks = reader.sampled()
    pending_max = reader.pending_max
    del bt, pool, reader
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in cell_metrics(spec, cell, bool(args.trace)):
        v = reader_of(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t = time.perf_counter()
    tracker_kw = config["tracker"]
    band = tracker_kw.get("band")
    cycles = check.reference_cycles(
        frames, tuple(band) if band else None,
        bool(tracker_kw.get("bandHist", False)),
        n_lock=int(traffic["lock_ticks"]), workers=args.workers)
    limits = config["check"]["limits"]
    numbers, failed = check.compare(got, ticks, cycles, limits,
                                    pending_max)
    correct, rows = check.judge(numbers, limits)
    log(f"# reference: {len(sample)} streams x {ticks.size} ticks in "
        f"{time.perf_counter() - t:.2f}s; cycles "
        f"{[(c[0], c[1]) for c in cycles]}")

    found = guard.forbidden_loaded()
    if found:
        log(f"# no result: forbidden modules loaded: {', '.join(found)}")
        return 3, None

    if device.type == "cuda":
        # read once the window has closed, so that set-up does not wait on it
        log(f"# card: {card_lines()}")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(window.ticks * ctx["n"]),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = rows
    for name, r in rows.items():
        log(f"check {name}: {r['value']} (limit {r['limit']})")
    print(json.dumps(result), flush=True)
    return 0, result


if __name__ == "__main__":
    sys.exit(main()[0])
