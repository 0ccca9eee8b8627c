"""The check's control: the reference in the nearest lower precision in the
program's place, which the check has to call not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's pool and sample as a run makes them (on the card,
from the seed), the sampled streams through the reference in float64 and
in bfloat16 (every float of camshift, the smoother and the head position
rounded to bfloat16), and the check's numbers of the bfloat16 outputs
against the float64 ones over ``--ticks`` run ticks.  Prints one JSON
line a seed and exits 1 if the limits call any seed's control correct.
The benchmark's runs do not run it.  ``--device cpu`` and ``--root`` as in
run.py (the harness's tests run it at a small size).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(root, workload, seed, ticks, device, workers=None):
    """(the control's numbers, the limits, correct) for one seed."""
    import numpy as np
    import torch

    from benchmark.lib import check
    from benchmark.lib.pool import build_pool
    from benchmark.reference.serving import expand
    from benchmark.run import load_spec

    _, _, config, traffic = load_spec(root, workload)
    pool = build_pool(int(config["streams"]), tuple(config["frame"]),
                      traffic, seed, torch.device(device))
    sample = check.sample_streams(int(config["streams"]), pool.lost_set(),
                                  seed, **config["check"]["sample"])
    frames = [pool.stream(int(s)) for s in sample]
    del pool
    kw = config["tracker"]
    band = tuple(kw["band"]) if kw.get("band") else None
    args = (frames, band, bool(kw.get("bandHist", False)))
    n_lock = int(traffic["lock_ticks"])
    ref = check.reference_cycles(*args, n_lock=n_lock, workers=workers)
    low = check.reference_cycles(*args, precision="bf16", n_lock=n_lock,
                                 workers=workers)
    run_ticks = np.arange(ticks)
    got = np.stack([expand(*c, run_ticks) for c in low], 1)
    limits = config["check"]["limits"]
    numbers, _ = check.compare(got, run_ticks, ref, limits)
    correct, _ = check.judge(numbers, limits)
    return numbers, limits, correct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ticks", type=int, default=8000,
                    help="run ticks compared (a 10-s window holds 2,000-"
                         "8,000)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args(argv)
    failed_all = True
    for seed in args.seeds:
        numbers, limits, correct = control(args.root, args.workload, seed,
                                           args.ticks, args.device,
                                           args.workers)
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "numbers": numbers,
                          "limits": limits}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
