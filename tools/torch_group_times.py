"""Times of the ``group`` kernel on the card, by CUDA graph replay, in the
checkout at ``--root`` (default: this one), so that two checkouts can be
compared in turns on one card (tools/torch_compare.sh runs it
parent, change, change, parent):

    python3 tools/torch_group_times.py [--root build/parent]

Inputs: the cascade's candidates (real cascade, capacity 256) on the bench
pool's second batch of 240x320 frames at N = 256, 8 and 1; the toy
cascade on uniform random frames at N = 256 (every slot valid: the worst
case; the frames of chip_smoke.py phase 3's "random toy N=256
(overflow)"); and tools/torch_group_cases.py's chain, shuffled chain,
singletons and dense slots (N = 1).  Where the checkout's library has
``group_floor_launch``, also the empty kernel at group's grid (the floor of
one device operation).  Prints the card's name and power limit, then one
JSON line {label: graph ms}.  Needs a CUDA card.  The timer is the root's
chip_smoke.graph_ms (50 calls replayed from a graph).
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 240, 320
REPS = 50


def _cases_module():
    spec = importlib.util.spec_from_file_location(
        "torch_group_cases", os.path.join(HERE, "tools",
                                          "torch_group_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(dev):
    """{label: group's six (N, 256) inputs on dev}: the candidates of the
    bench pool (real cascade) at N = 256, 8 and 1, of random frames (toy
    cascade, every slot valid) at N = 256, and four adversarial slot sets."""
    import numpy as np
    import torch
    from bench import build_pool
    from headtrackr_tpu_torch.cascade import frontalface, toy_cascade
    from headtrackr_tpu_torch.kernels.cascade import cascade
    from headtrackr_tpu_torch.kernels.pyramid import pyramid
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.ops.imageproc import grayscale
    keys = ("x", "y", "width", "height", "confidence", "valid")
    pool = build_pool(256, H, W, 16, 4, np.random.default_rng(0))
    bench = grayscale(torch.as_tensor(pool[1]).to(dev))
    g = torch.Generator().manual_seed(13)
    rand = torch.randint(0, 256, (256, H, W), generator=g,
                         dtype=torch.uint8).to(dev)
    real = td.detector_tables(W, H, frontalface(), 5, dev)
    toy = td.detector_tables(W, H, toy_cascade(), 5, dev)

    def candidates(gray, tables):
        cand = cascade(pyramid(gray, tables), tables, 256)
        return [cand[k] for k in keys]

    out = {f"bench N={n}": candidates(bench[:n].contiguous(), real)
           for n in (256, 8, 1)}
    out["random toy N=256 (overflow)"] = candidates(rand, toy)
    cases = _cases_module().cases(np.random.default_rng(15))
    for name in ("chain", "chain shuffled", "singletons", "dense"):
        out[f"{name} N=1"] = [torch.as_tensor(a).to(dev)
                              for a in cases[name]]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose headtrackr_tpu_torch to time")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)  # bench.build_pool where the root has none
    import torch
    from chip_smoke import graph_ms, smi
    from headtrackr_tpu_torch.kernels.build import load_library
    from headtrackr_tpu_torch.kernels.group import group

    if not torch.cuda.is_available():
        print("torch_group_times: no CUDA device", file=sys.stderr)
        return 1
    print(smi())
    out = {label: graph_ms(lambda: group(*a, 1), reps=REPS)
           for label, a in inputs(torch.device("cuda", 0)).items()}
    try:
        floor = load_library().fn("group_floor_launch")
    except KeyError:
        floor = None  # a checkout from before the floor kernel
    if floor is not None:
        def empty(n):
            if floor(n, torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("group_floor_launch failed")
        for n in (256, 8, 1):
            out[f"floor N={n}"] = graph_ms(lambda: empty(n), reps=REPS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
