#!/usr/bin/env python3
"""How many CTAs a row the port's ``hist_bins`` kernel wants, and how many
threads a CTA: variants of headtrackr_tpu_torch/csrc/histbins.cu timed on
one NVIDIA GPU.

    python3 tools/torch_histbins_variants.py

Each variant is the shipped source with text substitutions, built by nvcc
with the package's flags into build/histbins_variants/ and loaded with
ctypes (tools/torch_histpdf_variants.py build_variants):
  shipped     the kernel as it is (256 threads a CTA);
  threads512  512 threads a CTA.
Every variant must equal the plain histogram (ops/histogram.py
hist_bins_plain, tolerance 0) on every workload at every cluster size C.
Workloads: X5's own (256 rows of 76,800 uniform random ids,
tools/kernel_experiments.py:212), the bench pool's bins (256 x 240x320,
face_noise 0), and one row: the bench pool's first frame (76,800 ids,
``camshift.Histogram``'s shape) and its first 12,288 ids (a 96x128 band's
count, where the fewest ids a CTA takes decides C).  Each is timed by
CUDA-graph replay (chip_smoke.graph_ms): the variants at
kernels/histbins.py split_bins' C in turns (forward, then backward), then
the shipped source at every C of 1, 2, 4, 8 and 16 in turns.  Prints one
JSON line.  Needs a card; exits 1 without one.  Imports nothing of JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 256, 240, 320
VARIANTS = {
    "shipped": [],
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;")],
}
SIZES = (1, 2, 4, 8, 16)


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_histbins_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from bench import build_pool
    from chip_smoke import graph_ms, smi
    from torch_histpdf_variants import build_variants
    from headtrackr_tpu_torch.kernels.histbins import split_bins
    from headtrackr_tpu_torch.kernels.launch import sm_count
    from headtrackr_tpu_torch.ops import histogram as hg

    dev = torch.device("cuda", 0)
    sms = sm_count(dev)
    fns = build_variants("histbins", VARIANTS, os.path.join(
        ROOT, "build", "histbins_variants"))
    bench = hg.rgb_bins(torch.as_tensor(build_pool(
        N, H, W, 2, 0, np.random.default_rng(0), face_noise=0)[1]).to(
            dev)).view(N, -1)
    work = {
        "x5": torch.as_tensor(np.random.default_rng(0).integers(
            0, 4096, (N, 8, 9600)).astype(np.int32)).view(N, -1).to(dev),
        "bench": bench,
        "n1": bench[:1].contiguous(),
        "n1 12288": bench[:1, :12288].contiguous(),
    }
    out = torch.empty((N, 4096), dtype=torch.float32, device=dev)

    def call(name, ids, c):
        n, p = ids.shape
        err = fns[name]["hist_bins_launch"](
            ids.data_ptr(), out.data_ptr(), n, p, c,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return out[:n]

    for name in fns:
        for wname, ids in work.items():
            want = hg.hist_bins_plain(ids)
            for c in SIZES:
                got = call(name, ids, c)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}: {wname} differs at C={c}")
    res = {"card": smi(), "split_bins": {
        w: split_bins(*ids.shape, sms) for w, ids in work.items()}}
    for wname, ids in work.items():
        c0 = res["split_bins"][wname]
        t = {k: [] for k in fns}
        for name in list(fns) + list(fns)[::-1]:
            t[name].append(graph_ms(lambda name=name: call(name, ids, c0)))
        res[wname] = t
        t = {c: [] for c in SIZES}
        for c in list(SIZES) + list(SIZES)[::-1]:
            t[c].append(graph_ms(lambda c=c: call("shipped", ids, c)))
        res[f"{wname} by C"] = t
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
