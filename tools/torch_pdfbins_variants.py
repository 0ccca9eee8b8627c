#!/usr/bin/env python3
"""Where the port's ``pdf_bins`` kernel keeps its table, and how many CTAs
a row it wants: variants of headtrackr_tpu_torch/csrc/pdfbins.cu timed on
one NVIDIA GPU.

    python3 tools/torch_pdfbins_variants.py

Each variant is the shipped source with text substitutions, built by nvcc
with the package's flags into build/pdfbins_variants/ and loaded with
ctypes (tools/torch_histpdf_variants.py build_variants):
  shipped   the table staged in shared memory (float4 loads), four 16-byte
            vectors of ids loaded a thread before the first lookup;
  ldg       no staging: each lookup an __ldg of the table through L1;
  unroll1   one vector of ids a thread at a time.
Every variant must equal the plain lookup (ops/histogram.py
pdf_bins_plain, tolerance 0) on every workload at every C.  Workloads: the
bench pool's bins (256 x 240x320, face_noise 0: few distinct bins a warp)
and uniform random ids of [-64, 4160) (spread bins: shared-memory bank
conflicts; ids outside the range among them), each at N = 256 and N = 1,
with uniform random weights.  Each is timed by CUDA-graph replay
(chip_smoke.graph_ms): the variants at kernels/pdfbins.py pdf_split's C in
turns (forward, then backward), then the shipped source at other C in
turns, beside torch.gather of the same table at the same (valid) ids and
the byte bound.  Prints the card's name and power limit and one JSON line.
Needs a card; exits 1 without one.  Imports nothing of JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 256, 240, 320
STAGE = ("  for (int i = threadIdx.x; i < kBins / 4; i += kThreads) "
         "table4[i] = w4[i];\n  __syncthreads();\n"
         "  const float* table = reinterpret_cast<const float*>(table4);")
VARIANTS = {
    "shipped": [],
    "ldg": [(STAGE, "  const float* table = reinterpret_cast<const float*>"
                    "(w4);"),
            ("const float w = table[id & (kBins - 1)];",
             "const float w = __ldg(table + (id & (kBins - 1)));")],
    "unroll1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
}
SIZES = {N: (1, 2, 4, 8, 16, 32), 1: (8, 16, 38, 75, 150)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_pdfbins_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from bench import build_pool
    from chip_smoke import bound, graph_ms, smi
    from torch_histpdf_variants import build_variants
    from headtrackr_tpu_torch.kernels.launch import sm_count
    from headtrackr_tpu_torch.kernels.pdfbins import pdf_split
    from headtrackr_tpu_torch.ops import histogram as hg

    dev = torch.device("cuda", 0)
    sms = sm_count(dev)
    fns = build_variants("pdfbins", VARIANTS, os.path.join(
        ROOT, "build", "pdfbins_variants"))
    g = torch.Generator().manual_seed(17)
    bench = hg.rgb_bins(torch.as_tensor(build_pool(
        N, H, W, 2, 0, np.random.default_rng(0), face_noise=0)[1]).to(
            dev)).view(N, -1)
    rand = torch.randint(-64, 4160, (N, H * W), generator=g).int().to(dev)
    weights = torch.rand((N, 4096), generator=g).to(dev)
    work = {"bench": bench, "bench n1": bench[:1].contiguous(),
            "random": rand, "random n1": rand[:1].contiguous()}
    out = torch.empty((N, H * W), dtype=torch.float32, device=dev)

    def call(name, ids, c):
        n, p = ids.shape
        err = fns[name]["pdf_bins_launch"](
            ids.data_ptr(), weights.data_ptr(), out.data_ptr(), n, p, c,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return out[:n]

    for name in fns:
        for wname, ids in work.items():
            want = hg.pdf_bins_plain(ids, weights[:ids.shape[0]])
            for c in sorted({pdf_split(*ids.shape, sms),
                             *SIZES[ids.shape[0]]}):
                got = call(name, ids, c)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{name}: {wname} differs at C={c}")
    card = smi()
    print(card, flush=True)
    res = {"card": card}
    for wname, ids in work.items():
        n, p = ids.shape
        c0 = pdf_split(n, p, sms)
        valid = ids.long().clamp(0, 4095)
        t = {k: [] for k in fns}
        for name in list(fns) + list(fns)[::-1]:
            t[name].append(graph_ms(lambda name=name: call(name, ids, c0)))
        by_c = {c: [] for c in SIZES[n]}
        for c in list(SIZES[n]) + list(SIZES[n])[::-1]:
            by_c[c].append(graph_ms(lambda c=c: call("shipped", ids, c)))
        res[wname] = {
            "C": c0, "variants": t, "shipped by C": by_c,
            "gather_ms": graph_ms(lambda: torch.gather(weights[:n], 1, valid)),
            "bound_ms": bound(8 * n * p + 4 * 4096 * n, 0)[0]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
