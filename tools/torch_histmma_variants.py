#!/usr/bin/env python3
"""What paces the port's ``hist_mma`` kernel: variants of
headtrackr_tpu_torch/csrc/histmma.cu, timed on one NVIDIA GPU.

    python3 tools/torch_histmma_variants.py

Each variant is the shipped source with one text substitution, built by
nvcc with the package's flags into build/histmma_variants/ and loaded with
ctypes:
  shipped   the kernel as it is;
  no_skip   every operand byte stored, also where the buffer already holds
            it (neighbouring pixels in one bin);
  no_store  no operand byte stored at all: the same loads, barriers and
            wgmma stream on tiles that stay zero (its counts are wrong by
            design; it is only timed);
  at_trusted  the in-place form taking its bulk copies without testing
            the address it loads (what a proof of alignment where the
            program is built would give; only timed in place).
Each is timed reading its frames directly and in place (the frames'
address in an i64 word, as the serving program's parameter block holds
it: the shipped in-place form tests it and takes its bulk copies where it
is 16-byte aligned).
The counting variants must equal the plain histogram (tolerance 0).  Each
is timed by CUDA-graph replay (chip_smoke.graph_ms) at 256 streams x
240x320 on the bench pool and on uniformly random frames, variants in
turns (forward, then backward), beside hist4096 and the dense one-hot
product's int8 tensor-core time.  Prints one JSON line.  Needs a card;
exits 1 without one.  Imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 256, 240, 320
STORES = ("        if (set_a[buf] >= 0) ta[set_a[buf]] = 0;\n"
          "        if (a >= 0) ta[a] = 1;\n")
STORES_B = STORES.replace("set_a", "set_b").replace("ta[", "tb[").replace(
    "(a >= 0) tb[a]", "(b >= 0) tb[b]")
VARIANTS = {
    "shipped": [],
    "no_skip": [("      if (a != set_a[buf]) {", "      if (true) {"),
                ("      if (b != set_b[buf]) {", "      if (true) {")],
    "no_store": [(STORES, ""), (STORES_B, "")],
    "at_trusted": [("                   (kLoad == kLoadAt && P % 16 == 0 &&\n"
                    "                    (reinterpret_cast<uintptr_t>(base) & "
                    "15) == 0);", "kLoad == kLoadAt;")],
}
COUNTS_WRONG = ("no_store",)


def build(variants):
    from headtrackr_tpu_torch.kernels import build as B
    src = (B.CSRC / "histmma.cu").read_text()
    out = os.path.join(ROOT, "build", "histmma_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        s = src
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"{name}: {a!r} is not in histmma.cu")
            s = s.replace(a, b)
        cu = os.path.join(out, f"histmma_{name}.cu")
        with open(cu, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out, f"histmma_{name}.so")).hist_mma_launch
        fn.argtypes = B._SIGNATURES["histmma"]["hist_mma_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_histmma_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from bench import build_pool
    from chip_smoke import INT8_OPS_PER_S, graph_ms, smi
    from headtrackr_tpu_torch.kernels.histmma import split_frame
    from headtrackr_tpu_torch.kernels.histpdf import hist4096
    from headtrackr_tpu_torch.kernels.launch import sm_count
    from headtrackr_tpu_torch.ops import histogram as hg

    dev = torch.device("cuda", 0)
    fns = build(VARIANTS)
    blocks, block_px = split_frame(N, H * W, sm_count(dev))
    out = torch.empty((N, 4096), dtype=torch.float32, device=dev)
    part = torch.empty((N, blocks, 4096), dtype=torch.int32, device=dev)

    word = torch.zeros(1, dtype=torch.int64, device=dev)

    def call(name, fr, rects, in_place=False):
        # in place: no rects (the whole frame), the frames' address in word
        if in_place:
            word.fill_(fr.data_ptr())
        err = fns[name](0 if in_place else fr.data_ptr(),
                        0 if in_place else rects.data_ptr(), part.data_ptr(),
                        out.data_ptr(), N, H, W, blocks, block_px,
                        word.data_ptr() if in_place else 0, 0,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return out

    g = torch.Generator().manual_seed(41)
    frames = {
        "bench": torch.as_tensor(build_pool(N, H, W, 2, 0,
                                            np.random.default_rng(0))[1]),
        "random": torch.randint(0, 256, (N, H, W, 3), generator=g,
                                dtype=torch.uint8)}
    frames = {k: v.to(dev) for k, v in frames.items()}
    full = hg.full_rects(N, (H, W), dev)
    for kind, fr in frames.items():
        want = hg.hist4096_plain(fr, full).float()
        for name in fns:
            if name not in COUNTS_WRONG:
                for in_place in (False, True):
                    got = call(name, fr, full, in_place)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} differs on {kind} "
                                             f"(in place: {in_place})")
    res = {"card": smi(), "streams": N, "frame": [H, W],
           "onehot_ms": 1e3 * 2 * 4096 * N * H * W / INT8_OPS_PER_S}
    for kind, fr in frames.items():
        arms = [(k, False) for k in fns if k != "at_trusted"] + [
            (k, True) for k in ("shipped", "at_trusted")]
        t = {k + (" in place" if p else ""): [] for k, p in arms}
        for name, in_place in arms + arms[::-1]:
            t[name + (" in place" if in_place else "")].append(graph_ms(
                lambda name=name, p=in_place: call(name, fr, full, p)))
        t["hist4096"] = [graph_ms(lambda: hist4096(fr, full))]
        res[kind] = t
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
