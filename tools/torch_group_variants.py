#!/usr/bin/env python3
"""Where the port's ``group`` kernel spends its time: variants of
headtrackr_tpu_torch/csrc/group.cu, timed on one NVIDIA GPU.

    python3 tools/torch_group_variants.py

Each variant is the shipped source with text substitutions (each made
wherever its text occurs: both the warp's and the CTA's paths), built by nvcc
with the package's flags into build/group_variants/ and loaded with
ctypes.  The probes end every thread (PTX ``exit``) at one point of the
kernel, so the time of a probe is the kernel's up to that point (their
outputs are wrong by design; they are only timed):
  exit_staged   after the slots are read and staged in shared memory;
  exit_rows     after the neighbour rows (ballots);
  exit_labels   after the rounds of pointer jumping and hooking;
  exit_sums     after the member sums and the grouped boxes;
  exit_kept     after the containment test, before the stores and pick;
  no_cta        the CTA's path (k > 32) cut out: is warp 0's time the
                kernel's code size (instruction fetch)?  (wrong past k = 32);
  rolled_hook   the CTA's hooking loop over a row word not unrolled (a
                design variant: its outputs are the shipped ones);
  shipped       the whole kernel;
  empty         group_floor_launch, an empty kernel at the same grid.
Inputs (tools/torch_group_times.py's): the cascade's candidates on the
bench pool at N = 256, 8 and 1 (k <= 2: warp 0 alone), the toy cascade
on random frames at N = 256 (every slot valid) and the adversarial chain,
shuffled chain, singletons and dense slots (N = 1).  Each is timed by CUDA
graph replay (chip_smoke.graph_ms), variants in turns (forward, then
backward).  Prints one JSON line.  Needs a card; exits 1 without one.
Imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXIT = '  asm volatile("exit;");\n'
VARIANTS = {
    "exit_staged": [("  if (k <= 32) {  // every valid slot",
                     EXIT + "  if (k <= 32) {  // every valid slot")],
    "exit_rows": [("  int lab = v ? __ffs(row) - 1 : lane;",
                   EXIT + "  int lab = v ? __ffs(row) - 1 : lane;"),
                  ("  __syncthreads();\n  uint32_t row[kWords];",
                   "  __syncthreads();\n" + EXIT + "  uint32_t row[kWords];")],
    "exit_labels": [("  const unsigned long long fx[4]",
                     EXIT + "  const unsigned long long fx[4]"),
                    ("  if (v) {  // member sums",
                     EXIT + "  if (v) {  // member sums")],
    "exit_sums": [("  const bool is_rep = cnt > 0",
                   EXIT + "  const bool is_rep = cnt > 0")],
    "exit_kept": [("  const int64_t at = n * cap + t;\n  if (t < cap) {",
                   EXIT + "  const int64_t at = n * cap + t;\n"
                   "  if (t < cap) {")],
    "no_cta": [("  group_cta(s, t, v, k, x, y, w, h, c, e, min_neighbors, o, keep);",
                "  keep = false;")],
    "rolled_hook": [("#pragma unroll\n          for (int b = 0; b < 32; ++b)",
                     "#pragma unroll 1\n          for (int b = 0; b < 32; ++b)")],
    "shipped": [],
}


def build(variants):
    from headtrackr_tpu_torch.kernels import build as B
    src = (B.CSRC / "group.cu").read_text()
    out = os.path.join(ROOT, "build", "group_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        s = src
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"{name}: {a!r} is not in group.cu")
            s = s.replace(a, b)
        cu = os.path.join(out, f"group_{name}.cu")
        with open(cu, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"group_{name}.so"))
        for fn, argtypes in B._SIGNATURES["group"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_group_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tools"))
    from chip_smoke import graph_ms, smi
    from headtrackr_tpu_torch.kernels.group import group
    from torch_group_times import inputs as group_inputs

    dev = torch.device("cuda", 0)
    libs = build(VARIANTS)
    inputs = group_inputs(dev)

    def call(lib, args):
        n, k = args[0].shape
        slots = torch.empty((6, n, k), dtype=torch.float32, device=dev)
        kept = torch.empty((n, k), dtype=torch.bool, device=dev)
        best = torch.empty((5, n), dtype=torch.float32, device=dev)
        found = torch.empty((n,), dtype=torch.bool, device=dev)

        def run():
            err = lib.group_launch(*(a.data_ptr() for a in args),
                                   slots.data_ptr(), kept.data_ptr(),
                                   best.data_ptr(), found.data_ptr(), n, k,
                                   1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cudaError {err}")
        return run, (slots, kept, best, found)

    for label, args in inputs.items():  # the shipped copy is the package's
        run, (slots, kept, best, found) = call(libs["shipped"], args)
        run()
        want, wb = group(*args, 1)
        torch.cuda.synchronize()
        if not (torch.equal(kept, want["kept"])
                and torch.equal(best, torch.stack(wb[1:]))):
            raise AssertionError(f"the shipped copy differs on {label}")
    order = list(VARIANTS) + ["empty"]
    res = {"card": smi(), "graph_ms": {k: {} for k in inputs}}
    for turn in (order, order[::-1]):
        for name in turn:
            for label, args in inputs.items():
                if name == "empty":
                    lib = libs["shipped"]
                    n = args[0].shape[0]

                    def run(lib=lib, n=n):
                        lib.group_floor_launch(
                            n, torch.cuda.current_stream().cuda_stream)
                else:
                    run, _ = call(libs[name], args)
                res["graph_ms"][label].setdefault(name, []).append(
                    graph_ms(run, reps=50))
    for label, row in res["graph_ms"].items():
        print(label + ": " + ", ".join(
            f"{k} {sum(v) / len(v):.5f}" for k, v in row.items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
