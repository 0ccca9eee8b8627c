"""Variants of the serving program's ``slot_gather`` kernel (S5,
csrc/schedule.cu) timed on the card, on two calls:

  relock   the relock tick's bucket gather: chip_smoke.py
           ``bucket_workloads``' state of the headline's leaves at its 8
           slots over 256 streams (4 served, the rest padding), the
           bucket's keep rule;
  escape   the few escape body's gather: the same state and the bench
           pool's frames as an extra leaf, 8 slots (the last 3 streams,
           the rest padding), the escape's keep rule.

The variants are text substitutions of the shipped source, each built with
the package's nvcc flags (tools/torch_histpdf_variants.py
``build_variants``) and launched through the package's wrapper (its
``launch`` pointed at the variant's library):

  count           each warp finds its leaf by comparing its unit with
                  every leaf's first warp-unit at once (shipped: a binary
                  search);
  span2 / span4   2 or 4 warp-units a warp, all loaded before any store
                  (shipped: 1);
  threads128      128 threads a CTA (shipped: 256);
  no_grid_constant   the arguments a plain by-value parameter (shipped:
                  ``__grid_constant__``);
  leaf_a_cta      the design it replaced: a CTA a (leaf, slot), each
                  thread copying 16-byte vectors of its leaf's row in a
                  loop (its grid: the leaves times the slots).

Every variant must equal the shipped kernel's outputs bit for bit.  Each
is timed by graph replay (chip_smoke.graph_ms), in turns (forward, then
backward, TURNS times), beside the shipped kernel.  Prints the card's name
and power limit, then one JSON line.  Needs a card; exits 1 without one.
Imports nothing of JAX.

    python3 tools/torch_gather_variants.py
"""

import json
import os
import sys

TURNS = 2  # forward then backward, this many times
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SEARCH = """    int lo = 0, hi = a.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.first[mid] <= q) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    leaf[v] = q < a.warps ? lo : -1;"""
COUNT = """    int e = -1;
#pragma unroll
    for (int k = 0; k < kMaxLeaves; ++k) e += k < a.leaves && a.first[k] <= q;
    leaf[v] = q < a.warps ? e : -1;"""
KERNEL = """__global__ void __launch_bounds__(kGatherThreads)
    slot_gather_kernel("""
# the design it replaced, on the same arguments
LEAF_A_CTA = """__global__ void __launch_bounds__(kGatherThreads)
    slot_gather_kernel(const __grid_constant__ GatherArgs a) {
  const int e = blockIdx.x;
  const long long j = blockIdx.y;
  const long long i = a.idx[j];
  const long long r = i < a.n - 1 ? i : a.n - 1;
  if (e == 0 && threadIdx.x == 0) {
    a.keep[j] = i < a.n && (a.escape || a.mode[r * a.mode_pitch] != kModeCS);
  }
  const long long rb = a.rb[e];
  unsigned char* dst = a.dst[e] + j * rb;
  const unsigned char* src = a.src[e] + (a.pitch[e] ? r * a.pitch[e] : r * rb);
  if (!a.pitch[e] && aligned16(src, dst, rb)) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long v = threadIdx.x; v < rb / 16; v += kGatherThreads) {
      d4[v] = s4[v];
    }
  } else {
    for (long long b = threadIdx.x; b < rb; b += kGatherThreads) {
      dst[b] = src[b];
    }
  }
}
"""


def _const(name, a, b):
    return [(f"constexpr int {name} = {a};", f"constexpr int {name} = {b};")]


def variants(source):
    """name -> text substitutions of the shipped ``source``."""
    i = source.index(KERNEL)
    kernel = source[i:source.index("\n}\n", i) + 3]
    return {
        "count": [(SEARCH, COUNT)],
        "span2": _const("kGatherSpan", 1, 2),
        "span4": _const("kGatherSpan", 1, 4),
        "threads128": _const("kGatherThreads", 256, 128),
        "no_grid_constant": [("slot_gather_kernel(const __grid_constant__ "
                              "GatherArgs a)", "slot_gather_kernel("
                              "const GatherArgs a)")],
        "leaf_a_cta": [(kernel, LEAF_A_CTA),
                       ("slot_gather_kernel<<<dim3(x, a.slots)",
                        "slot_gather_kernel<<<dim3(a.leaves, a.slots)")],
    }


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_gather_variants: no CUDA device", file=sys.stderr)
        return 1
    from bench import build_pool
    from chip_smoke import (H, LOSS_STREAMS, N_STREAMS, POOL, SCHED_EB,
                            SCHED_ESCAPES, W, bucket_workloads, graph_ms,
                            smi)
    from headtrackr_tpu_torch.kernels import schedule
    from torch_bucket_times import digest
    from torch_histpdf_variants import build_variants

    print(smi(), flush=True)
    dev = torch.device("cuda", 0)
    from headtrackr_tpu_torch.kernels.build import CSRC
    subs = variants((CSRC / "schedule.cu").read_text())
    fns = build_variants("schedule", subs,
                         os.path.join(ROOT, "build", "gather_variants"))
    shipped = schedule.launch

    def use(name):
        """Point slot_gather's wrapper at the variant ``name`` (None: the
        shipped library)."""
        if name is None:
            schedule.launch = shipped
            return
        f = fns[name]["slot_gather_launch"]

        def launch(key, fn_name, *args):
            err = f(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"slot_gather {name}: cudaError {err}")
        schedule.launch = launch

    pool = build_pool(N_STREAMS, H, W, POOL, LOSS_STREAMS,
                      np.random.default_rng(0))
    calls, state, idx = bucket_workloads(pool, dev)
    del pool
    frames = calls["frame_prep"][1][0]
    n = state.mode.shape[0]
    eidx = torch.full((SCHED_EB,), n, dtype=torch.int64)
    eidx[:SCHED_ESCAPES[1]] = torch.arange(n - SCHED_ESCAPES[1], n)
    eidx = eidx.to(dev)
    cases = {"relock": lambda: schedule.slot_gather(state, idx),
             "escape": lambda: schedule.slot_gather(state, eidx, True,
                                                    (frames,))}
    arms = [None] + list(subs)
    res = {"card": smi()}
    for cname, fn in cases.items():
        want = digest(fn())
        for name in arms[1:]:
            use(name)
            if digest(fn()) != want:
                raise AssertionError(f"{cname} {name}: outputs differ from "
                                     f"the shipped kernel's")
        t = {name or "shipped": [] for name in arms}
        for name in (arms + arms[::-1]) * TURNS:
            use(name)
            t[name or "shipped"].append(graph_ms(fn))
        use(None)
        res[cname] = t
        print(f"{cname}: {t}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
