"""Variants of ``scan_step``'s whole mode (csrc/schedule.cu) timed against
``copy_`` of the same tick's frames on the card:

    python3 tools/torch_copy_variants.py

Each variant is the source with text substitutions, built with the
package's nvcc flags (tools/torch_histpdf_variants.py build_variants):

  shipped   a one-pass grid, one 16-byte vector a thread, streaming loads
            and stores (__ldcs, __stcs)
  v2, v4    2 and 4 vectors a thread, each loaded before any is stored
  plain     one vector, plain loads and stores
  v4plain   4 vectors, plain loads and stores (the design before the
            in-place read, which lost to copy_ by 0.7-1.0%)
  t512v2    2 vectors at 512 threads a CTA
  stride    the CTAs striding over the copy, four vectors a thread a
            step (copy_bytes), on a grid of 8 CTAs an SM

At 256 and 10,240 streams of 240x320 (59 MB and 2.36 GB a tick), graph
replay ms of ``copy_`` and each variant in turns (REPS rounds), all into
one destination buffer (a copy's rate depended on where its destination
lay), each checked bit-equal to the tick's frames.  Prints the card's name and power limit,
one line a size, then one JSON line.  Needs a CUDA card.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 240, 320
NS = (256, 10240)
REPS = 4
_V = "constexpr int kTileVectors = 1;"
_T = "constexpr int kCopyThreads = 256;"
_PLAIN = [("if (i < nv) v[j] = __ldcs(s + i);", "if (i < nv) v[j] = s[i];"),
          ("if (i < nv) __stcs(d + i, v[j]);", "if (i < nv) d[i] = v[j];")]
VARIANTS = {
    "shipped": [],
    "v2": [(_V, "constexpr int kTileVectors = 2;")],
    "v4": [(_V, "constexpr int kTileVectors = 4;")],
    "plain": _PLAIN,
    "v4plain": [(_V, "constexpr int kTileVectors = 4;")] + _PLAIN,
    "t512v2": [(_T, "constexpr int kCopyThreads = 512;"),
               (_V, "constexpr int kTileVectors = 2;")],
    "stride": [("  if (src == dst) return;\n  if (aligned16(dst, src, bytes)) {",
                "  if (src == dst) return;\n  if (false) {"),
               ("c > (1 << 30) ? (1 << 30) : static_cast<int>(c);",
                "c > 8 * 132 ? 8 * 132 : static_cast<int>(c);")],
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_copy_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from chip_smoke import graph_ms, smi
    from headtrackr_tpu_torch.kernels import schedule as S
    from torch_histpdf_variants import build_variants

    print(smi(), flush=True)
    dev = torch.device("cuda", 0)
    fns = build_variants("schedule", VARIANTS,
                         os.path.join(ROOT, "build", "copy_variants"))
    out = {}
    for n in NS:
        seq = torch.randint(0, 256, (2, n, H, W, 3), dtype=torch.uint8,
                            device=dev)
        frames = torch.empty_like(seq[0])
        p = torch.zeros(S.PARAM_WORDS, dtype=torch.int64)
        p[S.P_FRAME_AT] = seq[1].data_ptr()
        p = p.to(dev)

        def step(name):
            err = fns[name]["scan_step_launch"](
                p.data_ptr(), frames.data_ptr(), frames.numel(), None, 0, n,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        def copy():
            frames.copy_(seq[1])

        times = {name: [] for name in ["copy_"] + list(VARIANTS)}
        for _ in range(REPS):
            times["copy_"].append(graph_ms(copy))
            for name in VARIANTS:
                frames.zero_()
                step(name)
                torch.cuda.synchronize()
                if not torch.equal(frames, seq[1]):
                    raise AssertionError(f"{name} differs from copy_ at "
                                         f"N={n}")
                times[name].append(graph_ms(lambda name=name: step(name)))
        out[str(n)] = times
        print(f"{n} streams: " + "; ".join(
            f"{k} {[round(x, 5) for x in v]}" for k, v in times.items()),
            flush=True)
        del seq, frames
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
