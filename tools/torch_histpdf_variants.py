#!/usr/bin/env python3
"""How the port's cluster histogram (``hist4096``, ``histpdf_band``) adds its
runs, and how many CTAs a stream it wants: variants of
headtrackr_tpu_torch/csrc/histpdf.cu timed on one NVIDIA GPU.

    python3 tools/torch_histpdf_variants.py

Each variant is the shipped source with text substitutions (in histpdf.cu
or in the header it shares with histbins.cu, cluster_hist.cuh), built by
nvcc with the package's flags into build/histpdf_variants/ and loaded with
ctypes.  The counting orders swap the body of ``count16``:
  runs            the shipped source: a thread's runs of equal bins,
                  carried across its chunks, one shared atomic a run;
  runs_match      runs within a chunk, then a warp match (__match_any_sync)
                  of the run heads, one lane adding each bin's sum;
  match           a warp match of every pixel, no runs (the first design's).
and three more change the structure:
  threads512      512 threads a CTA instead of 256;
  prefetch_model  each CTA asks L2 for its slice of the model at its start;
  no_stash        the pdf mode keeps no bins: pass 2 bins the band again.
Every variant must equal the plain histogram and the plain band pdf
(tolerance 0), the band at every cluster size.  Each is timed by
CUDA-graph replay (chip_smoke.graph_ms), variants in turns (forward, then
backward), at 256 streams x 240x320: the counting orders on every workload
(hist4096 on the bench pool, face_noise 0 and 20, on uniform random bins
and at one stream; histpdf_band over the 96x128 band of the bench pool,
placed by the kernel around windows of the band's size at x on the
8-pixel grid and from -20 on (the twin at ``band_rect``'s rects), and
over the frame of uniform random bins,
X7's workload; the hist-only mode on 256 random boxes of at most
120x120), the structural ones on hist4096's bench pool and the bands.
Then the shipped source at every cluster size C (the launch takes it) on
every workload.  Prints one JSON line.  Needs a card; exits 1 without
one.  Imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 256, 240, 320
BAND = (96, 128)
RUNS = """#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (b[j] >= 0) run.add(b[j], hist);
  }
"""
RUNS_MATCH = """  const int lane = threadIdx.x & 31;
  int key[16], len[16];
  int c = 0;
#pragma unroll
  for (int j = 15; j >= 0; --j) {
    c = (j < 15 && b[j] == b[j + 1]) ? c + 1 : 1;
    const bool head = b[j] >= 0 && (j == 0 || b[j - 1] != b[j]);
    key[j] = head ? b[j] : -1;
    len[j] = head ? c : 0;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (__any_sync(0xffffffffu, key[j] >= 0)) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[j]);
      const unsigned sum = __reduce_add_sync(peers, len[j]);
      if (key[j] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&hist[key[j]], static_cast<int>(sum));
      }
    }
  }
"""
MATCH = """  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, b[j]);
    if (b[j] >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[b[j]], __popc(peers));
    }
  }
"""
SHARE = "  const Share sh = cta_share(rc, c, static_cast<int>(rank));\n"
PREFETCH = SHARE + """  if constexpr (kPdf) {
    const float* mp = model + static_cast<int64_t>(n) * kBins +
                      static_cast<int>(rank) * (kBins / c);
    for (int i = threadIdx.x; i < kBins / c / 4; i += blockDim.x) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(mp + 4 * i));
    }
  }
"""
# name -> text substitutions of the shipped source
VARIANTS = {
    "runs": [],
    "runs_match": [(RUNS, RUNS_MATCH)],
    "match": [(RUNS, MATCH)],
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;")],
    "prefetch_model": [(SHARE, PREFETCH)],
    "no_stash": [("constexpr int kMaxStashBytes = 96 * 1024;",
                  "constexpr int kMaxStashBytes = 0;")],
}
COUNTING = ("runs", "runs_match", "match")  # timed on every workload
SIZES = (1, 2, 4, 8, 16)


def build_variants(stem, variants, out):
    """Build each variant of csrc/<stem>.cu (name -> text substitutions,
    each found exactly once in the source or in the cluster histogram's
    header, cluster_hist.cuh) with nvcc and the package's flags, all at
    once, into out/<name>/; returns name -> {launcher: ctypes function}.
    The variant's header copy sits beside its source, so it is the one its
    quoted include finds."""
    from headtrackr_tpu_torch.kernels import build as B
    files = (f"{stem}.cu", "cluster_hist.cuh")
    srcs = {f: (B.CSRC / f).read_text() for f in files}
    procs = {}
    for name, subs in variants.items():
        text = dict(srcs)
        for a, b in subs:
            hits = [f for f in files if a in text[f]]
            if len(hits) != 1 or text[hits[0]].count(a) != 1:
                raise RuntimeError(f"{name}: {a!r} is not once in {files}")
            text[hits[0]] = text[hits[0]].replace(a, b)
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f, t in text.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(t)
        procs[name] = subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o",
             os.path.join(d, f"{stem}.so"), os.path.join(d, f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, name, f"{stem}.so"))
        fns[name] = {}
        for fn, argtypes in B._SIGNATURES[stem].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            fns[name][fn] = f
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_histpdf_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from bench import build_pool
    from chip_smoke import bin_frames, graph_ms, smi
    from headtrackr_tpu_torch.kernels.histpdf import cluster_split
    from headtrackr_tpu_torch.kernels.launch import sm_count
    from headtrackr_tpu_torch.models import camshift as cs
    from headtrackr_tpu_torch.ops import histogram as hg

    dev = torch.device("cuda", 0)
    sms = sm_count(dev)
    fns = build_variants("histpdf", VARIANTS, os.path.join(
        ROOT, "build", "histpdf_variants"))
    g = torch.Generator().manual_seed(47)
    frames = {f"bench{k}": torch.as_tensor(build_pool(
        N, H, W, 2, 0, np.random.default_rng(0), face_noise=k)[1]).to(dev)
        for k in (0, 20)}
    frames["random_bins"] = bin_frames(torch.randint(
        0, 4096, (N, H, W), generator=g)).to(dev)
    full = hg.full_rects(N, (H, W), dev)
    x = torch.randint(0, (W - BAND[1]) // 8 + 1, (N,), generator=g) * 8
    y = torch.randint(0, H - BAND[0] + 1, (N,), generator=g)
    bands = torch.stack([x, y, torch.full((N,), BAND[1]),
                         torch.full((N,), BAND[0])], 1).int().to(dev)
    # windows from -20 on, their bands placed and clipped into the frame
    loose = bands.clone()
    loose[:, 0] = torch.randint(-20, W - BAND[1] + 20, (N,), generator=g).to(dev)
    boxes = torch.cat([torch.randint(-20, 300, (N, 2), generator=g),
                       torch.randint(0, 120, (N, 2), generator=g)],
                      1).int().to(dev)
    model = torch.randint(1, 200, (N, 4096), generator=g).float().to(dev)
    cur = torch.empty((N, 4096), dtype=torch.float32, device=dev)
    pdfs = {b: torch.empty((N,) + b, dtype=torch.float32, device=dev)
            for b in (BAND, (H, W))}

    def hist(name, fr, c=None, rects=full):
        n = fr.shape[0]
        c = c or cluster_split(n, H, W, sms)
        err = fns[name]["hist4096_launch"](
            fr.data_ptr(), rects.data_ptr(), cur.data_ptr(), n, H, W, c,
            0, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return cur[:n]

    def band(name, fr, rects, b, c=None):
        c = c or cluster_split(N, *b, sms)
        pdf = pdfs[b]
        err = fns[name]["histpdf_band_launch"](
            fr.data_ptr(), rects.data_ptr(), model.data_ptr(), cur.data_ptr(),
            pdf.data_ptr(), N, H, W, *b, c, None, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return cur, pdf

    # workload -> call(variant name, cluster size or None)
    work = {
        "hist4096 bench0": lambda v, c=None: hist(v, frames["bench0"], c),
        "hist4096 bench20": lambda v, c=None: hist(v, frames["bench20"], c),
        "hist4096 random_bins": lambda v, c=None: hist(
            v, frames["random_bins"], c),
        "hist4096 n1": lambda v, c=None: hist(v, frames["bench0"][:1], c),
        "histpdf_band 96x128": lambda v, c=None: band(
            v, frames["bench0"], bands, BAND, c),
        "histpdf_band 96x128 loose": lambda v, c=None: band(
            v, frames["bench0"], loose, BAND, c),
        "histpdf_band x7": lambda v, c=None: band(
            v, frames["random_bins"], full, (H, W), c),
        "histpdf_band_hist boxes": lambda v, c=None: hist(
            v, frames["bench0"], c, boxes),
    }
    for name in fns:
        for fr in frames.values():
            for n in (N, 1):
                got = hist(name, fr[:n]).clone()
                torch.cuda.synchronize()
                if not torch.equal(got, hg.hist4096_plain(
                        fr[:n], full[:n]).float()):
                    raise AssertionError(f"{name}: hist4096 differs")
        for fr, rects, b in ((frames["bench0"], bands, BAND),
                             (frames["bench0"], loose, BAND),
                             (frames["random_bins"], full, (H, W))):
            for c in SIZES:
                got = [t.clone() for t in band(name, fr, rects, b, c)]
                want = hg.histpdf_band_plain(
                    fr, cs.band_rects(*cs.band_rect(rects, b, (H, W))),
                    model, b)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"{name}: histpdf_band differs "
                                         f"at C={c}")
    res = {"card": smi(), "streams": N, "frame": [H, W], "band": list(BAND),
           "cluster_split": {"frame": cluster_split(N, H, W, sms),
                             "frame n1": cluster_split(1, H, W, sms),
                             "band": cluster_split(N, *BAND, sms)}}
    for wname, call in work.items():
        names = [k for k in fns if k in COUNTING or wname.startswith(
            ("histpdf_band ", "hist4096 bench0"))]
        t = {k: [] for k in names}
        for name in names + names[::-1]:
            t[name].append(graph_ms(lambda name=name: call(name)))
        res[wname] = t
    for wname, call in work.items():
        order = list(SIZES) + list(SIZES)[::-1]
        t = {c: [] for c in SIZES}
        for c in order:
            t[c].append(graph_ms(lambda c=c: call("runs", c)))
        res[f"{wname} by C"] = t
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
