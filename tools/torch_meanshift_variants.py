#!/usr/bin/env python3
"""Which ``meanshift`` kernel each shape wants, how many threads a CTA, and
where a stream's time goes: variants of headtrackr_tpu_torch/csrc/
meanshift.cu timed on one NVIDIA GPU.

    python3 tools/torch_meanshift_variants.py

Each variant is the shipped source with text substitutions, built by nvcc
with the package's flags into build/meanshift_variants/ and loaded with
ctypes (tools/torch_histpdf_variants.py build_variants).  Held to the twin
(ops/meanshift.py mean_shift_plain on the card, tolerance 0) on every
workload with every kernel it takes:
  shipped        the kernels as they are (256 threads a CTA);
  threads512     512 threads a CTA;
  dsmem_columns  the cluster design the port started from: each CTA's
                 column sums read the pdf rows its peers hold through
                 distributed shared memory, then a cluster barrier, then the
                 row sums (the shipped kernel copies its column strip from
                 global memory and runs both at once);
  c10_3cta       clusters of any size up to 16, unpadded column strips and
                 at most 85 registers a thread, timed over the frames at
                 c = 10: one column segment a CTA, three CTAs an SM.
Probes of where a stream's time goes compute something else and are timed
only:
  iters1      one mean-shift iteration instead of up to 10;
  no_moments  the second moments' per-segment sums skipped;
  bare        both;
  stamps      clock64() at the phase boundaries, taken by thread 0 of one
              CTA (each CTA of stream 0's cluster in turn, one launch each,
              the workload's first stream alone): the load, the prefix sums
              (with the chunk sums and exactness of thread 0's line, and
              its lanes a line), each iteration, the second moments' two
              phases and the last barrier.
The launcher's c: 1 one CTA a stream with its planes in shared memory, 2,
4, 8 and 16 a cluster of that many CTAs, 0 the global-scratch kernel
(timed everywhere as the baseline).  Workloads, as chip_smoke.py phase 3
makes them from the bench pool (face_noise 0, the batch after the model's):
the 240x320 frame pdfs through backproject, the face boxes as windows, at
N = 256, 32 and 1; 128 of them upsampled 2x by nearest neighbour to
480x640; the headline's 96x128 band and DEFAULT_BAND (128x192) through
histpdf_band at N = 256 and 1.  Timed by CUDA-graph replay
(chip_smoke.graph_ms), in turns (forward, then backward): the shipped
source with each kernel, then every variant and probe with the kernel
kernels/meanshift.py route picks (c10_3cta with c = 10).  Prints one JSON
line.  Needs a card; exits 1 without one.  Imports nothing of JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 256, 240, 320
BIG = 128  # streams of the 480x640 workload

# the cluster kernel's loads and prefix sums as shipped, and as the design
# this port started from had them (its row segments' addresses kept over
# seg64, unused until the second moments)
SHIPPED_PREFIX = """  // ---- this CTA's pdf rows into R, its columns of every row into C -------
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  // this CTA has started; its peers store into it from the first iteration
  sm90::cluster_arrive();
  const int ncol = xhi - xlo, nrow = yhi - ylo;
  const ScanSplit sp(ncol, bh, nrow, bw);
  if (kTma) {
    if (nrow > 0 && warp == 0) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(bar,
                                    static_cast<uint32_t>(nrow * bw * 4));
      }
      __syncwarp();
      for (int y = ylo + lane; y < yhi; y += 32) {
        sm90::bulk_load(Rs + (y - ylo) * L.rs, p + y * bw,
                        static_cast<uint32_t>(bw * 4), bar);
      }
    }
    // the column strip by 16-byte copies of the column warps (of all warps
    // where the scans take more than one round), who wait for them alone
    const bool split = sp.one_round();
    const int copiers = split ? 32 * sp.warps_c : kThreads;
    const int q = ncol / 4;  // 16-byte pieces of a row's strip
    for (int i = tid; tid < copiers && i < bh * q; i += copiers) {
      const int y = i / q, k = 4 * (i % q);
      sm90::cp_async16(Cs + y * L.cs + k, p + y * bw + xlo + k);
    }
    if (!split) {
      sm90::cp_async_wait_all();
      if (nrow > 0) sm90::mbar_wait(bar, 0);
      __syncthreads();
    } else if (warp < sp.warps_c) {
      sm90::cp_async_wait_all();
      sm90::named_sync(1, copiers);
    } else if (nrow > 0 && warp < sp.warps_c + sp.warps_r) {
      sm90::mbar_wait(bar, 0);
    }
  } else {
    for (int i = tid; i < nrow * bw; i += kThreads) {
      Rs[(i / bw) * L.rs + i % bw] = p[ylo * bw + i];
    }
    for (int i = tid; i < bh * ncol; i += kThreads) {
      const int y = i / ncol, k = i % ncol;
      Cs[y * L.cs + k] = p[y * bw + xlo + k];
    }
    __syncthreads();
  }

  // ---- C and R: the column sums in place in C, the row sums in R, at once
  scan_planes(sp, Cs, ncol, bh, L.cs, Rs, nrow, bw, L.rs);
"""
DSMEM_PREFIX = """  // ---- this CTA's pdf rows, into R ----------------------------------------
  if (kTma) {
    if (tid == 0) {
      sm90::mbar_init(bar, 1);
      sm90::mbar_init_fence();
    }
    __syncthreads();
    if (yhi > ylo) {
      if (warp == 0) {
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(
              bar, static_cast<uint32_t>((yhi - ylo) * bw * 4));
        }
        __syncwarp();
        for (int y = ylo + lane; y < yhi; y += 32) {
          sm90::bulk_load(Rs + (y - ylo) * L.rs, p + y * bw,
                          static_cast<uint32_t>(bw * 4), bar);
        }
      }
      sm90::mbar_wait(bar, 0);
    }
  } else {
    for (int i = tid; i < (yhi - ylo) * bw; i += kThreads) {
      Rs[(i / bw) * L.rs + i % bw] = p[ylo * bw + i];
    }
  }
  // the row segments' addresses in their owners, over seg64 (unused yet)
  auto* segrow = reinterpret_cast<const float**>(seg64);
  for (int s = tid; s < sy; s += kThreads) {  // row segment s's owner
    int k = 0;
    while (strip_lo(sy, nc, k + 1) <= s) ++k;
    segrow[s] = sm90::map_peer(
        Rs + 32 * (s - strip_lo(sy, nc, k)) * L.rs, static_cast<uint32_t>(k));
  }
  sm90::cluster_sync();  // every CTA has started and holds its rows

  // ---- C: this CTA's columns down all the rows, read from their owners ----
  for (int x = xlo + tid; x < xhi; x += kThreads) {
    float* col = Cs + (x - xlo);
    double acc = 0.0;
    float cur[kRun], nxt[kRun];
    auto fetch = [&](float (&v)[kRun], int y0) {  // rows y0.. of a segment
      const float* b = segrow[y0 >> 5] + (y0 & 31) * L.rs + x;
#pragma unroll
      for (int j = 0; j < kRun; ++j) v[j] = y0 + j < bh ? b[j * L.rs] : 0.f;
    };
    fetch(cur, 0);
    for (int y0 = 0; y0 < bh; y0 += kRun) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) nxt[j] = 0.f;
      if (y0 + kRun < bh) fetch(nxt, y0 + kRun);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (y0 + j < bh) {
          acc = __dadd_rn(acc, cur[j]);
          col[(y0 + j) * L.cs] = __double2float_rn(acc);
        }
        cur[j] = nxt[j];
      }
    }
  }
  sm90::cluster_sync();  // every peer has read this CTA's pdf rows

  // ---- R: this CTA's rows, in place ---------------------------------------
  for (int j = tid; j < yhi - ylo; j += kThreads) {
    scan_serial(Rs + j * L.rs, bw, 1);
  }
"""
ITERS1 = ("constexpr int kIters = 10;", "constexpr int kIters = 1;")
NO_MOMENTS = ("t < 3 * nwin * nsw; t += blockDim.x) {",
              "t < 0; t += blockDim.x) {")
VARIANTS = {
    "shipped": [],
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;")],
    "dsmem_columns": [
        (SHIPPED_PREFIX, DSMEM_PREFIX),
        ("  sm90::cluster_wait();  // every peer has started\n", "")],
    "c10_3cta": [
        ("(c <= kMaxCluster && c > 1 && (c & (c - 1)) == 0)",
         "(c <= kMaxCluster && c > 1)"),
        ("    cs = cols + 4;\n", "    cs = cols;\n"),
        ("__global__ void __launch_bounds__(kThreads)\n    "
         "meanshift_cluster_kernel",
         "__global__ void __launch_bounds__(kThreads, 3)\n    "
         "meanshift_cluster_kernel")],
    "iters1": [ITERS1],
    "no_moments": [NO_MOMENTS],
    "bare": [ITERS1, NO_MOMENTS],
}
FRAME_C = {"c10_3cta": 10}  # variants timed over the frames only, at this c
PROBES = ("iters1", "no_moments", "bare", "stamps")

STAMP_AT = [  # (text, stamp slot): the stamp goes before the text
    ("\n\n  // ---- this CTA's pdf rows into R, its columns of every row "
     "into C", 0),
    ("  // ---- C and R: the column sums in place in C, the row sums in R, at "
     "once\n", 1),
    ("  for (int it = 0;; ++it) {\n    const int x0 = bc[0], y0 = bc[1], x1 = "
     "bc[2], y1 = bc[3];\n    const int par", 3),
    ("    // this CTA's segments that meet the window, a warp each, into "
     "every\n", "8 + it"),
    ("  second_rows(p, bw, L.pw, 32 * s0,", 4),
    ("  double* lead64 = sm90::map_peer(seg64, 0u);", 5),
    ("  if (rank == 0 && warp == 0) {\n    const bool hy", 6),
    ("  // ---- the prefix-sum planes ------------------------------"
     "----------------\n", 20),
    ("  const Planes<kShared> pl{C, R, bh, bw, L.rs};\n", 23),
    ("  second_rows(p, bw, L.pw, 0, L.ph,", 24),
    ("  block_segments(L.ph, red64, [&](int y) { return rows[y]; });\n", 25),
]
STAMP_HEAD = ("namespace {\n\nconstexpr int kThreads = 256;",
              "__device__ long long g_stamp[32];\n"
              "__device__ int g_stamp_cta;\n"
              "#define STAMPV(k, v) if (blockIdx.x == g_stamp_cta && "
              "threadIdx.x == 0) g_stamp[k] = (v)\n"
              "#define STAMP(k) STAMPV(k, clock64())\n"
              "namespace {\n\nconstexpr int kThreads = 256;")
LAUNCHER_DOC = ("// pdf (n, bh, bw) f32, window (n, 4) i32 [x, y, w, h], "
                "ry / rx (n,) i32\n")
STAMP_READ = (LAUNCHER_DOC,
              "extern \"C\" int meanshift_stamp_cta(int cta) {\n"
              "  return static_cast<int>(cudaMemcpyToSymbol(g_stamp_cta, "
              "&cta, sizeof(int)));\n}\n\n"
              "extern \"C\" int meanshift_stamps(long long* out) {\n"
              "  static const long long zero[32] = {};\n"
              "  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamp, "
              "sizeof(zero));\n"
              "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamp, zero, "
              "sizeof(zero));\n"
              "  return static_cast<int>(e);\n}\n\n"
              + LAUNCHER_DOC)


def _stamped(text, slot):
    """The substitution that puts stamp `slot` before `text`."""
    lead = len(text) - len(text.lstrip("\n"))
    indent = "    " if slot == "8 + it" else "  "
    return (text, text[:lead] + f"{indent}STAMP({slot});\n" + text[lead:])


STAMP_VALUES = (15, 16, 17)  # exact (1) or not (2), W, the binades' span
STAMP_INNER = [  # the scans' and the second moments' phases, thread 0's
    ("  if (!bad && (emax == 0 || emax - emin <= 29 - log2n)) {",
     "  STAMP(13);\n  STAMPV(15, !bad && (emax == 0 || emax - emin <= 29 - "
     "log2n) ? 1 : 2);\n  STAMPV(16, W);\n  STAMPV(17, emax - emin);\n"
     "  if (!bad && (emax == 0 || emax - emin <= 29 - log2n)) {"),
    ("  } else if (live && w == 0) {\n    scan_serial(line, n, es);\n  }\n}",
     "  } else if (live && w == 0) {\n    scan_serial(line, n, es);\n  }\n"
     "  STAMP(14);\n}"),
    ("  __syncthreads();\n  for (int t = threadIdx.x; t < 3 * nrows; t += "
     "blockDim.x) {",
     "  __syncthreads();\n  STAMP(18);\n  for (int t = threadIdx.x; t < 3 * "
     "nrows; t += blockDim.x) {"),
    ("    out[m * stride + j] = sum;\n  }\n}",
     "    out[m * stride + j] = sum;\n  }\n  STAMP(19);\n}"),
]
VARIANTS["stamps"] = ([STAMP_HEAD, STAMP_READ] +
                      [_stamped(t, k) for t, k in STAMP_AT] + STAMP_INNER)


def workloads(dev):
    """name -> (pdf, window, ry, rx, frame shape) on the card."""
    import numpy as np
    import torch
    from bench import build_pool
    from chip_smoke import face_boxes
    from headtrackr_tpu_torch.kernels import histpdf as K
    from headtrackr_tpu_torch.models import camshift as cs
    from headtrackr_tpu_torch.ops import histogram as hg
    pool = build_pool(N, H, W, 2, 0, np.random.default_rng(0), face_noise=0)
    boxes = torch.as_tensor(face_boxes(pool[0])).to(dev)
    model = K.histpdf_band(torch.as_tensor(pool[0]).to(dev), boxes)
    fr = torch.as_tensor(pool[1]).to(dev)
    w = hg.backprojection_weights(
        model, K.hist4096(fr, hg.full_rects(N, (H, W), dev)))
    pdf = K.backproject(fr, w)
    big = pdf[:BIG].repeat_interleave(2, 1).repeat_interleave(2, 2)
    work = {
        "frame n256": (pdf, boxes, None, None, (H, W)),
        "frame n1": (pdf[:1].contiguous(), boxes[:1].contiguous(), None,
                     None, (H, W)),
        **{f"frame n{n}": (pdf[:n].contiguous(), boxes[:n].contiguous(),
                           None, None, (H, W)) for n in (32, 64, 128, 192)},
        **{f"480x640 n{n}": (big[:n].contiguous(), 2 * boxes[:n], None, None,
                             (2 * H, 2 * W)) for n in (8, 16, 32, 64, BIG)},
    }
    for band in ((96, 128), cs.DEFAULT_BAND):
        ry, rx, _, _ = cs.band_rect(boxes, band, (H, W))  # the twin's
        _, bpdf = K.histpdf_band(fr, boxes, model, band)  # placed bands
        work[f"band {band[0]}x{band[1]} n256"] = (bpdf, boxes, ry, rx,
                                                  (H, W))
        work[f"band {band[0]}x{band[1]} n1"] = (
            bpdf[:1].contiguous(), boxes[:1].contiguous(),
            ry[:1].contiguous(), rx[:1].contiguous(), (H, W))
    return work


def takes(name, wname, kernels):
    """The kernels (launcher's c) variant `name` runs on workload
    `wname`, given those the shipped source runs there."""
    if name in FRAME_C:
        return [FRAME_C[name]] if wname.startswith("frame") else []
    return kernels


def stamps(call, work, kernels, name, so):
    """{workload, kernel and CTA: {slot: cycles since slot 0 (20 in the
    one-CTA kernel)}} of one launch of the stamps probe on the workload's
    first stream, each CTA of its cluster in turn."""
    import ctypes
    import torch
    lib = ctypes.CDLL(so)
    read, pick = lib.meanshift_stamps, lib.meanshift_stamp_cta
    read.argtypes, pick.argtypes = (ctypes.c_void_p,), (ctypes.c_int,)
    buf = (ctypes.c_longlong * 32)()
    out = {}
    for wname, args in work.items():
        one = tuple(a[:1].contiguous() if torch.is_tensor(a) else a
                    for a in args)
        for c in kernels[wname]:
            for cta in range(max(c, 1) if c else 0):
                if pick(cta) or read(ctypes.addressof(buf)):  # zeroes them
                    raise RuntimeError("stamps: set-up failed")
                call(name, c, *one)
                torch.cuda.synchronize()
                if read(ctypes.addressof(buf)):
                    raise RuntimeError("stamps: read failed")
                t0 = buf[20] if c == 1 else buf[0]
                out[f"{wname} c={c} cta={cta}"] = {
                    k: buf[k] - (0 if k in STAMP_VALUES else t0)
                    for k in range(32) if buf[k]}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_meanshift_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import graph_ms, smi
    from torch_histpdf_variants import build_variants
    from headtrackr_tpu_torch.kernels import meanshift as kms
    from headtrackr_tpu_torch.ops.meanshift import MOMENTS, mean_shift_plain

    dev = torch.device("cuda", 0)
    fns = build_variants("meanshift", VARIANTS, os.path.join(
        ROOT, "build", "meanshift_variants"))
    work = workloads(dev)
    card = kms.card(dev)
    scratch = torch.empty((max(
        p.shape[0] * kms.scratch_floats(*p.shape[1:]) for p, *_ in
        work.values()),), dtype=torch.float32, device=dev)
    outs = {}

    def call(name, c, pdf, win, ry, rx, frame):
        n, bh, bw = pdf.shape
        if n not in outs:
            outs[n] = (torch.empty((n, 4), dtype=torch.int32, device=dev),
                       torch.empty((n, len(MOMENTS)), dtype=torch.float32,
                                   device=dev),
                       torch.empty((n, 2), dtype=torch.bool, device=dev))
        win_o, mom, flags = outs[n]
        # the kernel places a band from win (ry, rx: the twin's origins)
        err = fns[name]["meanshift_launch"](
            pdf.data_ptr(), win.data_ptr(),
            win_o.data_ptr(), mom.data_ptr(), flags.data_ptr(),
            scratch.data_ptr(), n, bh, bw, *frame, c,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} c={c}: cudaError {err}")
        return win_o, mom, flags

    def bits(t):
        return torch.where(torch.isnan(t), 0, t.view(torch.int32))

    kernels = {}
    for wname, args in work.items():
        _, bh, bw = args[0].shape
        kernels[wname] = [c for c in (kms.ONE_CTA,) + kms.CLUSTER_SIZES
                          if kms.smem_bytes(bh, bw, c) <= card.smem_cta]
        kernels[wname].append(kms.SCRATCH)
        w, m, z, e = mean_shift_plain(*args)
        want = (w, torch.stack([m[k] for k in MOMENTS], 1),
                torch.stack([z, e], 1))
        for name in [k for k in fns if k not in PROBES]:
            for c in takes(name, wname, kernels[wname]):
                got = call(name, c, *args)
                torch.cuda.synchronize()
                if not all(torch.equal(bits(a) if a.is_floating_point()
                                       else a, bits(b) if b.is_floating_point()
                                       else b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name}: {wname} differs at c={c}")
    res = {"card": smi(), "kernels": kernels,
           "route": {w: kms.route(a[0].shape[0], *a[0].shape[1:], card)
                     for w, a in work.items()}}
    for wname, args in work.items():
        order = kernels[wname] + kernels[wname][::-1]
        t = {c: [] for c in kernels[wname]}
        for c in order:
            t[c].append(graph_ms(lambda c=c: call("shipped", c, *args)))
        res[f"{wname} by kernel"] = t
        c0 = res["route"][wname]
        names = [k for k in fns if takes(k, wname, [c0])]
        t = {k: [] for k in names}
        for name in names + names[::-1]:
            c = takes(name, wname, [c0])[0]
            t[name].append(graph_ms(lambda name=name, c=c: call(
                name, c, *args)))
        res[f"{wname} by variant"] = t
    res["stamps"] = stamps(call, work, kernels, "stamps", os.path.join(
        ROOT, "build", "meanshift_variants", "stamps", "meanshift.so"))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
