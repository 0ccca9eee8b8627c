"""Variants of the ``tick_epilogue`` kernel (csrc/epilogue.cu) timed on the
card: each a text substitution of the shipped source, built with the
package's nvcc flags (tools/torch_histpdf_variants.py ``build_variants``)
and launched through the package's wrapper (its ``launch`` pointed at the
variant's library), on tools/torch_epilogue_cases.py's inputs under the
headline's configuration (bandHist), the fused "track" form, at 256 and
10,240 streams:

  shipped     the source as it is;
  stage_only  the staging alone (the kernel returns after it);
  no_stage    the computation alone (no copies: each input's place is set,
              its bytes are whatever shared memory holds);
  bulk        each segment one TMA bulk copy (``cp.async.bulk``) issued by
              lane 0 of its warp, completing on an mbarrier, in place of
              16-byte ``cp.async`` copies spread over the warp's lanes;
  stage_loop  a warp's turns over its inputs not unrolled (their
              parameters' loads one after the other);
  warps1 / warps4  one or four warps a CTA stage (the shipped kernel: 8);
  streams64   64 streams a CTA (its first two warps compute);
  noop        the kernel returning at once (its launch, parameters and
              shared memory);
  stamps      shipped with clock64 stamps of CTA 0's first thread: clocks
              from the start to its inputs in, and from there to its
              outputs written.
The ptxas resource lines of each variant's kernel are printed too.

Every variant but stage_only and no_stage must equal the shipped kernel's
results bit for bit.  Each is timed by graph replay (chip_smoke.graph_ms),
variants in turns (forward, then backward), beside the empty kernel at
the shipped grid.  Prints the card's name and power limit, then one JSON
line.  Needs a card; exits 1 without one.  Imports nothing of JAX.

    python3 tools/torch_epilogue_variants.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

NS = (256, 10240)
_STAGE_START = "// Copy the rows of streams [i0, i0 + m) of every input"
_STAGE_END = "// stream i0 + j's staged inputs"
BULK_STAGE = r'''// Copy the rows of streams [i0, i0 + m) of every input into its slot:
// a segment one TMA bulk copy by lane 0 of its warp, on an mbarrier.
__device__ __forceinline__ void stage(const Args& a, uint8_t* sm, Meta* meta,
                                      long long i0, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar, blockDim.x);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  uint32_t bytes = 0;
#pragma unroll 1
  for (int q = warp; q < kInputs; q += kWarps) {
    const uint8_t* p = static_cast<const uint8_t*>(a.in[q].p);
    if (p == nullptr) continue;
    const long long s = a.in[q].s;
    const int e = elem_bytes(q), k = columns(q);
    const long long pitch = s * e;
    uint8_t* slot = sm + q * kSlot;
    if (pitch < 0 || pitch > kMaxPitch) {
      stage_words(p, s, e, k, slot, i0, m, lane);
      if (lane == 0) {
        meta[q] = {q * kSlot, 4 * k,
                   static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3),
                   static_cast<int>(s & 3)};
      }
      continue;
    }
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    const int n16 = static_cast<int>(
        (head + (m - 1) * pitch + k * e + 15) & ~15ll);
    if (lane == 0) {
      bytes += n16;
      sm90::bulk_load(slot, p - head + i0 * pitch, n16, &bar);
      meta[q] = {q * kSlot + head, static_cast<int>(pitch), 0, 0};
    }
  }
  sm90::mbar_arrive_expect_tx(&bar, bytes);
  sm90::cp_async_wait_all();
  sm90::mbar_wait(&bar, 0);
  __syncthreads();
}

'''
STAGE_CALL = ("  stage(a, staged, meta, i0, m);  // every load, before any "
              "branch on a value\n")
GUARD = "  if (i >= n) return;\n"


STAMP = ("  if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[{k}] = "
         "clock64();\n")


def stamped(src):
    """src with clock64 stamps of CTA 0's thread 0: [0] the kernel's start,
    [1] its inputs in (after the staging's barrier, or the first use of a
    loaded value), [2] its outputs written; read by epilogue_stamps."""
    first = "  const bool is_cs = entry == kModeCs;\n"
    out = src.replace("  const long long i0 = static_cast<long long>(blockIdx.x)"
                      " * kStreams;\n", STAMP.format(k=0) + "  const long long "
                      "i0 = static_cast<long long>(blockIdx.x) * kStreams;\n",
                      1)
    out = out.replace(first, first + STAMP.format(k=1), 1)
    out = out.replace("    O.b8(oEsc)[i] = esc && is_cs;\n  }\n}\n",
                      "    O.b8(oEsc)[i] = esc && is_cs;\n  }\n" +
                      STAMP.format(k=2) + "}\n", 1)
    out = out.replace("}  // namespace", "}  // namespace\n\nextern \"C\" "
                      "int epilogue_stamps(long long* out) {\n  return "
                      "static_cast<int>(cudaMemcpyFromSymbol(out, g_stamp, "
                      "sizeof(g_stamp)));\n}", 1)
    out = out.replace("namespace {\n", "namespace {\n\n__device__ long long "
                      "g_stamp[4];\n", 1)
    if out.count("g_stamp") != 6:
        raise RuntimeError("stamps: a substitution did not apply")
    return out


def variants(src):
    """name -> the variant's source text."""
    a, b = src.index(_STAGE_START), src.index(_STAGE_END)
    out = {"shipped": src,
           "stage_only": src.replace(
               GUARD, "  if (i >= n || flags != 0xFFFFFFFFu) return;\n", 1),
           "no_stage": src.replace(
               "      sm90::cp_async16(slot + o, src + o);\n",
               "      (void)src;\n", 1),
           "bulk": src[:a] + BULK_STAGE + src[b:],
           "stage_loop": src.replace(
               "#pragma unroll\n  for (int r = 0; r < kPerWarp; ++r) {",
               "#pragma unroll 1\n  for (int r = 0; r < kPerWarp; ++r) {",
               1),
           "warps1": src.replace("constexpr int kWarps = 8;",
                                 "constexpr int kWarps = 1;", 1),
           "warps4": src.replace("constexpr int kWarps = 8;",
                                 "constexpr int kWarps = 4;", 1),
           "streams64": src.replace("constexpr int kStreams = 32;",
                                    "constexpr int kStreams = 64;", 1)}
    out["noop"] = src.replace(STAGE_CALL, "  if (flags != 0xFFFFFFFFu) "
                              "return;\n" + STAGE_CALL, 1)
    out["stamps"] = stamped(src)
    for name, text in out.items():
        if name != "shipped" and text == src:
            raise RuntimeError(f"{name}: no substitution applied")
    return out


def build(out):
    """Build every variant with nvcc, all at once: name -> the
    ``tick_epilogue_launch`` of its library."""
    import ctypes
    import subprocess
    from headtrackr_tpu_torch.kernels import build as B
    src = (B.CSRC / "epilogue.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "epilogue.cu"), "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o",
             os.path.join(d, "epilogue.so"), os.path.join(d, "epilogue.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, stamps, usage = {}, {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, name, "epilogue.so"))
        f = lib.tick_epilogue_launch
        f.argtypes = B._SIGNATURES["epilogue"]["tick_epilogue_launch"]
        f.restype = ctypes.c_int
        fns[name] = f
        if "stamps" in name:
            stamps[name] = lib.epilogue_stamps
            stamps[name].argtypes = (ctypes.c_void_p,)
            stamps[name].restype = ctypes.c_int
        # ptxas's resource lines of the kernel
        lines = log.splitlines()
        usage[name] = [ln.strip() for k, ln in enumerate(lines)
                       if "tick_epilogue" in "".join(lines[max(0, k - 2):k])
                       and ("registers" in ln or "stack" in ln)]
    return fns, stamps, usage


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_epilogue_variants: no CUDA device", file=sys.stderr)
        return 1
    import torch_epilogue_cases as cases
    from chip_smoke import epilogue_floor, graph_ms, smi
    from headtrackr_tpu_torch import TrackerConfig
    from headtrackr_tpu_torch.kernels import epilogue as K
    from headtrackr_tpu_torch.ops import epilogue as P

    print(smi(), flush=True)
    dev = torch.device("cuda", 0)
    fns, stamps, usage = build(os.path.join(ROOT, "build",
                                            "epilogue_variants"))
    current = ["shipped"]

    def launch(key, name, addr, n, flags):
        err = fns[current[0]](addr, n, flags,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{current[0]}: cudaError {err}")

    K.launch = launch
    ep = P.epilogue_config(TrackerConfig(bandHist=True), (240, 320))
    res = {"card": smi(), "ptxas": usage}
    for n in NS:
        inp = cases.inputs(n, dev)
        args = (inp.state, inp.win, inp.moments, inp.zero_mass, inp.escaped,
                inp.state.cs.band_dirty, ep)
        want = None
        for name in fns:
            print(f"checking {name} at N={n}", file=sys.stderr, flush=True)
            current[0] = name
            got = K.track(*args)
            torch.cuda.synchronize()
            flat = (cases._leaves(got[0]) + [v for _, v in
                                             sorted(got[1].items())])
            if want is None:
                want = flat
            elif name not in ("stage_only", "no_stage", "noop") and not all(
                    cases.same_bits(x, y) for x, y in zip(flat, want)):
                raise AssertionError(f"{name} differs from shipped at {n}")
        t = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            current[0] = name
            t[name].append(graph_ms(lambda: K.track(*args)))
        t["empty"] = [graph_ms(lambda: epilogue_floor(n))]
        for name, read in stamps.items():  # CTA 0's phases, in clocks
            import ctypes
            buf = (ctypes.c_longlong * 4)()
            current[0] = name
            K.track(*args)
            torch.cuda.synchronize()
            if read(ctypes.addressof(buf)):
                raise RuntimeError(f"{name}: reading the stamps failed")
            t[name + " clocks"] = [buf[1] - buf[0], buf[2] - buf[1]]
        res[f"n{n}"] = t
        print(f"n={n}: {t}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
