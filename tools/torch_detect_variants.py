"""The detector's pyramid and cascade kernels on the card, taken apart.

  python3 tools/torch_detect_variants.py

Bench-pool frames (320x240 at N = 1, 8 and 256; 640x480, the pool's
frames upsampled 2x, at N = 8 and 16), the real cascade:
  - pyramid at every cluster size (kernels/pyramid.py SPLITS, with
    ``split`` patched) by CUDA-graph replay, beside the size ``split``
    picks;
  - cascade by CUDA-graph replay, its device time by kernel (the survivor
    count's memset, cascade_dense, cascade_deep, cascade_compact) under
    torch.profiler over 20 calls, and the dense stages' survivors (the
    deep kernel's work list);
  - variants, each a copy of csrc/cascade.cu or csrc/pyramid.cu with text
    substitutions (VARIANTS), built into build/detect_variants/ with the
    package's nvcc flags, all at once, and swapped in for the shipped
    library: cascade_dense reading the planes through L1/L2 where the
    shipped kernel stages its tile's plane rows in shared memory, timed
    against the shipped one twice in turn (shipped, variant, variant,
    shipped; dense device ms and the cascade's graph ms); and
    probes whose outputs are wrong on purpose (only their time is read):
    cascade_dense with no stage evaluated, pyramid building only each
    chain's first level, pyramid with every source byte load replaced by
    a constant.  cascade_dense by torch.profiler (device ms a call),
    pyramid by CUDA-graph replay.
Prints the card's name and power limit first and one JSON line last.
Needs a card and nvcc.
"""

import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPS = 20
AB = "dense_unstaged"  # the variant timed against the shipped cascade
VARIANTS = {
    "cascade": {
        # the dense kernel reading the planes through L1/L2 (no staging)
        "dense_unstaged": [
            ("      at[z] = t + static_cast<int>(reinterpret_cast<uintptr_t>"
             "(src) & 15);\n      if (len > 0) {",
             "      at[z] = static_cast<int>(src - p);\n      if (false) {"),
            ("const int v = tile[a0 + (d1 & e.x) + (d2 & e.y) + e.z];",
             "const int v = __ldg(p + a0 + (d1 & e.x) + (d2 & e.y) + e.z);"),
            ("const int smem = kSlotBytes + tile_bytes;",
             "const int smem = kSlotBytes;")],
        "dense_no_stages": [(
            "    sum = stage_sum(s, a0, d1, d2);\n        if (sum <",
            "    sum = 0.0;\n        if (true || sum <")],
    },
    "pyramid": {
        "first_level_only": [(
            "for (int k = first; k < end; ++k) {",
            "for (int k = first; k < min(end, first + 1); ++k) {")],
        "no_loads": [
            ("return static_cast<float>(__ldg(p));", "return 1.0f;"),
            ("return static_cast<float>(__ldcg(p));", "return 1.0f;"),
            ("return static_cast<float>(*p);", "return 1.0f;")],
    },
}


def graph_ms(fn):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def kernel_ms(fn):
    """Device ms a call by kernel name (torch.profiler, REPS calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key
            for k in ("cascade_dense", "cascade_deep", "cascade_compact",
                      "emset", "Memset"):
                if k in name:
                    name = "memset" if "emset" in k else k
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / REPS
    return out


def build_all():
    """Each variant's shared library, nvcc with the package's flags, all
    started together; returns {(stem, name): path}."""
    from headtrackr_tpu_torch.kernels import build as B
    out = ROOT / "build" / "detect_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, variants in VARIANTS.items():
        for name, subs in variants.items():
            src = (B.CSRC / f"{stem}.cu").read_text()
            for old, new in subs:
                if src.count(old) != 1:
                    raise RuntimeError(f"{stem} {name}: {old[:50]!r} is not "
                                       f"once in {stem}.cu")
                src = src.replace(old, new)
            cu = out / f"{stem}_{name}.cu"
            cu.write_text(src)
            so = cu.with_suffix(".so")
            procs[(stem, name)] = (so, subprocess.Popen(
                [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = so
    return libs


def use(shipped, stem, so):
    """Swap ``stem``'s library for ``so`` (None: the shipped one)."""
    from headtrackr_tpu_torch.kernels import build as B
    libs = {p.name.split("-")[0]: ctypes.CDLL(str(p)) for p in shipped.paths}
    if so is not None:
        libs[stem] = ctypes.CDLL(str(so))
    swapped = B.Library(libs, shipped.paths, "")
    B.load_library = lambda: swapped


def main():
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from bench import build_pool
    from headtrackr_tpu_torch.cascade import frontalface
    from headtrackr_tpu_torch.kernels import build as B
    from headtrackr_tpu_torch.kernels import pyramid as kp
    from headtrackr_tpu_torch.kernels.cascade import cascade
    from headtrackr_tpu_torch.kernels.launch import sm_count
    from headtrackr_tpu_torch.models import detector as td
    from headtrackr_tpu_torch.ops import detect as od
    from headtrackr_tpu_torch.ops.imageproc import grayscale

    if not torch.cuda.is_available():
        print("torch_detect_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    pool = build_pool(256, 240, 320, 2, 1, np.random.default_rng(0))
    gray = grayscale(torch.as_tensor(pool[1]).to(dev))
    big = gray[:16].repeat_interleave(2, 1).repeat_interleave(2, 2)
    runs = [(f"240x320 N={n}", gray[:n].contiguous()) for n in (1, 8, 256)]
    runs += [(f"480x640 N={n}", big[:n].contiguous()) for n in (8, 16)]
    shipped = B.load_library()
    libs = build_all()
    tabs, bufs, rec = {}, {}, {}
    split = kp.split
    for name, g in runs:
        n, h, w = g.shape
        if (h, w) not in tabs:
            tabs[h, w] = td.detector_tables(w, h, frontalface(), 5, dev)
        tg = tabs[h, w]
        r = {"split": split(n, tg.plan.chains, sm_count(dev))}
        for c in kp.SPLITS:
            kp.split = lambda *a, c=c: c
            r[f"pyramid_ctas{c}_ms"] = graph_ms(lambda: kp.pyramid(g, tg))
        kp.split = split
        bufs[name] = buf = kp.pyramid(g, tg)
        r["cascade_graph_ms"] = graph_ms(lambda: cascade(buf, tg, 256))
        r["cascade_kernels_ms"] = kernel_ms(lambda: cascade(buf, tg, 256))
        dense = od.cascade_plain(buf, dataclasses.replace(
            tg, stages=tg.stages[:2]), 1)
        r["dense_survivors"] = int(dense["valid"].sum()
                                   + dense["overflow"].sum())
        rec[name] = r
        print(name, json.dumps(r), flush=True)

    def timed(stem, so, name, g):
        use(shipped, stem, so)
        tg = tabs[tuple(g.shape[1:])]
        if stem == "cascade":
            buf = bufs[name]
            return {"dense_ms": kernel_ms(lambda: cascade(
                buf, tg, 256)).get("cascade_dense"),
                "graph_ms": graph_ms(lambda: cascade(buf, tg, 256))}
        return {"graph_ms": graph_ms(lambda: kp.pyramid(g, tg))}

    order = [None, AB, AB, None]  # the A/B
    for stem, variants in VARIANTS.items():
        names = order if stem == "cascade" else [None, *variants]
        if stem == "cascade":
            names += ["dense_no_stages"]
        for turn, v in enumerate(names):
            so = None if v is None else libs[(stem, v)]
            label = f"{stem} {v or 'shipped'}" + (
                f" turn {turn}" if stem == "cascade" and turn < 4 else "")
            rec[label] = {name: timed(stem, so, name, g) for name, g in runs}
            print(label, json.dumps(rec[label]), flush=True)
    B.load_library = lambda: shipped
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
