"""Variants of the relock tick's bucket kernels ``frame_prep``
(csrc/frameprep.cu) and ``handoff`` (csrc/handoff.cu) timed on the card,
on chip_smoke.py ``bucket_workloads``' calls (the relock tick's 8 slots,
the cold start's 256 streams):

  split P     the shipped kernels with their split forced to P CTAs a
              stream (1, 2, 4, 8, 16; the launchers pick 16 at 8 slots and
              1 at 256 streams);
  and text substitutions of the shipped sources, each built with the
  package's nvcc flags (tools/torch_histpdf_variants.py
  ``build_variants``) and launched through the package's wrappers (their
  ``launch`` pointed at the variant's library), at the launchers' split:
  unroll2 / unroll8   frame_prep keeping 2 or 8 units in flight a thread
                      (shipped: 4);
  threads512          512 threads a CTA (shipped: 256), either kernel;
  unroll1 / unroll4   handoff's audit keeping 1 or 4 units in flight a
                      thread (shipped: 2);
  no_poll             handoff's audit without the early exit (every CTA
                      scans its whole share);
  late_rows           frame_prep reading its state rows in its tail
                      (shipped: copied by cp.async at its start);
  dependent_header    handoff's header loading the detection after its
                      found flag (shipped: every load at once);
  early_audit_loads   handoff's audit loading its first step (a thread's
                      units, held in a struct) before the rect is counted
                      (shipped: after the mask is built);
  l2_prefetch         handoff prefetching its audit rows into L2 while the
                      rect is counted;
  min_px_512 / min_px_1024  handoff counting its rect on one CTA a 512 or
                      1,024 pixels (shipped: 3,072, the cluster
                      histogram's).

Every variant must equal the shipped kernel's outputs bit for bit.  Each
is timed by graph replay (chip_smoke.graph_ms), in turns (forward, then
backward).  Prints the card's name and power limit, then one JSON line.
Needs a card; exits 1 without one.  Imports nothing of JAX.

    python3 tools/torch_bucket_variants.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SPLITS = (1, 2, 4, 8, 16)
THREADS = ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")
# frame_prep reading its state rows in its tail (no cp.async at its start)
EARLY_ROWS = """  if (rank == 0 && threadIdx.x == 0) {
    // the stream's state rows, copied while the frame is read
    sm90::cp_async4(&rows_in[0], a.mode + s);
    sm90::cp_async4(&rows_in[1], a.wb_n + s);
    for (int i = 0; i < kRing; ++i) {
      sm90::cp_async4(&ring_in[i], a.ring + s * kRing + i);
    }
  }
"""
ROWS_IN = """  sm90::cp_async_wait_all();
  const int32_t mode = rows_in[0], n_in = rows_in[1];
"""
ROWS_LATE = """  const int32_t mode = a.mode[s], n_in = a.wb_n[s];
"""
# handoff's header loading the detection after its found flag
HEADER = """      const float c = plane_f(a.conf, s);
      const float raw[4] = {plane_f(a.x, s), plane_f(a.y, s),
                            plane_f(a.bw, s), plane_f(a.bh, s)};
      const bool vj = a.entry_mode[s] == kModeVJ;
      const float conf = found ? c : kNoConf;
      const float box[4] = {found ? raw[0] : 0.0f, found ? raw[1] : 0.0f,
                            found ? raw[2] : 0.0f, found ? raw[3] : 0.0f};"""
HEADER_DEPENDENT = """      const float conf = found ? plane_f(a.conf, s) : kNoConf;
      const float box[4] = {found ? plane_f(a.x, s) : 0.0f,
                            found ? plane_f(a.y, s) : 0.0f,
                            found ? plane_f(a.bw, s) : 0.0f,
                            found ? plane_f(a.bh, s) : 0.0f};
      const bool vj = a.entry_mode[s] == kModeVJ;"""
# handoff's audit loading its first step before the rect is counted (a
# thread's units held in a struct across the histogram): its functions,
# the load after the rect's share, its loop
EARLY_STEP = r"""// This CTA's share of the audit: rows [y0, y0 + total / per_row) of the
// frame f (h x w) outside the band [bx0, bx1) x [by0, by1), in 16-pixel
// units, a row per_row of them (vec: three 16-byte loads each) or
// ceil(w / 16) (byte loads).
struct Audit {
  const uint8_t* f;
  int w, y0, per_row, total;
  int bx0, bx1, by0, by1;
  bool vec;
};

__device__ __forceinline__ Audit audit_share(const uint8_t* f, int h, int w,
                                             const band::Rect& b,
                                             uint32_t rank, uint32_t split,
                                             bool vec) {
  const int y0 = static_cast<int>(rank) * h / static_cast<int>(split);
  const int y1 = (static_cast<int>(rank) + 1) * h / static_cast<int>(split);
  const int per_row = vec ? w / 16 : (w + 15) / 16;
  return {f, w, y0, per_row, (y1 - y0) * per_row,
          static_cast<int>(b.x0), static_cast<int>(b.x0 + b.rw),
          static_cast<int>(b.y0), static_cast<int>(b.y0 + b.rh), vec};
}

// A thread's step of the audit: kUnroll units, loaded.
struct Step {
  int xs[kUnroll];        // each unit's first column (w: none)
  bool in_rows[kUnroll];  // its row crosses the band
  uint4 v[kUnroll][3];    // vec: its 48 bytes
  int bins[kUnroll][16];  // else: its bins (-1 past the row)
};

// Load the units q0, q0 + kThreads, ... of the share; a unit wholly
// inside the band is skipped unread.
__device__ __forceinline__ void load_step(const Audit& au, int q0, Step& st) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int q = q0 + j * kThreads;
    st.xs[j] = au.w;
    if (q >= au.total) continue;
    const int y = au.y0 + q / au.per_row;
    const int x = 16 * (q - (q / au.per_row) * au.per_row);
    st.in_rows[j] = y >= au.by0 && y < au.by1;
    if (st.in_rows[j] && x >= au.bx0 && x + 16 <= au.bx1) continue;
    st.xs[j] = x;
    const uint8_t* p = au.f + (static_cast<long long>(y) * au.w + x) * 3;
    if (au.vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      st.v[j][0] = __ldg(p4);
      st.v[j][1] = __ldg(p4 + 1);
      st.v[j][2] = __ldg(p4 + 2);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        st.bins[j][k] = x + k < au.w ? chist::rgb_bin(p + 3 * k) : -1;
      }
    }
  }
}

// True where a pixel of the step outside the band has a bin set in mask.
__device__ __forceinline__ bool test_step(const Audit& au, Step& st,
                                          const uint32_t* mask) {
  bool hit = false;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (st.xs[j] >= au.w) continue;
    if (au.vec) chist::decode16(st.v[j][0], st.v[j][1], st.v[j][2],
                                st.bins[j]);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int x = st.xs[j] + k;
      const int bin = st.bins[j][k];
      const bool outside = !st.in_rows[j] || x < au.bx0 || x >= au.bx1;
      hit |= outside && bin >= 0 && ((mask[bin >> 5] >> (bin & 31)) & 1u);
    }
  }
  return hit;
}

"""
EARLY_LOAD = r"""  // the audit's first step loads while the rect is counted (an empty
  // rect's mask is empty: nothing to audit)
  const bool audit = a.dirty && rc.rw * rc.rh > 0;
  Audit au;
  Step st;
  if (audit) {
    au = audit_share(f, h, w,
                     band::place_band(rect, h, w, a.band_h, a.band_w), rank,
                     split, reinterpret_cast<uintptr_t>(a.frames) % 16 == 0 &&
                                w % 16 == 0);
    load_step(au, t, st);
  }
"""
EARLY_LOOP = r"""  // the audit: a model-colored pixel outside the band placed for the rect,
  // step by step until this CTA or a peer finds one
  if (audit) {
    volatile int* seen = at_rank(&flag, 0, split);
    for (int q0 = t;;) {
      if (test_step(au, st, mask)) {
        *seen = 1;
        break;
      }
      q0 += kUnroll * kThreads;
      if (q0 >= au.total || *seen) break;
      load_step(au, q0, st);
    }
  }
"""
# handoff's audit rows touched into L2 while the rect is counted
L2_PREFETCH = """  if (a.dirty) {
    const long long y0 = rank * h / split, y1 = (rank + 1) * h / split;
    const char* p0 = reinterpret_cast<const char*>(f + y0 * w * 3);
    for (long long o = 128 * t; o < (y1 - y0) * w * 3; o += 128 * kThreads) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p0 + o));
    }
  }
"""
SHARE = "  const chist::Share sh = chist::cta_share(rc, split, rank);\n"
MARKS = {"scan": ("// The audit of this CTA's rows [y0, y1)",
                  "// grid (S P), clusters of P CTAs along x"),
         "audit": ("  // the audit: a model-colored pixel outside the band",
                   "  // every CTA's finding is in rank 0's flag\n")}


def _between(text, mark):
    a, b = MARKS[mark]
    i = text.index(a)
    return text[i:text.index(b, i)]


def _unroll(a, b):
    return [(f"constexpr int kUnroll = {a};", f"constexpr int kUnroll = {b};")]


def variants(sources):
    """stem -> name -> text substitutions of the shipped sources
    (``sources``: stem -> text)."""
    ho = sources["handoff"]
    return {
        "frameprep": {
            "unroll2": _unroll(4, 2), "unroll8": _unroll(4, 8),
            "threads512": [THREADS],
            "late_rows": [(EARLY_ROWS, ""), (ROWS_IN, ROWS_LATE),
                          ("  const float* old = ring_in;",
                           "  const float* old = a.ring + s * kRing;")]},
        "handoff": {
            "unroll1": _unroll(2, 1), "unroll4": _unroll(2, 4),
            "threads512": [THREADS],
            "no_poll": [("    if (*seen) return;\n", "")],
            "dependent_header": [(HEADER, HEADER_DEPENDENT)],
            "early_audit_loads": [(_between(ho, "scan"), EARLY_STEP),
                                  (SHARE, SHARE + EARLY_LOAD),
                                  (_between(ho, "audit"), EARLY_LOOP)],
            "l2_prefetch": [(SHARE, SHARE + L2_PREFETCH)],
            "min_px_512": [("constexpr int kMinCtaPx = 3072;",
                            "constexpr int kMinCtaPx = 512;")],
            "min_px_1024": [("constexpr int kMinCtaPx = 3072;",
                             "constexpr int kMinCtaPx = 1024;")]},
    }


KERNEL = {"frameprep": "frame_prep", "handoff": "handoff"}


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_bucket_variants: no CUDA device", file=sys.stderr)
        return 1
    from bench import build_pool
    from chip_smoke import (H, LOSS_STREAMS, N_STREAMS, POOL, W,
                            bucket_workloads, graph_ms, smi)
    from headtrackr_tpu_torch.kernels import frameprep, handoff
    from torch_bucket_times import digest
    from torch_histpdf_variants import build_variants

    print(smi(), flush=True)
    dev = torch.device("cuda", 0)
    from headtrackr_tpu_torch.kernels.build import CSRC
    out = os.path.join(ROOT, "build", "bucket_variants")
    subs = variants({stem: (CSRC / f"{stem}.cu").read_text()
                     for stem in KERNEL})
    fns = {stem: build_variants(stem, v, os.path.join(out, stem))
           for stem, v in subs.items()}
    mods = {"frameprep": frameprep, "handoff": handoff}
    shipped = {stem: m.launch for stem, m in mods.items()}

    def use(stem, name):
        """Point the wrapper of ``stem`` at the variant ``name`` (None:
        the shipped library)."""
        if name is None:
            mods[stem].launch = shipped[stem]
            return
        f = fns[stem][name][f"{KERNEL[stem]}_launch"]

        def launch(key, fn_name, *args):
            err = f(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{stem} {name}: cudaError {err}")
        mods[stem].launch = launch

    pool = build_pool(N_STREAMS, H, W, POOL, LOSS_STREAMS,
                      np.random.default_rng(0))
    calls, _, _ = bucket_workloads(pool, dev)
    del pool
    wrapper = {"frame_prep": frameprep.frame_prep,
               "handoff": handoff.handoff}
    stem_of = {v: k for k, v in KERNEL.items()}
    res = {"card": smi()}
    for cname, (key, a, kw, n) in calls.items():
        stem = stem_of[key]
        f = wrapper[key]
        want = digest(f(*a, **kw))
        arms = {f"split {p}": (None, p) for p in SPLITS}
        arms.update({name: (name, None) for name in subs[stem]})
        for arm, (name, p) in arms.items():
            use(stem, name)
            got = digest(f(*a, **kw, split=p))
            if got != want:
                raise AssertionError(f"{cname} {arm}: outputs differ from "
                                     f"the shipped kernel's")
        t = {arm: [] for arm in arms}
        for arm in list(arms) + list(arms)[::-1]:
            name, p = arms[arm]
            use(stem, name)
            t[arm].append(graph_ms(lambda: f(*a, **kw, split=p)))
        use(stem, None)
        res[cname] = t
        print(f"{cname}: {t}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
