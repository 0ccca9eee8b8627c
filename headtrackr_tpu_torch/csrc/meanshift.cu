// meanshift for Hopper (sm_90a): camshift's whole mean-shift step, one
// launch for every stream of a batch: the marginal prefix sums, up to 10
// iterations with the fixed-point freeze, the second moments of the
// stopping window and the central moments derived from them.
//
// It replaces the JAX package's XLA chain headtrackr_tpu/models/camshift.py
// _mean_shift_core (:265), with _marginal_planes (:168), _select_lines
// (:201), _first_moments_marginal (:223) and _second_moments (:248), and
// with it tools/kernel_experiments.py::ta_call (k8, :397), the lane-gather
// probe whose port (gather.cu, take_along) selected the prefix-sum lines
// twice an iteration.  On the TPU the planes are triangular matmuls and the
// line selections one-hot matmuls, each iteration a chain of small XLA ops.
//   - Semantics: ops/meanshift.py mean_shift_plain, the kernel's twin, in
//     the twin's floating-point order, so the two agree to the bit on every
//     device (the twin's docstring states the order).  Every add, multiply,
//     subtract, divide and conversion is an _rn intrinsic: nothing
//     contracts into a fused multiply-add (F1), and the divisions are IEEE
//     (F6).
//   - Placement: a band pdf's origin in the frame comes from the stream's
//     window, which the walk reads anyway (band.cuh place_band, the twin's
//     models/camshift.py band_rect, in the walk's prologue), so the host
//     passes no origin.  A full-frame pdf (bh, bw) = (H, W) places at (0,
//     0), where no bound can leave the band: the escape test is the band's
//     alone.
//   - Bound: bytes, and far from it.  The function reads the pdf once (48 KB
//     a stream at a 96x128 band, 300 KB over a 240x320 frame) and writes 80
//     bytes; its adds are a few per pixel.  What paces a stream is latency:
//     the prefix sums are running sums, an iteration is reductions and one
//     thread's window arithmetic, and the second moments a few dependent
//     steps a row.  Where many streams run, the shared memory the planes
//     take decides how many run at once.
//   - Order.  Prefix sums: f64 running sums in index order, each stored
//     rounded to f32 (what the CPU's cumsum of f32 gives).  Reductions: the
//     adjacent-pair tree over the length zero-padded to a power of two, in
//     32-element segments: a warp sums a segment by __shfl_down with
//     offsets 1, 2, 4, 8, 16 (lane i adds lane i + offset), or one thread
//     adds the same pairs in registers (PairTree), and the segments' sums
//     are summed the same way, so the result is the twin's whichever warp,
//     thread or CTA sums a segment.  Hence bh, bw <= 1024 (32 segments).  A
//     segment that misses the window sums to +0 and is not computed.  The
//     second moments sum their f32 terms in f64, each row over x, then the
//     rows over y, and round once to f32.
//   - Prefix sums at once (scan_line).  Where every partial sum of a line
//     (a row or column of the pdf) is exact in f64, any order of the adds
//     gives the serial sums.  That holds when the line's values are finite
//     and its nonzero ones span at most 29 - log2(pow2(n)) binades: every
//     partial sum is then an integer multiple of the smallest one's ulp,
//     below 2^53 of them.  The kernel checks it a line (a backprojection's
//     weights, 1/76800 to 1, span 17 binades) and splits such a line into
//     chunks that W lanes sum at once (each lane's chunk sum, the chunks
//     before it by shuffles, then its running sum from there); any other
//     line takes one lane's serial sum.  Nothing is assumed of the input:
//     the twin's bits either way.
//
// Three kernels, by how the planes (C, the inclusive column sums; R, the
// inclusive row sums; bh rows of stride rs = bw + 4 each) fit the card;
// kernels/meanshift.py route picks one from the streams and the shape,
// mirroring the layouts below:
//   - One CTA a stream, planes in its shared memory (meanshift_kernel
//     <true, _>): at 96x128 they take 103 KB, two CTAs an SM; at 128x192
//     200 KB, one.  The pdf arrives twice by TMA bulk copies (one a row,
//     each kind on its own mbarrier), into C's rows and R's, so that the
//     column sums (in place in C) and the row sums (in place in R) start as
//     soon as their rows land and run at once (scan_planes).  An iteration
//     reads each window column's two C entries and each window row's two R
//     entries, reduces m00, m10 and m01 by warp shuffles and one pass
//     through shared memory, and thread 0 computes the next window and
//     broadcasts it.  A stream that reaches its fixed point leaves the loop
//     (frozen iterations are no-ops).
//   - A cluster of c CTAs a stream (meanshift_cluster_kernel, c a power of
//     two <= 16), the planes split over the CTAs' shared memory.  Each
//     side's 32-element segments split evenly in order over the CTAs (CTA
//     k: segments [k S / c, (k + 1) S / c) of the S = ceil(len / 32)), so
//     every strip boundary is a segment boundary.  CTA k loads its row
//     strip's pdf rows (TMA, into R) and its column strip of every row
//     (16-byte asynchronous copies, into C, stride cols + 4), and sums both
//     in place at once; no sum crosses a CTA, so each is the one-CTA
//     kernel's.  (The design this started from read the peers' rows
//     through distributed shared memory for the column sums, then the row
//     sums in turn; tools/torch_meanshift_variants.py times it, PERF.md has
//     the numbers.)  In an iteration each CTA sums
//     its own segments that meet the window (m00 and m10 over its columns,
//     m01 over its rows) and stores each sum into every peer's segment
//     table (double-buffered by the iteration's parity); after one cluster
//     barrier every CTA's thread 0 runs the same window arithmetic on the
//     same sums, so the bounds and the stop need no broadcast between
//     CTAs.  Budget a CTA: the pdf rows of ceil(S_y / c) segments (stride
//     rs) plus a bh x (32 ceil(S_x / c) + 4) column strip, plus 1.6 KB of
//     tables and 24 B a row for the second moments (KB = 1024 bytes): at
//     240x320, 178 KB at c = 4 (one CTA an SM), 107 KB at 8 (two), 77 KB
//     at 16 (two), so a wave holds 33, 33 or 16 streams (49 if the 604 KB
//     of a stream's planes filled every SM's 227 KB): 256 streams take
//     eight waves, a stream's latency each.  At 480x640 only c = 16 fits:
//     210 KB, one CTA an SM, 8 streams a wave.
//   - The planes in a global scratch the caller allocates
//     (meanshift_kernel<false, false>), the row plane transposed so that a
//     thread a row writes coalesced; the one-CTA code reads them.  One CTA
//     a stream and little shared memory, so every stream runs at once:
//     the route takes it where a cluster would need more than 7 waves (256
//     streams of 240x320) and where the planes fit no cluster (sides up to
//     1024).
// The second moments (second_rows) read the pdf again from global memory
// over the stopping window's rows of the CTA: a thread a (row, segment,
// moment) sums a segment into a part array over C (no longer needed), a
// thread a (row, moment) the row's segments; in the cluster each CTA sends
// its row segments' sums to CTA 0, which sums them and writes the outputs
// after a last cluster barrier, which also keeps every CTA's shared memory
// alive until its peers are done with it.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 10;        // src/camshift.js:277
constexpr int kMaxSide = 1024;    // bh, bw: at most 32 segments of 32
constexpr int kMaxCluster = 16;
constexpr int kMoments = 12;
constexpr int kRun = 16;          // values a scan loads before it sums
constexpr float kTiny = 1e-30f;   // the divisor's floor (the reference's)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// The planes' row stride (floats): 16-byte rows for the bulk copies where
// bw allows, else odd (free of bank conflicts).
__host__ __device__ constexpr int row_stride(int bw) {
  return bw % 4 == 0 ? bw + 4 : (bw | 1);
}

// The second moments' per-segment sums of a row: 3 f64 a segment, the
// row's pw / 32 segments (second_rows' part array).
__host__ __device__ constexpr int part_bytes(int rows, int bw) {
  return 3 * 8 * rows * (pow2_at_least(bw) > 32 ? pow2_at_least(bw) / 32 : 1);
}

__host__ __device__ constexpr int max_int(int a, int b) {
  return a > b ? a : b;
}

// The one-CTA kernels' shared memory, in bytes from the dynamic base: two
// mbarriers, the broadcast words, the segment sums (f32 or f64), the second
// moments' f64 row sums, then (in the shared-plane variant) C, which the
// second moments' part array reuses, and R, both of row stride rs.
struct Layout {
  int ph, pw, rs;                  // padded lengths, the row stride (floats)
  int bcast, red, rows, c, r, end;
  __host__ __device__ Layout(int bh, int bw, bool planes) {
    ph = pow2_at_least(bh);
    pw = pow2_at_least(bw);
    rs = row_stride(bw);
    bcast = 16;
    red = bcast + 16 * 4;
    rows = red + 3 * 32 * 8;
    c = rows + round16(3 * ph * 8);
    r = c + (planes ? round16(max_int(bh * rs * 4, part_bytes(bh, bw))) : 0);
    end = r + (planes ? round16(bh * rs * 4) : 0);
  }
};

// Floats of global scratch a stream of the scratch kernel takes: C, the
// transposed R, then the second moments' part array.
__host__ __device__ constexpr int scratch_floats(int bh, int bw) {
  return 2 * bh * bw + part_bytes(bh, bw) / 4;
}

// The cluster kernel's strips: a length's ceil(len / 32) segments split
// evenly in order over the nc CTAs; CTA k owns segments [strip_lo(k),
// strip_lo(k + 1)).
__host__ __device__ constexpr int seg_count(int len) { return (len + 31) / 32; }

__host__ __device__ constexpr int strip_lo(int segs, int nc, int k) {
  return k * segs / nc;
}

// A cluster CTA's shared memory, in bytes from the dynamic base: the
// mbarrier, the broadcast words, the iterations' segment sums (f32, [2
// parities][m00, m10, m01][32]), the second moments' segment sums (f64,
// [3][32], read by CTA 0), the CTA's second-moment row sums (f64,
// [3][rows]), its column strip of C (bh rows of stride cs = cols + 4, which
// spreads a column's chunks over the banks), which the second moments' part
// array reuses, and its pdf rows, scanned into R (rows of stride rs).  rows
// and cols are the most any CTA holds.
struct ClusterLayout {
  int ph, pw, rs, rows, cols, cs;
  int bcast, seg, seg64, rowsum, c, r, end;
  __host__ __device__ ClusterLayout(int bh, int bw, int nc) {
    ph = pow2_at_least(bh);
    pw = pow2_at_least(bw);
    rs = row_stride(bw);
    rows = 32 * ((seg_count(bh) + nc - 1) / nc);
    cols = 32 * ((seg_count(bw) + nc - 1) / nc);
    cs = cols + 4;
    bcast = 16;
    seg = bcast + 16 * 4;
    seg64 = seg + 2 * 3 * 32 * 4;
    rowsum = seg64 + 3 * 32 * 8;
    c = rowsum + round16(3 * rows * 8);
    r = c + round16(max_int(bh * cs * 4, part_bytes(rows, bw)));
    end = r + round16(rows * rs * 4);
  }
};

// Lane 0 gets the tree sum of the first `lanes` lanes' values (`lanes` a
// power of two <= 32, the same in every lane).
template <class T>
__device__ __forceinline__ T warp_tree(T v, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) {
    v = add_rn(v, __shfl_down_sync(kFull, v, off));
  }
  return v;
}

// Does 32-element segment s meet [lo, hi)?
__device__ __forceinline__ bool meets(int s, int lo, int hi) {
  return hi > lo && 32 * s < hi && 32 * s + 32 > lo;
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float infinity() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ int js_shift(float v) {  // JS v >> 0 (F3)
  return isfinite(v) ? static_cast<int>(truncf(v)) : 0;
}

// A stream's walk, carried by thread 0 (of every CTA of a cluster, each on
// the same sums): the window, its previous position, the escape flag and
// the moments of the last live iteration; (ox, oy) the band's origin,
// placed from the window (place_band).  bc[0..3] broadcast the
// iteration's band bounds [x0, y0, x1, y1], bc[4] the stop flag, bc[8..11]
// the stopping iteration's bounds.
struct Walk {
  int wx, wy, ww, wh, prevx, prevy, ox, oy, bh, bw, H, W;
  bool esc;
  float hw, hh;  // the window's half width and height
  float m00, m10, m01;

  __device__ Walk(const int32_t* window, int n, int bh_, int bw_, int H_,
                  int W_) {
    const band::Rect o = band::place_band(window + 4 * static_cast<int64_t>(n),
                                          H_, W_, bh_, bw_);
    ox = static_cast<int>(o.x0);
    oy = static_cast<int>(o.y0);
    wx = prevx = window[4 * n + 0];
    wy = prevy = window[4 * n + 1];
    ww = window[4 * n + 2];
    wh = window[4 * n + 3];
    bh = bh_;
    bw = bw_;
    H = H_;
    W = W_;
    esc = false;
    hw = __fdiv_rn(static_cast<float>(ww), 2.f);
    hh = __fdiv_rn(static_cast<float>(wh), 2.f);
    m00 = m10 = m01 = 0.f;
  }

  // this iteration's band bounds into bc[0..3]
  __device__ void bounds(int* bc) {
    const int lx = max(wx, 0), ly = max(wy, 0);
    int b[4] = {lx - ox, ly - oy, min(lx + ww, W) - ox, min(ly + wh, H) - oy};
    esc |= b[0] < 0 || b[1] < 0 || b[2] > bw || b[3] > bh;
    const int hi[4] = {bw, bh, bw, bh};
#pragma unroll
    for (int k = 0; k < 4; ++k) bc[k] = min(max(b[k], 0), hi[k]);
  }

  // iteration `it`'s sums over the bounds in bc[0..3]: the next window,
  // and the next bounds or the stop
  __device__ void step(float n00, float n10, float n01, int it, int* bc) {
    const int x0 = bc[0], y0 = bc[1], x1 = bc[2], y1 = bc[3];
    if (x1 <= x0 || y1 <= y0) n00 = n10 = n01 = 0.f;  // empty window
    const bool nonzero = n00 > 0.f;
    const float safe = fmaxf(n00, kTiny);
    const float xc = nonzero ? __fdiv_rn(n10, safe) : quiet_nan();
    const float yc = nonzero ? __fdiv_rn(n01, safe) : quiet_nan();
    const int nx = wx + js_shift(__fsub_rn(xc, hw));
    const int ny = wy + js_shift(__fsub_rn(yc, hh));
    const bool fixed = nx == prevx && ny == prevy;
    m00 = n00;
    m10 = n10;
    m01 = n01;
    wx = prevx = nx;
    wy = prevy = ny;
    const bool stop = fixed || it + 1 == kIters;
    if (stop) {  // the stopping iteration's bounds
      bc[8] = x0;
      bc[9] = y0;
      bc[10] = x1;
      bc[11] = y1;
    } else {
      bounds(bc);
    }
    bc[4] = stop;
  }

  // stream n's outputs, given the second moments
  __device__ void write(int n, float m11, float m20, float m02,
                        int32_t* out_win, float* out_mom,
                        uint8_t* out_flags) const {
    const bool nonzero = m00 > 0.f;
    const float inv = nonzero ? __fdiv_rn(1.f, fmaxf(m00, kTiny)) : infinity();
    const float xc = __fmul_rn(m10, inv);
    const float yc = __fmul_rn(m01, inv);
    const float mom[kMoments] = {
        m00, m10, m01, m11, m20, m02, inv, xc, yc,
        __fsub_rn(m20, __fmul_rn(m10, xc)),
        __fsub_rn(m02, __fmul_rn(m01, yc)),
        __fsub_rn(m11, __fmul_rn(m01, xc))};  // JS quirk: m01 * xc
#pragma unroll
    for (int k = 0; k < kMoments; ++k) out_mom[kMoments * n + k] = mom[k];
    out_win[4 * n + 0] = min(max(wx, 0), W);
    out_win[4 * n + 1] = min(max(wy, 0), H);
    out_win[4 * n + 2] = ww;
    out_win[4 * n + 3] = wh;
    out_flags[2 * n + 0] = !nonzero;
    out_flags[2 * n + 1] = esc;
  }
};

// An adjacent-pair tree built leaf by leaf, in f64: pushing leaf k (k = 0,
// 1, ... in order) adds it to the pending sums of the levels where k's
// bits are set, as the tree pairs them, so after leaves [0, 2^l) level l
// holds their tree (warp_tree's value).  The level indices unroll to
// constants, so the levels stay in registers.
struct PairTree {
  double lv[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};

  __device__ __forceinline__ void push(int k, double x) {
    bool open = true;
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      if (open) {
        if ((k >> l) & 1) {
          x = __dadd_rn(lv[l], x);
        } else {
          lv[l] = x;
          open = false;
        }
      }
    }
  }
  // the tree of the first n leaves (n a power of two <= 32)
  __device__ __forceinline__ double total(int n) const {
    double t = lv[0];
#pragma unroll
    for (int l = 1; l < 6; ++l) {
      if ((1 << l) == n) t = lv[l];
    }
    return t;
  }
};

// Row y's second moment m (0: m11, 1: m20, 2: m02) over its 32-element
// segment s (x in [32 s, 32 s + 32)): the f32 terms (x - x0) (y - y0) v,
// (x - x0)^2 v or (y - y0)^2 v, 0 outside the window [x0, x1), summed in
// f64 by the adjacent-pair tree over the segment's first `lanes` =
// min(pw, 32) elements (warp_tree's order), by one thread.  row is the
// pdf's row y in global memory, bw long; vec: its rows are 16-byte aligned
// and bw % 4 == 0, so it loads float4s.
__device__ __forceinline__ double second_segment(const float* row, int bw,
                                                 bool vec, int m, int y,
                                                 int s, int x0, int y0,
                                                 int x1, int lanes) {
  float v[32];  // the segment's pdf values, all loads issued first
  if (vec) {
    const auto* r4 = reinterpret_cast<const float4*>(row + 32 * s);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 f = 32 * s + 4 * q < bw ? __ldg(r4 + q)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int x = 32 * s + k;
      v[k] = x >= x0 && x < x1 ? __ldg(row + x) : 0.f;
    }
  }
  const float vy = static_cast<float>(y - y0);
  PairTree t;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int x = 32 * s + k;
    if (k < lanes) {
      float term = 0.f;
      if (x >= x0 && x < x1) {
        const float vx = static_cast<float>(x - x0);
        // the twin's weight, vx vy, vx vx or vy vy, times the pdf
        term = __fmul_rn(__fmul_rn(m == 2 ? vy : vx, m == 1 ? vx : vy), v[k]);
      }
      t.push(k, term);
    }
  }
  return t.total(lanes);
}

// The second moments' row sums of rows [ylo, ylo + nrows) over the
// stopping window [x0, x1) x [y0, y1), in f64: out[m * stride + j] for
// row ylo + j and moment m (+0 outside the window).  Each row is the tree
// over its pw / 32 segments of the segments' trees, a segment that misses
// the window +0.  A thread a (row, segment, moment) of the window sums a
// segment into part (3 (y1 - y0) pw / 32 doubles at most: part_bytes),
// then a thread a (row, moment) sums the row's segments.  p is the pdf
// (global memory, row stride bw).  Every thread of the block calls it.
__device__ __forceinline__ void second_rows(const float* p, int bw, int pw,
                                            int ylo, int nrows, int x0,
                                            int y0, int x1, int y1,
                                            double* part, double* out,
                                            int stride) {
  const int ns = pw > 32 ? pw / 32 : 1;
  const int lanes = pw < 32 ? pw : 32;
  const bool vec = bw % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int ya = max(y0, ylo), yb = min(y1, ylo + nrows);
  const int sa = x0 / 32, nsw = x1 > x0 ? (x1 - 1) / 32 - sa + 1 : 0;
  const int nwin = max(yb - ya, 0);  // the window's rows here
  for (int t = threadIdx.x; t < 3 * nwin * nsw; t += blockDim.x) {
    const int m = t % 3, j = t / 3 / nsw, s = sa + t / 3 % nsw;
    part[(m * nwin + j) * ns + s] = second_segment(
        p + (ya + j) * bw, bw, vec, m, ya + j, s, x0, y0, x1, lanes);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * nrows; t += blockDim.x) {
    const int m = t % 3, j = t / 3, y = ylo + j;
    double sum = 0.0;
    if (y >= ya && y < yb) {
      const double* q = part + (m * nwin + y - ya) * ns;
      double leaf[32];  // loaded before they are summed
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        leaf[s] = s < ns && s >= sa && s < sa + nsw ? q[s] : 0.0;
      }
      PairTree tree;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        if (s < ns) tree.push(s, leaf[s]);
      }
      sum = tree.total(ns);
    }
    out[m * stride + j] = sum;
  }
}

// A line's running sums in place, in index order: n values at line[i *
// es], each replaced by f32 of the f64 running sum (the twin's prefix
// sums), 16 loaded before they are summed.
__device__ __forceinline__ void scan_serial(float* line, int n, int es) {
  double acc = 0.0;
  for (int i0 = 0; i0 < n; i0 += kRun) {
    float v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      v[j] = i0 + j < n ? line[(i0 + j) * es] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (i0 + j < n) {
        acc = __dadd_rn(acc, v[j]);
        line[(i0 + j) * es] = __double2float_rn(acc);
      }
    }
  }
}

// scan_serial's result by W lanes of a warp at once (W a power of two <=
// 32; a line's lanes are consecutive, lane w taking the values [w k, w k +
// k), k = ceil(n / W)), where it is sure to be the same.  Where every
// partial sum of the line is exact in f64, any order of the adds gives the
// serial sums: the lanes sum their chunks, take the sums of the chunks
// before theirs (shuffles) and run their chunks from there.  Exact: the
// values finite, and the nonzero ones' binades (biased exponents, 1 for a
// subnormal) spanning at most 29 - log2(pow2(n)), so that every partial
// sum is an integer multiple of the smallest one's ulp below 2^53 of them.
// Otherwise the line's lane 0 runs scan_serial.  Every lane of the warp
// calls it; `live` is false where the lane's line does not exist.
__device__ __forceinline__ void scan_line(float* line, int n, int es, int W,
                                          bool live) {
  if (W == 1) {
    if (live) scan_serial(line, n, es);
    return;
  }
  const int w = threadIdx.x & (W - 1);
  const int k = (n + W - 1) / W;
  const int i0 = min(w * k, n), i1 = live ? min(i0 + k, n) : i0;
  int emax = 0, emin = 255, bad = 0;
  auto look = [&](float v) {  // v's binade into the line's span
    const int e = (__float_as_int(v) >> 23) & 0xff;
    if (v != 0.f) {
      emax = max(emax, max(e, 1));
      emin = min(emin, max(e, 1));
    }
    bad |= e == 255;
  };
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;  // the chunk's sum
  int i = i0;
  for (; i + 4 <= i1; i += 4) {
    const float a = line[i * es], b = line[(i + 1) * es],
                c = line[(i + 2) * es], d = line[(i + 3) * es];
    look(a);
    look(b);
    look(c);
    look(d);
    s0 = __dadd_rn(s0, a);
    s1 = __dadd_rn(s1, b);
    s2 = __dadd_rn(s2, c);
    s3 = __dadd_rn(s3, d);
  }
  for (; i < i1; ++i) {
    const float a = line[i * es];
    look(a);
    s0 = __dadd_rn(s0, a);
  }
  double inc = __dadd_rn(__dadd_rn(s0, s1), __dadd_rn(s2, s3));
  for (int off = 1; off < W; off <<= 1) {  // over the line's lanes
    emax = max(emax, __shfl_xor_sync(kFull, emax, off, W));
    emin = min(emin, __shfl_xor_sync(kFull, emin, off, W));
    bad |= __shfl_xor_sync(kFull, bad, off, W);
    const double o = __shfl_up_sync(kFull, inc, off, W);
    if (w >= off) inc = __dadd_rn(inc, o);
  }
  double acc = __shfl_up_sync(kFull, inc, 1, W);  // the chunks before
  if (w == 0) acc = 0.0;
  const int log2n = 31 - __clz(pow2_at_least(n));
  if (!bad && (emax == 0 || emax - emin <= 29 - log2n)) {
    for (int j = i0; j < i1; j += kRun) {  // scan_serial from acc
      float v[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        v[u] = j + u < i1 ? line[(j + u) * es] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (j + u < i1) {
          acc = __dadd_rn(acc, v[u]);
          line[(j + u) * es] = __double2float_rn(acc);
        }
      }
    }
  } else if (live && w == 0) {
    scan_serial(line, n, es);
  }
}

// Lanes a line for scan_line, for a CTA's ncol columns of bh values and
// nrow rows of bw values: starting from one lane a line, the longer chunk
// doubles its lanes while the two kinds still fit the CTA's warps at once.
__device__ __forceinline__ void lanes_per_line(int ncol, int bh, int nrow,
                                               int bw, int& wc, int& wr) {
  auto warps = [](int lines, int w) { return (lines * w + 31) / 32; };
  wc = wr = 1;
  for (;;) {
    const bool rows = (bw + wr - 1) / wr >= (bh + wc - 1) / wc;
    const int nwr = rows ? 2 * wr : wr, nwc = rows ? wc : 2 * wc;
    if ((rows ? wr : wc) == 32 ||
        warps(nrow, nwr) + warps(ncol, nwc) > kWarps) {
      return;
    }
    wr = nwr;
    wc = nwc;
  }
}

// The warps a CTA's scans take: wc lanes a column, wr a row
// (lanes_per_line); the column warps come first.
struct ScanSplit {
  int wc, wr, warps_c, warps_r;
  __device__ ScanSplit(int ncol, int bh, int nrow, int bw) {
    lanes_per_line(ncol, bh, nrow, bw, wc, wr);
    warps_c = (ncol * wc + 31) / 32;
    warps_r = (nrow * wr + 31) / 32;
  }
  // one round: each warp scans one kind of line, so it may start as soon as
  // that kind's values are in
  __device__ bool one_round() const { return warps_c + warps_r <= kWarps; }
};

// The prefix sums of a CTA's ncol columns (bh values a column, stride cs,
// from C) and nrow rows (bw values, stride rs, from R), in place, the
// columns' warps then the rows', all at once.
__device__ __forceinline__ void scan_planes(const ScanSplit& sp, float* C,
                                            int ncol, int bh, int cs,
                                            float* R, int nrow, int bw,
                                            int rs) {
  const int wc = sp.wc, wr = sp.wr, warps_c = sp.warps_c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < warps_c + sp.warps_r; t += kWarps) {
    if (t < warps_c) {
      const int x = (32 * t + lane) / wc;
      scan_line(C + x, bh, cs, wc, x < ncol);
    } else {
      const int y = (32 * (t - warps_c) + lane) / wr;
      scan_line(R + y * rs, bw, 1, wr, y < nrow);
    }
  }
}

// ---- one CTA a stream ------------------------------------------------------

// The planes: C[y][x] = sum of pdf[0..y][x] (inclusive), R the inclusive
// row sums, row-major of stride rs in shared memory or transposed
// (R[x][y]) in the global scratch.  col(k, x) and row(y, k) are the
// exclusive sums (col_cum, row_cum of the twin).
template <bool kShared>
struct Planes {
  const float* C;
  const float* R;
  int bh, bw, rs;
  __device__ __forceinline__ float col(int k, int x) const {
    return k == 0 ? 0.f : C[(k - 1) * (kShared ? rs : bw) + x];
  }
  __device__ __forceinline__ float row(int y, int k) const {
    if (k == 0) return 0.f;
    return kShared ? R[y * rs + k - 1] : R[(k - 1) * bh + y];
  }
};

// A block-wide tree over P elements (P a power of two <= 1024), step one:
// element i lies in segment i / 32, warp w sums segments w, w + kWarps, ...
// by warp_tree, and lane 0 writes segment s's sum to seg[s].  Step two,
// block_total, after a barrier.  Segment by segment, this is the
// adjacent-pair tree over all P elements.
template <class T, class Term>
__device__ __forceinline__ void block_segments(int P, T* seg, Term term) {
  const int lane = threadIdx.x & 31;
  const int lanes = P < 32 ? P : 32;
  for (int s = threadIdx.x >> 5; s * 32 < P; s += kWarps) {
    const int i = s * 32 + lane;
    const T v = warp_tree(i < P ? term(i) : T(0), lanes);
    if (lane == 0) seg[s] = v;
  }
}

// Warp 0: lane 0 gets the tree over block_segments' segment sums.
template <class T>
__device__ __forceinline__ T block_total(const T* seg, int P) {
  const int lane = threadIdx.x & 31;
  const int ns = P > 32 ? P / 32 : 1;
  return warp_tree(lane < ns ? seg[lane] : T(0), ns);
}

template <bool kShared, bool kTma>
__global__ void __launch_bounds__(kThreads)
    meanshift_kernel(const float* __restrict__ pdf,
                     const int32_t* __restrict__ window,
                     int32_t* __restrict__ out_win,
                     float* __restrict__ out_mom,
                     uint8_t* __restrict__ out_flags, float* scratch, int bh,
                     int bw, int H, int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(bh, bw, kShared);
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t npx = static_cast<int64_t>(bh) * bw;
  const float* p = pdf + static_cast<int64_t>(n) * npx;
  auto* bar = reinterpret_cast<uint64_t*>(smem);
  auto* bc = reinterpret_cast<int*>(smem + L.bcast);
  auto* red = reinterpret_cast<float*>(smem + L.red);  // [3][32] segments
  auto* red64 = reinterpret_cast<double*>(smem + L.red);
  auto* rows = reinterpret_cast<double*>(smem + L.rows);  // [3][ph]

  // ---- the prefix-sum planes ----------------------------------------------
  float* C;
  float* R;
  double* part;  // the second moments' per-segment sums, over C once done
  if (kShared) {
    C = reinterpret_cast<float*>(smem + L.c);
    R = reinterpret_cast<float*>(smem + L.r);
    part = reinterpret_cast<double*>(C);
    // the pdf twice, into C's rows and R's, so that the column sums (in
    // place in C) and the row sums (in place in R) run at once, each kind's
    // warps from when its copies land (bar[0]: C's, bar[1]: R's)
    const ScanSplit sp(bw, bh, bh, bw);
    if (kTma) {
      if (tid == 0) {
        sm90::mbar_init(bar, 1);
        sm90::mbar_init(bar + 1, 1);
        sm90::mbar_init_fence();
      }
      __syncthreads();
      if (warp == 0) {
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(bar, static_cast<uint32_t>(npx * 4));
          sm90::mbar_arrive_expect_tx(bar + 1,
                                      static_cast<uint32_t>(npx * 4));
        }
        __syncwarp();
        for (int y = lane; y < bh; y += 32) {
          sm90::bulk_load(C + y * L.rs, p + y * bw,
                          static_cast<uint32_t>(bw * 4), bar);
          sm90::bulk_load(R + y * L.rs, p + y * bw,
                          static_cast<uint32_t>(bw * 4), bar + 1);
        }
      }
      if (!sp.one_round() || warp < sp.warps_c) sm90::mbar_wait(bar, 0);
      if (!sp.one_round() || warp >= sp.warps_c) sm90::mbar_wait(bar + 1, 0);
    } else {
      for (int i = tid; i < npx; i += kThreads) {
        const float v = p[i];
        C[(i / bw) * L.rs + i % bw] = v;
        R[(i / bw) * L.rs + i % bw] = v;
      }
      __syncthreads();
    }
    scan_planes(sp, C, bw, bh, L.rs, R, bh, bw, L.rs);
  } else {
    C = scratch + n * static_cast<int64_t>(scratch_floats(bh, bw));
    R = C + npx;
    part = reinterpret_cast<double*>(R + npx);
    for (int i = tid; i < bw + bh; i += kThreads) {
      double acc = 0.0;
      if (i < bw) {  // column i
        for (int y = 0; y < bh; ++y) {
          acc = __dadd_rn(acc, __ldg(p + y * bw + i));
          C[y * bw + i] = __double2float_rn(acc);
        }
      } else {  // row i - bw, written transposed
        const int y = i - bw;
        for (int x = 0; x < bw; ++x) {
          acc = __dadd_rn(acc, __ldg(p + y * bw + x));
          R[x * bh + y] = __double2float_rn(acc);
        }
      }
    }
  }
  const Planes<kShared> pl{C, R, bh, bw, L.rs};

  // ---- the iterations -----------------------------------------------------
  Walk walk(window, n, bh, bw, H, W);
  if (tid == 0) walk.bounds(bc);
  __syncthreads();
  for (int it = 0;; ++it) {
    const int x0 = bc[0], y0 = bc[1], x1 = bc[2], y1 = bc[3];
    block_segments(L.pw, red, [&](int x) {
      return x >= x0 && x < x1 ? __fsub_rn(pl.col(y1, x), pl.col(y0, x))
                               : 0.f;
    });
    block_segments(L.pw, red + 32, [&](int x) {
      return x >= x0 && x < x1
                 ? __fmul_rn(static_cast<float>(x - x0),
                             __fsub_rn(pl.col(y1, x), pl.col(y0, x)))
                 : 0.f;
    });
    block_segments(L.ph, red + 64, [&](int y) {
      return y >= y0 && y < y1
                 ? __fmul_rn(static_cast<float>(y - y0),
                             __fsub_rn(pl.row(y, x1), pl.row(y, x0)))
                 : 0.f;
    });
    __syncthreads();
    if (warp == 0) {
      const float n00 = block_total(red, L.pw);
      const float n10 = block_total(red + 32, L.pw);
      const float n01 = block_total(red + 64, L.ph);
      if (lane == 0) walk.step(n00, n10, n01, it, bc);
    }
    __syncthreads();
    if (bc[4]) break;
  }

  // ---- second moments over the stopping window ---------------------------
  const int x0 = bc[8], y0 = bc[9], x1 = bc[10], y1 = bc[11];
  second_rows(p, bw, L.pw, 0, L.ph, x0, y0, x1, y1, part, rows, L.ph);
  __syncthreads();
  block_segments(L.ph, red64, [&](int y) { return rows[y]; });
  block_segments(L.ph, red64 + 32, [&](int y) { return rows[L.ph + y]; });
  block_segments(L.ph, red64 + 64,
                 [&](int y) { return rows[2 * L.ph + y]; });
  __syncthreads();
  if (warp == 0) {
    const float m11 = __double2float_rn(block_total(red64, L.ph));
    const float m20 = __double2float_rn(block_total(red64 + 32, L.ph));
    const float m02 = __double2float_rn(block_total(red64 + 64, L.ph));
    if (lane == 0) walk.write(n, m11, m20, m02, out_win, out_mom, out_flags);
  }
}

// ---- a cluster of nc CTAs a stream -----------------------------------------

// Grid nc * n in clusters of nc along x: CTA `rank` of stream blockIdx.x /
// nc.  Every thread of every CTA passes every cluster barrier: the loop's
// stop is computed alike in every CTA from the same sums.
template <bool kTma>
__global__ void __launch_bounds__(kThreads)
    meanshift_cluster_kernel(const float* __restrict__ pdf,
                             const int32_t* __restrict__ window,
                             int32_t* __restrict__ out_win,
                             float* __restrict__ out_mom,
                             uint8_t* __restrict__ out_flags, int bh, int bw,
                             int H, int W, int nc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ClusterLayout L(bh, bw, nc);
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int n = blockIdx.x / nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = pdf + static_cast<int64_t>(n) * bh * bw;
  auto* bar = reinterpret_cast<uint64_t*>(smem);
  auto* bc = reinterpret_cast<int*>(smem + L.bcast);
  auto* seg = reinterpret_cast<float*>(smem + L.seg);        // [2][3][32]
  auto* seg64 = reinterpret_cast<double*>(smem + L.seg64);   // [3][32]
  auto* rowsum = reinterpret_cast<double*>(smem + L.rowsum);  // [3][rows]
  float* Cs = reinterpret_cast<float*>(smem + L.c);  // [bh][cs]
  float* Rs = reinterpret_cast<float*>(smem + L.r);  // [rows][rs]
  const int sy = seg_count(bh), sx = seg_count(bw);
  const int s0 = strip_lo(sy, nc, rank), s1 = strip_lo(sy, nc, rank + 1);
  const int t0 = strip_lo(sx, nc, rank), t1 = strip_lo(sx, nc, rank + 1);
  const int ylo = min(32 * s0, bh), yhi = min(32 * s1, bh);  // own rows
  const int xlo = min(32 * t0, bw), xhi = min(32 * t1, bw);  // own columns

  // ---- this CTA's pdf rows into R, its columns of every row into C -------
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
  auto colv = [&](int k, int x) {  // col_cum[k][x], x in this CTA's strip
    return k == 0 ? 0.f : Cs[(k - 1) * L.cs + x - xlo];
  };
  auto rowv = [&](int y, int k) {  // row_cum[y][k], y in this CTA's strip
    return k == 0 ? 0.f : Rs[(y - ylo) * L.rs + k - 1];
  };

  // ---- the iterations -----------------------------------------------------
  Walk walk(window, n, bh, bw, H, W);
  if (tid == 0) walk.bounds(bc);
  float* peer_seg = sm90::map_peer(seg, static_cast<uint32_t>(
                                            lane < nc ? lane : 0));
  const int lx = L.pw < 32 ? L.pw : 32, ly = L.ph < 32 ? L.ph : 32;
  const int nsx = L.pw > 32 ? L.pw / 32 : 1, nsy = L.ph > 32 ? L.ph / 32 : 1;
  const int nct = t1 - t0, ntask = nct + s1 - s0;
  __syncthreads();
  sm90::cluster_wait();  // every peer has started
  for (int it = 0;; ++it) {
    const int x0 = bc[0], y0 = bc[1], x1 = bc[2], y1 = bc[3];
    const int par = (it & 1) * 96;
    // this CTA's segments that meet the window, a warp each, into every
    // peer's table: m00 and m10 over a column segment, m01 over a row one
    for (int task = warp; task < ntask; task += kWarps) {
      if (task < nct) {
        const int s = t0 + task;
        if (!meets(s, x0, x1)) continue;
        const int x = 32 * s + lane;
        const bool in = x >= x0 && x < x1;
        const float mass = in ? __fsub_rn(colv(y1, x), colv(y0, x)) : 0.f;
        float a = warp_tree(mass, lx);
        float b = warp_tree(
            in ? __fmul_rn(static_cast<float>(x - x0), mass) : 0.f, lx);
        a = __shfl_sync(kFull, a, 0);
        b = __shfl_sync(kFull, b, 0);
        if (lane < nc) {
          peer_seg[par + s] = a;
          peer_seg[par + 32 + s] = b;
        }
      } else {
        const int s = s0 + task - nct;
        if (!meets(s, y0, y1)) continue;
        const int y = 32 * s + lane;
        float a = warp_tree(
            y >= y0 && y < y1
                ? __fmul_rn(static_cast<float>(y - y0),
                            __fsub_rn(rowv(y, x1), rowv(y, x0)))
                : 0.f,
            ly);
        a = __shfl_sync(kFull, a, 0);
        if (lane < nc) peer_seg[par + 64 + s] = a;
      }
    }
    sm90::cluster_sync();
    if (warp == 0) {
      const float* sg = seg + par;
      const bool hx = lane < sx && meets(lane, x0, x1);
      const bool hy = lane < sy && meets(lane, y0, y1);
      const float n00 = warp_tree(lane < nsx && hx ? sg[lane] : 0.f, nsx);
      const float n10 = warp_tree(lane < nsx && hx ? sg[32 + lane] : 0.f, nsx);
      const float n01 = warp_tree(lane < nsy && hy ? sg[64 + lane] : 0.f, nsy);
      if (lane == 0) walk.step(n00, n10, n01, it, bc);
    }
    __syncthreads();
    if (bc[4]) break;
  }

  // ---- second moments over the stopping window ---------------------------
  const int x0 = bc[8], y0 = bc[9], x1 = bc[10], y1 = bc[11];
  second_rows(p, bw, L.pw, 32 * s0, 32 * (s1 - s0), x0, y0, x1, y1,
              reinterpret_cast<double*>(Cs), rowsum, L.rows);
  __syncthreads();
  double* lead64 = sm90::map_peer(seg64, 0u);
  for (int task = warp; task < s1 - s0; task += kWarps) {
    const int s = s0 + task;
    if (!meets(s, y0, y1)) continue;
    const int j = 32 * task + lane;
    const double a = warp_tree(rowsum[j], ly);
    const double b = warp_tree(rowsum[L.rows + j], ly);
    const double c = warp_tree(rowsum[2 * L.rows + j], ly);
    if (lane == 0) {
      lead64[s] = a;
      lead64[32 + s] = b;
      lead64[64 + s] = c;
    }
  }
  // CTA 0 has every segment; no CTA's shared memory is read after this
  sm90::cluster_sync();
  if (rank == 0 && warp == 0) {
    const bool hy = lane < sy && meets(lane, y0, y1);
    const float m11 = __double2float_rn(
        warp_tree(lane < nsy && hy ? seg64[lane] : 0.0, nsy));
    const float m20 = __double2float_rn(
        warp_tree(lane < nsy && hy ? seg64[32 + lane] : 0.0, nsy));
    const float m02 = __double2float_rn(
        warp_tree(lane < nsy && hy ? seg64[64 + lane] : 0.0, nsy));
    if (lane == 0) walk.write(n, m11, m20, m02, out_win, out_mom, out_flags);
  }
}

int max_smem() {
  static int v = -1;
  if (v < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      v = 0;
    }
  }
  return v;
}

bool side_ok(int bh, int bw) {
  return bh >= 1 && bw >= 1 && bh <= kMaxSide && bw <= kMaxSide;
}

// c: 1 the one-CTA kernel with its planes, 0 the scratch kernel, else a
// cluster of c (a power of two <= 16).
bool kernel_ok(int c) {
  return c == 0 || c == 1 ||
         (c <= kMaxCluster && c > 1 && (c & (c - 1)) == 0);
}

// Bytes of dynamic shared memory a CTA of kernel c takes.
int smem_bytes(int bh, int bw, int c) {
  if (c == 0) return Layout(bh, bw, false).end;
  if (c == 1) return Layout(bh, bw, true).end;
  return ClusterLayout(bh, bw, c).end;
}

template <bool kShared, bool kTma>
void launch(int n, int smem, cudaStream_t st, const float* pdf,
            const int32_t* window, int32_t* win, float* mom, uint8_t* flags,
            float* scratch, int bh, int bw, int H, int W) {
  cudaFuncSetAttribute(meanshift_kernel<kShared, kTma>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  meanshift_kernel<kShared, kTma><<<n, kThreads, smem, st>>>(
      pdf, window, win, mom, flags, scratch, bh, bw, H, W);
}

}  // namespace

// Bytes of dynamic shared memory a CTA of kernel c takes at bh x bw (c as
// for meanshift_launch), or -1; kernels/meanshift.py smem_bytes mirrors it.
extern "C" int meanshift_smem_bytes(int bh, int bw, int c) {
  return side_ok(bh, bw) && kernel_ok(c) ? smem_bytes(bh, bw, c) : -1;
}

// This card's shared memory: out = [the most a CTA may take, an SM's, what
// the runtime keeps of it for each CTA], bytes; returns the CUDA error.
extern "C" int meanshift_smem_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attr[3] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  cudaDevAttrReservedSharedMemoryPerBlock};
  for (int k = 0; k < 3 && e == cudaSuccess; ++k) {
    e = cudaDeviceGetAttribute(out + k, attr[k], dev);
  }
  return static_cast<int>(e);
}

// Floats of global scratch a stream needs: 0 where the planes fit in one
// CTA's shared memory or in a cluster of 16 CTAs', else the scratch
// kernel's (C, the transposed R and the second moments' part array).
extern "C" int meanshift_scratch_floats(int bh, int bw) {
  if (!side_ok(bh, bw)) return -1;
  const bool fit = smem_bytes(bh, bw, 1) <= max_smem() ||
                   smem_bytes(bh, bw, kMaxCluster) <= max_smem();
  return fit ? 0 : scratch_floats(bh, bw);
}

// pdf (n, bh, bw) f32 over the band that place_band places around each
// window (n, 4) i32 [x, y, w, h] in an (H, W) frame (the frame itself
// where (bh, bw) = (H, W)); out: win (n, 4) i32, mom
// (n, 12) f32 [m00, m10, m01, m11, m20, m02, invM00, xc, yc, mu20, mu02,
// mu11], flags (n, 2) u8 [zero_mass, escaped]; all contiguous.  c picks
// the kernel: 1 one CTA a stream (its planes must fit a CTA's shared
// memory), a power of two 2..16 a cluster of c CTAs a stream (the planes
// must fit c CTAs'), 0 the scratch kernel, whose scratch is n times
// scratch_floats(bh, bw) f32 (unused by the others).  A kernel that does
// not fit is refused.
extern "C" int meanshift_launch(const void* pdf, const void* window,
                                void* win, void* mom, void* flags,
                                void* scratch, int n, int bh, int bw, int H,
                                int W, int c, void* stream) {
  if (n <= 0) return 0;
  if (!side_ok(bh, bw) || !kernel_ok(c) || bh > H || bw > W ||
      (c == 0 && scratch == nullptr) || (c > 1 && n > INT_MAX / c) ||
      (c != 0 && smem_bytes(bh, bw, c) > max_smem())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pdf);
  const auto* w = static_cast<const int32_t*>(window);
  auto* wo = static_cast<int32_t*>(win);
  auto* mo = static_cast<float*>(mom);
  auto* fo = static_cast<uint8_t*>(flags);
  auto* sc = static_cast<float*>(scratch);
  const int smem = smem_bytes(bh, bw, c);
  const bool tma = bw % 4 == 0 && reinterpret_cast<uintptr_t>(pdf) % 16 == 0;
  if (c > 1) {
    return sm90::launch_cluster(
        tma ? meanshift_cluster_kernel<true> : meanshift_cluster_kernel<false>,
        dim3(c * n), c, kThreads, smem, st, p, w, wo, mo, fo, bh, bw, H, W,
        c);
  }
  if (c == 0) {
    launch<false, false>(n, smem, st, p, w, wo, mo, fo, sc, bh, bw, H, W);
  } else if (tma) {
    launch<true, true>(n, smem, st, p, w, wo, mo, fo, sc, bh, bw, H, W);
  } else {
    launch<true, false>(n, smem, st, p, w, wo, mo, fo, sc, bh, bw, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
