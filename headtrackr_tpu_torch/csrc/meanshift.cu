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
// line selections one-hot matmuls, each iteration a chain of small XLA ops;
// ported as it stood, one iteration was two gather launches and some forty
// small PyTorch kernels.
//   - Semantics: ops/meanshift.py mean_shift_plain, the kernel's twin, in
//     the twin's floating-point order, so the two agree to the bit on every
//     device (the twin's docstring states the order).  Every add, multiply,
//     subtract, divide and conversion is an _rn intrinsic: nothing
//     contracts into a fused multiply-add (F1), and the divisions are IEEE
//     (F6).
//   - Bound: bytes, and far from it.  The function reads the pdf once (48 KB
//     a stream at a 96x128 band) and writes 80 bytes; its adds are a few
//     per pixel.  What paces a CTA is latency: the prefix sums are serial
//     running sums (a thread a column, then a thread a row), and each
//     iteration is two block-wide reductions and one thread's window
//     arithmetic, a short serial loop.
//   - Design: one CTA (256 threads) per stream.  The pdf band arrives in
//     shared memory by TMA bulk copies (one a row, on one mbarrier) into a
//     row plane R of stride bw + 4; a thread per column turns it into the
//     inclusive column sums C (stride bw), then a thread per row scans R in
//     place (16-byte loads and stores; the padded stride keeps them free of
//     bank conflicts).  An iteration reads each window column's two C
//     entries and each window row's two R entries (X8's gather, now a
//     shared-memory load), reduces m00, m10 and m01 by warp shuffles and one
//     pass through shared memory, and thread 0 computes the next window and
//     broadcasts it.  A stream that reaches its fixed point leaves the loop
//     (frozen iterations are no-ops).  The second moments take one more
//     pass over the stopping window's pdf from global memory (L2-hot), a
//     warp a row.  At 96x128 the two planes take 99 KB, so two CTAs fit on
//     an SM and 256 streams run in one wave; at the 128x192 default band
//     one CTA does.
//   - Planes that do not fit in shared memory (the 240x320 full frame, 616
//     KB) live in a global scratch the caller allocates, the row plane
//     transposed so that a thread a row writes coalesced; the same code
//     reads them.
//   - Fixed order, matching the twin: prefix sums are f64 running sums in
//     index order, each stored rounded to f32 (what the CPU's cumsum of f32
//     gives); every reduction is the adjacent-pair tree over the
//     length zero-padded to a power of two.  The tree splits into 32-element
//     segments: a warp sums a segment by __shfl_down with offsets 1, 2, 4,
//     8, 16 (lane i adds lane i + offset), and one warp sums the segments'
//     sums the same way, so the result is the twin's for any number of
//     warps.  Hence bh, bw <= 1024 (32 segments).  The second moments sum
//     their f32 terms in f64, each row over x (a warp a row), then the rows
//     over y, and round once to f32.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 10;        // src/camshift.js:277
constexpr int kMaxSide = 1024;    // bh, bw: at most 32 segments of 32
constexpr int kMoments = 12;
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

// The shared-memory layout, in bytes from the dynamic base: the mbarrier,
// the broadcast words, the segment sums (f32 or f64), the second moments'
// f64 row sums, then (in the shared-plane variant) C and R.
struct Layout {
  int ph, pw, rs;                  // padded lengths, R's row stride (floats)
  int bcast, red, rows, c, r, end;
  __host__ __device__ Layout(int bh, int bw, bool planes) {
    ph = pow2_at_least(bh);
    pw = pow2_at_least(bw);
    rs = bw % 4 == 0 ? bw + 4 : (bw | 1);
    bcast = 16;
    red = bcast + 16 * 4;
    rows = red + 3 * 32 * 8;
    c = rows + round16(3 * ph * 8);
    r = c + (planes ? round16(bh * bw * 4) : 0);
    end = r + (planes ? round16(bh * rs * 4) : 0);
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

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float infinity() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ int js_shift(float v) {  // JS v >> 0 (F3)
  return isfinite(v) ? static_cast<int>(truncf(v)) : 0;
}

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
    return k == 0 ? 0.f : C[(k - 1) * bw + x];
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
                     const int32_t* __restrict__ ry,
                     const int32_t* __restrict__ rx,
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
  const float* p = pdf + n * npx;
  auto* bar = reinterpret_cast<uint64_t*>(smem);
  auto* bc = reinterpret_cast<int*>(smem + L.bcast);
  auto* red = reinterpret_cast<float*>(smem + L.red);  // [3][32] segments
  auto* red64 = reinterpret_cast<double*>(smem + L.red);
  auto* rows = reinterpret_cast<double*>(smem + L.rows);  // [3][ph]

  // ---- the prefix-sum planes ----------------------------------------------
  float* C;
  float* R;
  if (kShared) {
    C = reinterpret_cast<float*>(smem + L.c);
    R = reinterpret_cast<float*>(smem + L.r);
    if (kTma) {
      if (tid == 0) {
        sm90::mbar_init(bar, 1);
        sm90::mbar_init_fence();
      }
      __syncthreads();
      if (warp == 0) {
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(bar, static_cast<uint32_t>(npx * 4));
        }
        __syncwarp();
        for (int y = lane; y < bh; y += 32) {
          sm90::bulk_load(R + y * L.rs, p + y * bw,
                          static_cast<uint32_t>(bw * 4), bar);
        }
      }
      sm90::mbar_wait(bar, 0);
    } else {
      for (int i = tid; i < npx; i += kThreads) {
        R[(i / bw) * L.rs + i % bw] = p[i];
      }
      __syncthreads();
    }
    for (int x = tid; x < bw; x += kThreads) {  // column sums, from R
      double acc = 0.0;
      for (int y = 0; y < bh; ++y) {
        acc = __dadd_rn(acc, R[y * L.rs + x]);
        C[y * bw + x] = __double2float_rn(acc);
      }
    }
    __syncthreads();
    for (int y = tid; y < bh; y += kThreads) {  // row sums, R in place
      double acc = 0.0;
      if (bw % 4 == 0) {
        auto* r4 = reinterpret_cast<float4*>(R + y * L.rs);
        for (int q = 0; q < bw / 4; ++q) {
          float4 v = r4[q];
          acc = __dadd_rn(acc, v.x);
          v.x = __double2float_rn(acc);
          acc = __dadd_rn(acc, v.y);
          v.y = __double2float_rn(acc);
          acc = __dadd_rn(acc, v.z);
          v.z = __double2float_rn(acc);
          acc = __dadd_rn(acc, v.w);
          v.w = __double2float_rn(acc);
          r4[q] = v;
        }
      } else {
        for (int x = 0; x < bw; ++x) {
          acc = __dadd_rn(acc, R[y * L.rs + x]);
          R[y * L.rs + x] = __double2float_rn(acc);
        }
      }
    }
  } else {
    C = scratch + n * 2 * npx;
    R = C + npx;
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
  // Thread 0 carries the stream's state; bc[0..3] broadcast the iteration's
  // band bounds [x0, y0, x1, y1], bc[4] the stop flag, bc[8..11] the
  // stopping iteration's bounds.
  const bool banded = ry != nullptr;
  const int oy = banded ? ry[n] : 0;
  const int ox = banded ? rx[n] : 0;
  int wx = 0, wy = 0, ww = 0, wh = 0, prevx = 0, prevy = 0;
  bool esc = false;
  float m00 = 0.f, m10 = 0.f, m01 = 0.f;
  auto bounds = [&]() {  // thread 0: this iteration's band bounds into bc
    const int lx = max(wx, 0), ly = max(wy, 0);
    int b[4] = {lx - ox, ly - oy, min(lx + ww, W) - ox, min(ly + wh, H) - oy};
    if (banded) esc |= b[0] < 0 || b[1] < 0 || b[2] > bw || b[3] > bh;
    const int hi[4] = {bw, bh, bw, bh};
#pragma unroll
    for (int k = 0; k < 4; ++k) bc[k] = min(max(b[k], 0), hi[k]);
  };
  if (tid == 0) {
    wx = prevx = window[4 * n + 0];
    wy = prevy = window[4 * n + 1];
    ww = window[4 * n + 2];
    wh = window[4 * n + 3];
    bounds();
  }
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
      float n00 = block_total(red, L.pw);
      float n10 = block_total(red + 32, L.pw);
      float n01 = block_total(red + 64, L.ph);
      if (lane == 0) {
        if (x1 <= x0 || y1 <= y0) n00 = n10 = n01 = 0.f;  // empty window
        const bool nonzero = n00 > 0.f;
        const float safe = fmaxf(n00, kTiny);
        const float xc = nonzero ? __fdiv_rn(n10, safe) : quiet_nan();
        const float yc = nonzero ? __fdiv_rn(n01, safe) : quiet_nan();
        const float hw = __fdiv_rn(static_cast<float>(ww), 2.f);
        const float hh = __fdiv_rn(static_cast<float>(wh), 2.f);
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
          bounds();
        }
        bc[4] = stop;
      }
    }
    __syncthreads();
    if (bc[4]) break;
  }

  // ---- second moments over the stopping window ---------------------------
  const int x0 = bc[8], y0 = bc[9], x1 = bc[10], y1 = bc[11];
  {
    // a warp a row: segment s of the row (x in [32 s, 32 s + 32)) by
    // warp_tree in f64, its sum kept in lane s; then the tree over the
    // segments
    const int ns = L.pw > 32 ? L.pw / 32 : 1;
    const int lanes = L.pw < 32 ? L.pw : 32;
    for (int y = warp; y < L.ph; y += kWarps) {
      double s11 = 0.0, s20 = 0.0, s02 = 0.0;
      if (y >= y0 && y < y1) {
        const float vy = static_cast<float>(y - y0);
        for (int s = 0; s < ns; ++s) {
          if (32 * s + 31 < x0 || 32 * s >= x1) continue;  // a +0 segment
          const int x = 32 * s + lane;
          float a = 0.f, b = 0.f, c = 0.f;
          if (x >= x0 && x < x1) {
            const float v = __ldg(p + y * bw + x);
            const float vx = static_cast<float>(x - x0);
            a = __fmul_rn(__fmul_rn(vx, vy), v);
            b = __fmul_rn(__fmul_rn(vx, vx), v);
            c = __fmul_rn(__fmul_rn(vy, vy), v);
          }
          const double da =
              __shfl_sync(kFull, warp_tree(static_cast<double>(a), lanes), 0);
          const double db =
              __shfl_sync(kFull, warp_tree(static_cast<double>(b), lanes), 0);
          const double dc =
              __shfl_sync(kFull, warp_tree(static_cast<double>(c), lanes), 0);
          if (lane == s) {
            s11 = da;
            s20 = db;
            s02 = dc;
          }
        }
        s11 = warp_tree(s11, ns);
        s20 = warp_tree(s20, ns);
        s02 = warp_tree(s02, ns);
      }
      if (lane == 0) {
        rows[y] = s11;
        rows[L.ph + y] = s20;
        rows[2 * L.ph + y] = s02;
      }
    }
  }
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
    if (lane == 0) {
      const bool nonzero = m00 > 0.f;
      const float inv =
          nonzero ? __fdiv_rn(1.f, fmaxf(m00, kTiny)) : infinity();
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

bool planes_fit(int bh, int bw) {
  return Layout(bh, bw, true).end <= max_smem();
}

template <bool kShared, bool kTma>
void launch(int n, int smem, cudaStream_t st, const float* pdf,
            const int32_t* window, const int32_t* ry, const int32_t* rx,
            int32_t* win, float* mom, uint8_t* flags, float* scratch, int bh,
            int bw, int H, int W) {
  cudaFuncSetAttribute(meanshift_kernel<kShared, kTma>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  meanshift_kernel<kShared, kTma><<<n, kThreads, smem, st>>>(
      pdf, window, ry, rx, win, mom, flags, scratch, bh, bw, H, W);
}

}  // namespace

// Floats of global scratch a stream needs: 0 where the planes fit in shared
// memory, else 2 bh bw (C and the transposed R).
extern "C" int meanshift_scratch_floats(int bh, int bw) {
  if (bh < 1 || bw < 1 || bh > kMaxSide || bw > kMaxSide) return -1;
  return planes_fit(bh, bw) ? 0 : 2 * bh * bw;
}

// pdf (n, bh, bw) f32, window (n, 4) i32 [x, y, w, h], ry / rx (n,) i32
// band origins or both null (a full-frame pdf); out: win (n, 4) i32, mom
// (n, 12) f32 [m00, m10, m01, m11, m20, m02, invM00, xc, yc, mu20, mu02,
// mu11], flags (n, 2) u8 [zero_mass, escaped]; scratch (n, 2 bh bw) f32
// where meanshift_scratch_floats says so, else unused.  All contiguous.
extern "C" int meanshift_launch(const void* pdf, const void* window,
                                const void* ry, const void* rx, void* win,
                                void* mom, void* flags, void* scratch, int n,
                                int bh, int bw, int H, int W, void* stream) {
  if (n <= 0) return 0;
  const int need = meanshift_scratch_floats(bh, bw);
  if (need < 0 || (ry == nullptr) != (rx == nullptr) ||
      (need > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pdf);
  const auto* w = static_cast<const int32_t*>(window);
  const auto* oy = static_cast<const int32_t*>(ry);
  const auto* ox = static_cast<const int32_t*>(rx);
  auto* wo = static_cast<int32_t*>(win);
  auto* mo = static_cast<float*>(mom);
  auto* fo = static_cast<uint8_t*>(flags);
  auto* sc = static_cast<float*>(scratch);
  if (need == 0) {
    const int smem = Layout(bh, bw, true).end;
    if (bw % 4 == 0 && reinterpret_cast<uintptr_t>(pdf) % 16 == 0) {
      launch<true, true>(n, smem, st, p, w, oy, ox, wo, mo, fo, sc, bh, bw, H,
                         W);
    } else {
      launch<true, false>(n, smem, st, p, w, oy, ox, wo, mo, fo, sc, bh, bw,
                          H, W);
    }
  } else {
    launch<false, false>(n, Layout(bh, bw, false).end, st, p, w, oy, ox, wo,
                         mo, fo, sc, bh, bw, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
