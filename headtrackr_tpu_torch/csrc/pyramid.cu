// pyramid for Hopper (sm_90a): the detector's packed plane buffer, straight
// from the gray frames, in one launch.
//
// It replaces headtrackr_tpu/ops/imageproc.py resize_bilinear and
// build_pyramid (the ~120 resizes of a detection pyramid, each ~23 PyTorch
// operations in the plain twin) together with the packing of the planes
// into one flat u8 buffer a stream (ops/imageproc.py pack_pyramid):
//   - Semantics: the defined drawImage of ops/imageproc.py: an output pixel
//     (r, c) of a plane's [0, dh) x [0, dw) region is
//       top = s[y0, x0] * gx + s[y0, x1] * fx
//       bot = s[y1, x0] * gx + s[y1, x1] * fx
//       v   = top * gy + bot * fy
//     in f32, every product and sum rounded on its own (no fused
//     multiply-add: __fmul_rn / __fadd_rn), clamped to [0, 255] and
//     rounded half to even to u8; the rest of the plane is 0.  The grids
//     (x0, x1, gx = 1 - fx, fx and the rows' likewise) come from the host
//     (ops/imageproc.py _grid, NumPy f32), so the planes are the twin's to
//     the bit.
//   - Plan (ops/imageproc.py pyramid_plan): level i >= next is level
//     i - next halved, and its shifted quarter variants read level i - next
//     too, so a stream's pyramid is `next` independent chains (6: levels c,
//     c + 6, c + 12, ...).  A step is one level of a chain: level 0 copies
//     the frame, levels 1..5 resize the frame, every other level resizes
//     the chain's previous level.  A step writes its plane (row-major) and,
//     from level 2 next on, the four quarter planes pixel-interleaved
//     (I[2a + dy, 2b + dx] = q_{2dy+dx}[a, b]): one thread computes q0..q3 at
//     (a, b) and stores the 2x2 block as two 2-byte stores.
//   - Design: one launch.  A cluster of S CTAs (S in 1, 2, 4, 8, 16; chosen by
//     kernels/pyramid.py split) a (stream, chain), its steps in order with
//     a barrier between them; row r of a level on CTA r % S, a warp a row
//     (the row's y grid loaded once), lanes over its columns.  A level the
//     next one reads stays in shared memory (even steps in region 0, odd
//     ones in region 1, the CTA's rows only; the next level reads a peer's
//     rows through distributed shared memory), so no level is computed
//     twice and nothing makes a round trip through device memory; a level
//     too large for its region (kernels/pyramid.py pyramid_regions, which
//     sizes the regions so that kCtasPerSm CTAs fit an SM, the occupancy
//     kernels/pyramid.py split counts on: 480x640's first levels at S <= 4)
//     is read back from its packed plane, in L2.
//   - Bound: bytes.  A pixel reads four source bytes (shared memory, or L2)
//     and writes one; the frames are read once and the planes written once.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;  // resident CTAs an SM (registers, shared memory)
// a CTA's shared memory: its share of an SM's 233,472 bytes, less the
// 1,024 the system reserves a CTA
constexpr int kSmemPerCta = 233472 / kCtasPerSm - 1024;
constexpr int kCols = 14;  // PyramidPlan.steps columns (STEP_COLS)

enum {
  kLevel, kW, kH, kSw, kSh, kFrom, kXa, kYa, kXb, kYb, kPlane, kInter,
  kSource, kScr
};
enum { kFromCopy = -1, kFromFrame = 0, kFromPrev = 1 };

// The three places a level's source bytes come from.
struct LdFrame {  // the frames: read-only for the whole launch
  __device__ __forceinline__ float operator()(const uint8_t* p) const {
    return static_cast<float>(__ldg(p));
  }
};
struct LdWritten {  // a plane this launch wrote: L2, never a stale L1 line
  __device__ __forceinline__ float operator()(const uint8_t* p) const {
    return static_cast<float>(__ldcg(p));
  }
};
struct LdShared {  // this CTA's or a peer's shared memory (generic address)
  __device__ __forceinline__ float operator()(const uint8_t* p) const {
    return static_cast<float>(*p);
  }
};

// One output byte from source rows r0 (y0) and r1 (y1), column grid x.
template <class Ld>
__device__ __forceinline__ uint8_t lerp(Ld ld, const uint8_t* r0,
                                        const uint8_t* r1, int4 x, float gy,
                                        float fy) {
  const float gx = __int_as_float(x.z), fx = __int_as_float(x.w);
  const float top = __fadd_rn(__fmul_rn(ld(r0 + x.x), gx),
                              __fmul_rn(ld(r0 + x.y), fx));
  const float bot = __fadd_rn(__fmul_rn(ld(r1 + x.x), gx),
                              __fmul_rn(ld(r1 + x.y), fx));
  float v = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(__float2int_rn(v));
}

// Bytes a, b at p, p + 1: one 2-byte store where p is even.
__device__ __forceinline__ void store2(uint8_t* p, uint8_t a, uint8_t b,
                                       bool even) {
  if (even) {
    *reinterpret_cast<uint16_t*>(p) =
        static_cast<uint16_t>(a | (static_cast<uint16_t>(b) << 8));
  } else {
    p[0] = a;
    p[1] = b;
  }
}

// 16 bytes at p, in the widest stores p's alignment allows.
__device__ __forceinline__ void store16(uint8_t* p, uint4 v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = v;
  } else if ((a & 3) == 0) {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
    q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
}

// Level 0: the frame copied into its plane, split over the chain's CTAs.
__device__ void copy_frame(const uint8_t* __restrict__ frame,
                           uint8_t* __restrict__ dst, int hw, int rank,
                           int split) {
  const int t = rank * kThreads + threadIdx.x, stride = split * kThreads;
  if ((hw & 15) == 0 && (reinterpret_cast<uintptr_t>(frame) & 15) == 0) {
    const uint4* f = reinterpret_cast<const uint4*>(frame);
    for (int i = t; i < hw / 16; i += stride) store16(dst + 16 * i, __ldg(f + i));
  } else {
    for (int i = t; i < hw; i += stride) dst[i] = __ldg(frame + i);
  }
}

// One step (a level of the chain) read through `ld` from source rows
// `rows(y)`, its column grids xa and row grids ya_t (xb, yb_t: the shifted
// variants') in shared memory: its plane, its interleaved quarter planes,
// and its rows kept in `hold` (this CTA's region; null: not held) or in
// the scratch.
template <int S, class Ld, class Rows>
__device__ void resize_level(Ld ld, Rows rows, const int* st,
                             const int4* xa, const int4* xb,
                             const int4* ya_t, const int4* yb_t, uint8_t* out,
                             uint8_t* scr, uint8_t* hold, int rank) {
  const int w = st[kW], h = st[kH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int plane = st[kPlane], inter = st[kInter], so = st[kScr];
  const bool xb_ok = st[kXb] >= 0, yb_ok = st[kYb] >= 0;
  const bool even = ((reinterpret_cast<uintptr_t>(out) + inter) & 1) == 0;
  for (int r = rank + S * warp; r < h; r += S * kWarps) {
    const int4 ya = ya_t[r];
    const uint8_t* a0 = rows(ya.x);
    const uint8_t* a1 = rows(ya.y);
    const float gya = __int_as_float(ya.z), fya = __int_as_float(ya.w);
    const bool ry = inter >= 0 && yb_ok && r < h - 2;  // q2, q3 rows
    int4 yb = make_int4(0, 0, 0, 0);
    const uint8_t *b0 = a0, *b1 = a1;
    if (ry) {
      yb = yb_t[r];
      b0 = rows(yb.x);
      b1 = rows(yb.y);
    }
    const float gyb = __int_as_float(yb.z), fyb = __int_as_float(yb.w);
    for (int c = lane; c < w; c += 32) {
      const int4 x = xa[c];
      const uint8_t q0 = lerp(ld, a0, a1, x, gya, fya);
      if (plane >= 0) out[plane + r * w + c] = q0;
      if (hold != nullptr) {
        hold[(r / S) * w + c] = q0;
      } else if (so >= 0) {
        scr[so + r * w + c] = q0;
      }
      if (inter >= 0) {
        const bool cx = xb_ok && c < w - 2;  // q1, q3 columns
        uint8_t q1 = 0, q2 = 0, q3 = 0;
        int4 x1 = make_int4(0, 0, 0, 0);
        if (cx) {
          x1 = xb[c];
          q1 = lerp(ld, a0, a1, x1, gya, fya);
        }
        if (ry) q2 = lerp(ld, b0, b1, x, gyb, fyb);
        if (cx && ry) q3 = lerp(ld, b0, b1, x1, gyb, fyb);
        uint8_t* i0 = out + inter + (2 * r) * (2 * w) + 2 * c;
        store2(i0, q0, q1, even);
        store2(i0 + 2 * w, q2, q3, even);
      }
    }
  }
}

template <int S>
__device__ __forceinline__ void chain_sync() {
  if constexpr (S == 1) {
    __syncthreads();
  } else {
    sm90::cluster_sync();
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
pyramid_kernel(const uint8_t* __restrict__ gray,
               uint8_t* __restrict__ scratch, uint8_t* __restrict__ packed,
               const int32_t* __restrict__ steps,
               const int32_t* __restrict__ chain_first,
               const int32_t* __restrict__ chain_grid,
               const int4* __restrict__ xg, const int4* __restrict__ yg,
               int w0, int h0, int s_len, int l_len, int r0, int r1) {
  // [region 0 (r0) | region 1 (r1) | the chain's column grids, row grids]
  extern __shared__ __align__(16) uint8_t smem[];
  int4* sgx = reinterpret_cast<int4*>(smem + ((r0 + r1 + 15) & ~15));
  const int chain = blockIdx.x / S, rank = blockIdx.x % S;
  const int64_t n = blockIdx.y;
  const uint8_t* frame = gray + n * w0 * h0;
  uint8_t* out = packed + n * l_len;
  uint8_t* scr = scratch + n * s_len;
  const int first = __ldg(chain_first + chain);
  const int end = __ldg(chain_first + chain + 1);
  // every grid of the chain, staged once: no step waits on L2 for them
  const int xf = __ldg(chain_grid + 4 * chain), xn = __ldg(chain_grid + 4 * chain + 1);
  const int yf = __ldg(chain_grid + 4 * chain + 2), yn = __ldg(chain_grid + 4 * chain + 3);
  int4* sgy = sgx + xn;
  for (int i = threadIdx.x; i < xn + yn; i += kThreads) {
    sgx[i] = __ldg(i < xn ? xg + xf + i : yg + yf + i - xn);
  }
  __syncthreads();
  int prev[kCols];
  bool prev_held = false;
  for (int k = first; k < end; ++k) {
    int st[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) st[i] = __ldg(steps + k * kCols + i);
    const int j = k - first;
    if (j > 0) chain_sync<S>();  // the previous level is complete
    const int4* xa = sgx + (st[kXa] - xf);
    const int4* xb = sgx + (st[kXb] - xf);
    const int4* ya = sgy + (st[kYa] - yf);
    const int4* yb = sgy + (st[kYb] - yf);
    uint8_t* region = smem + ((j & 1) ? r0 : 0);
    const int rows_here = (st[kH] + S - 1) / S;
    const bool held = st[kSource] && rows_here * st[kW] <= ((j & 1) ? r1 : r0);
    uint8_t* hold = held ? region : nullptr;
    if (st[kFrom] == kFromCopy) {
      if (st[kPlane] >= 0) copy_frame(frame, out + st[kPlane], w0 * h0, rank, S);
    } else if (st[kFrom] == kFromFrame) {
      resize_level<S>(LdFrame(), [=](int y) { return frame + y * w0; }, st,
                      xa, xb, ya, yb, out, scr, hold, rank);
    } else if (prev_held) {
      const uint8_t* src = smem + ((j & 1) ? 0 : r0);
      const int sw = prev[kW];
      resize_level<S>(LdShared(), [=](int y) {
        const uint8_t* p = src + (y / S) * sw;
        if constexpr (S == 1) {
          return p;
        } else {
          return static_cast<const uint8_t*>(
              sm90::map_peer(const_cast<uint8_t*>(p), y % S));
        }
      }, st, xa, xb, ya, yb, out, scr, hold, rank);
    } else {
      const uint8_t* src = prev[kPlane] >= 0 ? out + prev[kPlane]
                                             : scr + prev[kScr];
      const int sw = prev[kW];
      resize_level<S>(LdWritten(), [=](int y) { return src + y * sw; }, st,
                      xa, xb, ya, yb, out, scr, hold, rank);
    }
    prev_held = held;
#pragma unroll
    for (int i = 0; i < kCols; ++i) prev[i] = st[i];
  }
  // peers may still read this CTA's rows of the last level
  if constexpr (S > 1) sm90::cluster_sync();
}

template <int S>
int launch_split(dim3 grid, int smem, cudaStream_t stream,
                 const uint8_t* gray, uint8_t* scratch, uint8_t* packed,
                 const int32_t* steps, const int32_t* chain_first,
                 const int32_t* chain_grid, const int4* xg, const int4* yg,
                 int w0, int h0, int s_len,
                 int l_len, int r0, int r1) {
  if constexpr (S == 1) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(pyramid_kernel<1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    pyramid_kernel<1><<<grid, kThreads, smem, stream>>>(
        gray, scratch, packed, steps, chain_first, chain_grid, xg, yg, w0,
        h0, s_len, l_len, r0, r1);
    return static_cast<int>(cudaGetLastError());
  } else {
    return sm90::launch_cluster(pyramid_kernel<S>, grid, S, kThreads, smem,
                                stream, gray, scratch, packed, steps,
                                chain_first, chain_grid, xg, yg, w0, h0,
                                s_len, l_len, r0, r1);
  }
}

}  // namespace

// gray (n, h0, w0) u8, scratch (n, s_len) u8, packed (n, l_len) u8, steps
// (J, 14) i32, chain_first (chains + 1,) i32, chain_grid (chains, 4) i32
// (a chain's rows of xg and of yg: first, count), xg / yg (., 4) i32; split:
// CTAs a chain (1, 2, 4, 8 or 16); r0, r1: the shared-memory regions' bytes
// (kernels/pyramid.py pyramid_regions for this split); grid_bytes: a chain's
// staged grids, at most (PyramidPlan.grid_bytes).
extern "C" int pyramid_launch(const void* gray, void* scratch, void* packed,
                              const void* steps, const void* chain_first,
                              const void* chain_grid, const void* xg,
                              const void* yg, int chains,
                              int n, int w0, int h0, int s_len, int l_len,
                              int split, int r0, int r1, int grid_bytes,
                              void* stream) {
  const int smem = ((r0 + r1 + 15) & ~15) + grid_bytes;
  if (n > 65535 || chains < 0 || r0 < 0 || r1 < 0 || grid_bytes < 0 ||
      smem > kSmemPerCta) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || chains == 0) return 0;
  const dim3 grid(chains * split, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const uint8_t*>(gray);
  auto* sc = static_cast<uint8_t*>(scratch);
  auto* p = static_cast<uint8_t*>(packed);
  const auto* st = static_cast<const int32_t*>(steps);
  const auto* cf = static_cast<const int32_t*>(chain_first);
  const auto* cg = static_cast<const int32_t*>(chain_grid);
  const auto* x = static_cast<const int4*>(xg);
  const auto* y = static_cast<const int4*>(yg);
  switch (split) {
    case 1:
      return launch_split<1>(grid, smem, s, g, sc, p, st, cf, cg, x, y, w0, h0,
                             s_len, l_len, r0, r1);
    case 2:
      return launch_split<2>(grid, smem, s, g, sc, p, st, cf, cg, x, y, w0, h0,
                             s_len, l_len, r0, r1);
    case 4:
      return launch_split<4>(grid, smem, s, g, sc, p, st, cf, cg, x, y, w0, h0,
                             s_len, l_len, r0, r1);
    case 8:
      return launch_split<8>(grid, smem, s, g, sc, p, st, cf, cg, x, y, w0, h0,
                             s_len, l_len, r0, r1);
    case 16:
      return launch_split<16>(grid, smem, s, g, sc, p, st, cf, cg, x, y, w0,
                              h0, s_len, l_len, r0, r1);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
