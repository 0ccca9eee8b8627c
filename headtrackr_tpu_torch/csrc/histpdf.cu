// Camshift pixel kernels for Hopper (sm_90a): the 4096-bin RGB histogram,
// the ratio-weight backprojection and the fused band histogram + weights +
// pdf, over a batch of u8 RGB frames.
//
// hist4096 replaces headtrackr_tpu/kernels/histpdf.py::hist_pallas
// (_hist_kernel, _onehots, _pad_blocks).  The TPU kernel builds hi/lo
// one-hot factors per 7,680-pixel block and contracts them on the MXU into a
// (64, 64) count matrix.  Here the native form is a shared-memory histogram:
//   - Bound: bytes.  One read of the frame, 230 KB of RGB per 320x240 stream;
//     the arithmetic per pixel is a few shifts and one shared-memory atomic.
//   - Design: binning is fused into the kernel (no i32 bin image in device
//     memory).  Each block owns a 16 KB shared histogram for one stream's
//     slice of the rect, updates it with shared integer atomics and flushes
//     its nonzero bins with global integer atomics.  Integer atomics are
//     exact in any order, so the counts are bit-equal to any other
//     formulation.
//   - Contention: camera-like frames put most pixels of a warp in the same
//     bin (a flat background, a 2-3-bin face).  Each warp aggregates first
//     (__match_any_sync): one atomic per distinct bin in the warp, adding the
//     peer count, instead of 32 serialized atomics on one address.
//   - The grid is sized by the frame, so the rect should cover most of it:
//     the serving path calls it for full-frame current histograms only.
//     Small rects (a detection box, a band) go to histpdf_band below.
//
// backproject replaces headtrackr_tpu/kernels/histpdf.py::pdf_pallas
// (_pdf_kernel).  The TPU kernel needs a triple-bf16 split of the weight
// table and three one-hot matmuls to select an exact f32 weight.  Here:
//   - Bound: bytes.  One read of the frame (230 KB) and one write of the f32
//     pdf (300 KB) per 320x240 stream.
//   - Design: each block stages its stream's 16 KB weight table in shared
//     memory, then each thread bins its pixels and loads the weight.  A table
//     load is exact by construction, so no split is needed.  Blocks cover
//     16,384 pixels each so the table load stays small against the pixels.
//
// backproject_rect is the same lookup over a per-stream (bh, bw) band (the
// band pdf of the band-local camshift with full-frame histograms), on the
// band configuration's steady tick once a tick.
//   - Bound: bytes.  At a 96x128 band: 36 KB of RGB in, 48 KB of pdf out
//     and the 16 KB weight row per stream; 0.0078 ms at 256 streams.
//   - Design: a thread-block cluster of kCluster CTAs per stream splits the
//     band's rows.  The stream's 16 KB weight row reaches every CTA's shared
//     memory by TMA: each CTA copies a quarter with .multicast::cluster, so
//     the row is read once a stream, not once a CTA, and no thread stages
//     it.  Row and column loops, advanced without division.  Where the
//     band's rows start 4-byte aligned and its width is a multiple of 4 (the
//     serving path: the band's x origin is a multiple of 8), a thread takes
//     4 pixels at a time: three 4-byte loads, four lookups and one 16-byte
//     store.  Any other origin or width takes the pixel-at-a-time loop.
//
// histpdf_band replaces tools/kernel_experiments.py hp_call (k4) and
// hp7_call (k7), the fused per-stream histogram + min(model/cur, 1) weights +
// pdf, and in hist-only mode hist_call (k3).  On the TPU each grid step is
// one stream, the histogram is a one-hot MXU contraction and the pdf a
// bf16-plane weight matmul.  Here:
//   - Bound: bytes.  At a 96x128 band: 36 KB of RGB in, a 16 KB model in,
//     16 KB of counts and 48 KB of pdf out per stream.
//   - Design: one block per stream (the TPU kernel's grid=(N,)), so no
//     cross-block merge and no global atomics.  Pass 1 bins the rect into a
//     16 KB shared i32 histogram with warp-aggregated shared atomics; the
//     epilogue writes the f32 counts and, in pdf mode, forms the weights in
//     a 16 KB shared table with IEEE division (bit-equal to the torch
//     formulation); pass 2 reads the rect again (from L2) and writes
//     pdf = table[bin].  Hist-only mode stops after the counts.
//
// All launch on the caller's stream, allocate nothing and return
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kBins = 4096;
constexpr int kThreads = 256;
constexpr int kBandThreads = 512;
constexpr int kHistPixelsPerBlock = 8192;
constexpr int kPdfPixelsPerBlock = 16384;
constexpr int kCluster = 4;  // backproject_rect's CTAs per stream

__device__ __forceinline__ int rgb_bin(const uint8_t* px) {
  return (static_cast<int>(px[0] >> 4) << 8) |
         (static_cast<int>(px[1] >> 4) << 4) |
         static_cast<int>(px[2] >> 4);
}

// The rect [x, y, w, h] clamped to the frame: origin (x0, y0), size rw x rh.
struct Rect {
  int64_t x0, y0, rw, rh;
};

__device__ __forceinline__ Rect clamped_rect(const int32_t* r, int h, int w) {
  const int64_t rx = r[0], ry = r[1];
  const int64_t x0 = rx > 0 ? rx : 0;
  const int64_t y0 = ry > 0 ? ry : 0;
  int64_t x1 = rx + r[2];
  int64_t y1 = ry + r[3];
  x1 = x1 < w ? x1 : w;
  y1 = y1 < h ? y1 : h;
  return {x0, y0, x1 > x0 ? x1 - x0 : 0, y1 > y0 ? y1 - y0 : 0};
}

// A (bh, bw) band at the rect's origin, the origin clipped so the band lies
// in the frame (the caller guarantees bh <= h and bw <= w).
__device__ __forceinline__ Rect band_rect(const int32_t* r, int h, int w,
                                          int bh, int bw) {
  int64_t x0 = r[0], y0 = r[1];
  x0 = x0 < 0 ? 0 : (x0 > w - bw ? w - bw : x0);
  y0 = y0 < 0 ? 0 : (y0 > h - bh ? h - bh : y0);
  return {x0, y0, bw, bh};
}

// Count the pixels [start, end) of the rect into a shared histogram.  The
// loop bound is uniform across the block, so every warp runs the same trip
// count and __match_any_sync sees all 32 lanes.
__device__ __forceinline__ void count_pixels(const uint8_t* f, int w,
                                             const Rect& rc, int64_t start,
                                             int64_t end, int32_t* hist) {
  const int lane = threadIdx.x & 31;
  for (int64_t base = start; base < end; base += blockDim.x) {
    const int64_t p = base + threadIdx.x;
    int bin = -1;
    if (p < end) {
      const int64_t yy = rc.y0 + p / rc.rw;
      const int64_t xx = rc.x0 + p % rc.rw;
      bin = rgb_bin(f + (yy * w + xx) * 3);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[bin], __popc(peers));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hist4096_kernel(const uint8_t* __restrict__ frames,
                const int32_t* __restrict__ rects,
                int32_t* __restrict__ out, int h, int w) {
  __shared__ int32_t hist[kBins];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
  const Rect rc = clamped_rect(rects + 4 * static_cast<int64_t>(n), h, w);
  const int64_t npx = rc.rw * rc.rh;
  __syncthreads();

  const uint8_t* f = frames + static_cast<int64_t>(n) * h * w * 3;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kHistPixelsPerBlock;
  int64_t end = start + kHistPixelsPerBlock;
  end = end < npx ? end : npx;
  count_pixels(f, w, rc, start, end, hist);
  __syncthreads();

  int32_t* o = out + static_cast<int64_t>(n) * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const int32_t c = hist[i];
    if (c != 0) atomicAdd(&o[i], c);
  }
}

__device__ __forceinline__ const float* stage_table(const float* weights,
                                                    int n, float4* table4) {
  const float4* w4 =
      reinterpret_cast<const float4*>(weights + static_cast<int64_t>(n) * kBins);
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) table4[i] = w4[i];
  __syncthreads();
  return reinterpret_cast<const float*>(table4);
}

__global__ void __launch_bounds__(kThreads)
backproject_kernel(const uint8_t* __restrict__ frames,
                   const float* __restrict__ weights,
                   float* __restrict__ out, int64_t hw) {
  __shared__ float4 table4[kBins / 4];
  const int n = blockIdx.y;
  const float* table = stage_table(weights, n, table4);

  const uint8_t* f = frames + static_cast<int64_t>(n) * hw * 3;
  float* o = out + static_cast<int64_t>(n) * hw;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kPdfPixelsPerBlock;
  int64_t end = start + kPdfPixelsPerBlock;
  end = end < hw ? end : hw;
  for (int64_t p = start + threadIdx.x; p < end; p += blockDim.x) {
    o[p] = table[rgb_bin(f + p * 3)];
  }
}

__device__ __forceinline__ int bin_of(uint32_t R, uint32_t G, uint32_t B) {
  return static_cast<int>(((R >> 4) << 8) | ((G >> 4) << 4) | (B >> 4));
}

// grid (kCluster, N), one cluster a stream: CTA `rank` of stream n looks up
// its share of the band's rows.  vec: the launcher found the frames 4-byte
// aligned, w and bw multiples of 4 and out 16-byte aligned.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
backproject_rect_kernel(const uint8_t* __restrict__ frames,
                        const float* __restrict__ weights,
                        const int32_t* __restrict__ rects,
                        float* __restrict__ out, int h, int w, int bh, int bw,
                        bool vec) {
  __shared__ alignas(16) float table[kBins];
  __shared__ uint64_t bar;
  const int n = blockIdx.y;
  const uint32_t rank = sm90::cluster_rank();
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::mbar_init_fence();
  }
  // every CTA's barrier is set before any CTA's copy lands on it
  sm90::cluster_arrive();
  sm90::cluster_wait();
  if (threadIdx.x == 0) {
    constexpr uint32_t kSlice = kBins * sizeof(float) / kCluster;
    sm90::mbar_arrive_expect_tx(&bar, kBins * sizeof(float));
    sm90::bulk_load_multicast(
        reinterpret_cast<char*>(table) + rank * kSlice,
        reinterpret_cast<const char*>(weights + static_cast<int64_t>(n) * kBins)
            + rank * kSlice,
        kSlice, &bar, static_cast<uint16_t>((1u << kCluster) - 1));
  }
  const Rect rc = band_rect(rects + 4 * static_cast<int64_t>(n), h, w, bh, bw);
  const int x0 = static_cast<int>(rc.x0);
  const int rows = (bh + kCluster - 1) / kCluster;
  const int r0 = static_cast<int>(rank) * rows;
  const int nrows = max(0, min(bh - r0, rows));
  const uint8_t* f = frames + static_cast<int64_t>(n) * h * w * 3 +
                     (static_cast<int64_t>(rc.y0 + r0) * w + x0) * 3;
  float* o = out + static_cast<int64_t>(n) * bh * bw +
             static_cast<int64_t>(r0) * bw;
  sm90::mbar_wait(&bar, 0);
  // this CTA holds the whole row, so every copy into it has landed
  sm90::cluster_arrive();

  const bool quad = vec && x0 % 4 == 0;
  const int cols = quad ? bw / 4 : bw;  // units a row: 4 pixels or 1
  const int units = nrows * cols;
  // unit u = (row, col), advanced by blockDim.x units a step
  const int step_r = blockDim.x / cols;
  const int step_c = blockDim.x - step_r * cols;
  int row = threadIdx.x / cols;
  int col = threadIdx.x - row * cols;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int src = row * w + (quad ? 4 * col : col);
    const int dst = row * bw + (quad ? 4 * col : col);
    if (quad) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(f + 3 * src);
      const uint32_t a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      // little-endian bytes: a = R0 G0 B0 R1, b = G1 B1 R2 G2, c = B2 R3 G3 B3
      float4 v;
      v.x = table[bin_of(a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF)];
      v.y = table[bin_of(a >> 24, b & 0xFF, (b >> 8) & 0xFF)];
      v.z = table[bin_of((b >> 16) & 0xFF, b >> 24, c & 0xFF)];
      v.w = table[bin_of((c >> 8) & 0xFF, (c >> 16) & 0xFF, c >> 24)];
      *reinterpret_cast<float4*>(o + dst) = v;
    } else {
      o[dst] = table[rgb_bin(f + 3 * src)];
    }
    col += step_c;
    row += step_r;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
  // no CTA exits while a copy it issued may still land in another
  sm90::cluster_wait();
}

template <bool kPdf>
__global__ void __launch_bounds__(kBandThreads)
histpdf_band_kernel(const uint8_t* __restrict__ frames,
                    const int32_t* __restrict__ rects,
                    const float* __restrict__ model,
                    float* __restrict__ cur, float* __restrict__ pdf,
                    int h, int w, int bh, int bw) {
  __shared__ int32_t hist[kBins];
  __shared__ float table[kPdf ? kBins : 1];
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
  const int32_t* r = rects + 4 * static_cast<int64_t>(n);
  const Rect rc = kPdf ? band_rect(r, h, w, bh, bw) : clamped_rect(r, h, w);
  const int64_t npx = rc.rw * rc.rh;
  __syncthreads();

  const uint8_t* f = frames + static_cast<int64_t>(n) * h * w * 3;
  count_pixels(f, w, rc, 0, npx, hist);
  __syncthreads();

  float* c = cur + static_cast<int64_t>(n) * kBins;
  const float* m = kPdf ? model + static_cast<int64_t>(n) * kBins : nullptr;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const int32_t k = hist[i];
    const float cf = static_cast<float>(k);
    c[i] = cf;
    if constexpr (kPdf) {
      // min(model / cur, 1), 0 where cur == 0: IEEE round-to-nearest
      // division, as the torch formulation (ops/histogram.py)
      table[i] = k != 0 ? fminf(__fdiv_rn(m[i], cf), 1.0f) : 0.0f;
    }
  }
  if constexpr (kPdf) {
    __syncthreads();
    float* o = pdf + static_cast<int64_t>(n) * npx;
    for (int64_t p = threadIdx.x; p < npx; p += blockDim.x) {
      const int64_t yy = rc.y0 + p / rc.rw;
      const int64_t xx = rc.x0 + p % rc.rw;
      o[p] = table[rgb_bin(f + (yy * w + xx) * 3)];
    }
  }
}

int blocks_for(int64_t pixels, int per_block) {
  const int64_t b = (pixels + per_block - 1) / per_block;
  return b > 0 ? static_cast<int>(b) : 1;
}

}  // namespace

// frames (n, h, w, 3) u8, rects (n, 4) i32 [x, y, w, h], out (n, 4096) i32
// zero-filled by the caller.
extern "C" int hist4096_launch(const void* frames, const void* rects, void* out,
                               int n, int h, int w, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(blocks_for(static_cast<int64_t>(h) * w, kHistPixelsPerBlock), n);
  hist4096_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int32_t*>(rects),
      static_cast<int32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

// frames (n, h, w, 3) u8, weights (n, 4096) f32 (16-byte aligned rows),
// out (n, h, w) f32.
extern "C" int backproject_launch(const void* frames, const void* weights,
                                  void* out, int n, int h, int w, void* stream) {
  if (n <= 0) return 0;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(blocks_for(hw, kPdfPixelsPerBlock), n);
  backproject_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(weights),
      static_cast<float*>(out), hw);
  return static_cast<int>(cudaGetLastError());
}

// frames (n, h, w, 3) u8, weights (n, 4096) f32 (16-byte aligned rows),
// rects (n, 4) i32 whose [x, y] place a (bh, bw) band (clipped into the
// frame; 1 <= bh <= h, 1 <= bw <= w), out (n, bh, bw) f32.  One cluster of
// kCluster CTAs a stream.
extern "C" int backproject_rect_launch(const void* frames, const void* weights,
                                       const void* rects, void* out, int n,
                                       int h, int w, int bh, int bw,
                                       void* stream) {
  if (n <= 0) return 0;
  if (n > 65535 || bh < 1 || bw < 1 || bh > h || bw > w ||
      static_cast<int64_t>(h) * w * 3 > INT32_MAX ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = reinterpret_cast<uintptr_t>(frames) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && w % 4 == 0 &&
                   bw % 4 == 0;
  backproject_rect_kernel<<<dim3(kCluster, n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(weights),
      static_cast<const int32_t*>(rects), static_cast<float*>(out), h, w, bh,
      bw, vec);
  return static_cast<int>(cudaGetLastError());
}

// frames (n, h, w, 3) u8, rects (n, 4) i32 [x, y, w, h], cur (n, 4096) f32.
// model == nullptr: hist-only, cur = counts of each rect clamped to the
// frame (bh, bw, pdf unused).  Otherwise model (n, 4096) f32, and each
// rect's [x, y] places a (bh, bw) band clipped into the frame
// (1 <= bh <= h, 1 <= bw <= w): cur = the band's counts, pdf (n, bh, bw) f32
// = min(model / cur, 1)[bin].
extern "C" int histpdf_band_launch(const void* frames, const void* rects,
                                   const void* model, void* cur, void* pdf,
                                   int n, int h, int w, int bh, int bw,
                                   void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* r = static_cast<const int32_t*>(rects);
  const auto* m = static_cast<const float*>(model);
  if (model == nullptr) {
    histpdf_band_kernel<false><<<n, kBandThreads, 0, s>>>(
        f, r, m, static_cast<float*>(cur), nullptr, h, w, 0, 0);
  } else {
    histpdf_band_kernel<true><<<n, kBandThreads, 0, s>>>(
        f, r, m, static_cast<float*>(cur), static_cast<float*>(pdf), h, w, bh,
        bw);
  }
  return static_cast<int>(cudaGetLastError());
}
