// Camshift pixel kernels for Hopper (sm_90a): the 4096-bin RGB histogram
// and the ratio-weight backprojection, over a batch of u8 RGB frames.
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
//   - The rect [x, y, w, h] (clamped to the frame) serves the full-frame
//     current histogram and the handoff model histogram of the detection box.
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
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 4096;
constexpr int kThreads = 256;
constexpr int kHistPixelsPerBlock = 8192;
constexpr int kPdfPixelsPerBlock = 16384;

__device__ __forceinline__ int rgb_bin(const uint8_t* px) {
  return (static_cast<int>(px[0] >> 4) << 8) |
         (static_cast<int>(px[1] >> 4) << 4) |
         static_cast<int>(px[2] >> 4);
}

__global__ void __launch_bounds__(kThreads)
hist4096_kernel(const uint8_t* __restrict__ frames,
                const int32_t* __restrict__ rects,
                int32_t* __restrict__ out, int h, int w) {
  __shared__ int32_t hist[kBins];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;

  const int32_t* r = rects + 4 * static_cast<int64_t>(n);
  const int64_t rx = r[0], ry = r[1];
  const int64_t x0 = rx > 0 ? rx : 0;
  const int64_t y0 = ry > 0 ? ry : 0;
  int64_t x1 = rx + r[2];
  int64_t y1 = ry + r[3];
  x1 = x1 < w ? x1 : w;
  y1 = y1 < h ? y1 : h;
  const int64_t rw = x1 > x0 ? x1 - x0 : 0;
  const int64_t rh = y1 > y0 ? y1 - y0 : 0;
  const int64_t npx = rw * rh;
  __syncthreads();

  const uint8_t* f = frames + static_cast<int64_t>(n) * h * w * 3;
  const int lane = threadIdx.x & 31;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kHistPixelsPerBlock;
  int64_t end = start + kHistPixelsPerBlock;
  end = end < npx ? end : npx;
  // `base` is uniform across the block, so every warp runs the same trip
  // count and __match_any_sync sees all 32 lanes.
  for (int64_t base = start; base < end; base += blockDim.x) {
    const int64_t p = base + threadIdx.x;
    int bin = -1;
    if (p < end) {
      const int64_t yy = y0 + p / rw;
      const int64_t xx = x0 + p % rw;
      bin = rgb_bin(f + (yy * w + xx) * 3);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[bin], __popc(peers));
    }
  }
  __syncthreads();

  int32_t* o = out + static_cast<int64_t>(n) * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const int32_t c = hist[i];
    if (c != 0) atomicAdd(&o[i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
backproject_kernel(const uint8_t* __restrict__ frames,
                   const float* __restrict__ weights,
                   float* __restrict__ out, int64_t hw) {
  __shared__ float4 table4[kBins / 4];
  const int n = blockIdx.y;
  const float4* w4 =
      reinterpret_cast<const float4*>(weights + static_cast<int64_t>(n) * kBins);
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) table4[i] = w4[i];
  __syncthreads();
  const float* table = reinterpret_cast<const float*>(table4);

  const uint8_t* f = frames + static_cast<int64_t>(n) * hw * 3;
  float* o = out + static_cast<int64_t>(n) * hw;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kPdfPixelsPerBlock;
  int64_t end = start + kPdfPixelsPerBlock;
  end = end < hw ? end : hw;
  for (int64_t p = start + threadIdx.x; p < end; p += blockDim.x) {
    o[p] = table[rgb_bin(f + p * 3)];
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
