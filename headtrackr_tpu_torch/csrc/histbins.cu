// The 4096-bin histogram of precomputed i32 bin ids, one per stream, for
// Hopper (sm_90a).
//
// hist_bins replaces tools/kernel_experiments.py:257 mk_call(hist_k5) (the
// kernel body at :239).  The TPU kernel compares each block of a stream's
// bin ids with hi/lo iotas into bf16 one-hots and contracts them on the MXU
// into a (64, 64) count matrix.  An id outside [0, 4096) matches no row, so
// it counts nowhere (the -1 and -64 pads of headtrackr_tpu/kernels/
// histpdf.py).  Here the native form is a shared-memory histogram:
//   - Bound: bytes.  One read of the ids, 4 bytes each (307 KB per 320x240
//     stream), and one write of the 16 KB of counts; the work per id is a
//     compare and one shared-memory atomic.
//   - Design: a grid of (blocks per stream, streams).  Each block counts a
//     contiguous slice of its stream's row into a private 16 KB shared u32
//     histogram.  Each thread loads 16 bytes (4 ids) at a time, neighbouring
//     threads on neighbouring addresses, two loads in flight; the ids before
//     the row's first 16-byte boundary and after its last whole vector (a
//     row of P % 4 != 0 ids, or a row that starts off the boundary) are
//     loaded one by one by block 0.  Ids outside [0, 4096) are dropped.
//   - Contention: camera-like bins fall on a few addresses (a flat
//     background, a 2-3-bin face).  Each warp aggregates first
//     (__match_any_sync): one atomic per distinct id in the warp, adding the
//     peer count, instead of up to 32 serialized atomics on one address.
//   - Flush: each block adds its nonzero bins into an i32 (N, 4096) buffer
//     with global integer atomics, exact in any order; a second kernel
//     converts the counts to f32.  No float atomics.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// the first CUDA error of its calls.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 4096;
constexpr int kThreads = 512;
constexpr int kUnroll = 2;  // 16-byte loads in flight per thread

// Count one id per lane (every lane of the warp calls it).
__device__ __forceinline__ void count_id(int id, unsigned* hist, int lane) {
  const int bin = static_cast<unsigned>(id) < kBins ? id : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
hist_bins_kernel(const int32_t* __restrict__ bins, int32_t* __restrict__ counts,
                 int64_t p, int64_t vec_per_block) {
  __shared__ unsigned hist[kBins];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int32_t* row = bins + static_cast<int64_t>(n) * p;
  // ids before the row's first 16-byte boundary (the row is 4-byte aligned)
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2;
  head = head < p ? head : p;
  const int64_t nvec = (p - head) >> 2;
  const int4* vec = reinterpret_cast<const int4*>(row + head);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * vec_per_block;
  int64_t v1 = v0 + vec_per_block;
  v1 = v1 < nvec ? v1 : nvec;
  // the bound is uniform across the block, so every lane of a warp runs
  // the same trip count and __match_any_sync sees all 32
  for (int64_t base = v0; base < v1;
       base += static_cast<int64_t>(kUnroll) * blockDim.x) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * blockDim.x + threadIdx.x;
      v[u] = i < v1 ? __ldg(vec + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count_id(v[u].x, hist, lane);
      count_id(v[u].y, hist, lane);
      count_id(v[u].z, hist, lane);
      count_id(v[u].w, hist, lane);
    }
  }
  // the scalar ids, at most 3 + 3: warp 0 of block 0, one id per lane
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int64_t tail0 = head + 4 * nvec;
    const int64_t t = threadIdx.x;
    int id = -1;
    if (t < head) {
      id = row[t];
    } else if (t - head < p - tail0) {
      id = row[tail0 + t - head];
    }
    count_id(id, hist, lane);
  }
  __syncthreads();

  int32_t* o = counts + static_cast<int64_t>(n) * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const unsigned c = hist[i];
    if (c != 0) atomicAdd(&o[i], static_cast<int32_t>(c));
  }
}

__global__ void counts_to_f32_kernel(const int32_t* __restrict__ counts,
                                     float* __restrict__ out, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total) out[i] = static_cast<float>(counts[i]);  // round to nearest
}

}  // namespace

// bins (n, p) i32, 4-byte aligned rows (p < 2^31); counts (n, 4096) i32
// scratch; out (n, 4096) f32 = the count of each id of [0, 4096) in each row.
// blocks: blocks per stream (>= 1), each taking an even share of the row's
// 16-byte vectors.
extern "C" int hist_bins_launch(const void* bins, void* counts, void* out,
                                int n, int p, int blocks, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(n) * kBins;
  cudaError_t err = cudaMemsetAsync(counts, 0, total * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t vecs = (static_cast<int64_t>(p) + 3) / 4;
  int64_t per = (vecs + blocks - 1) / blocks;
  per = per > 0 ? per : 1;
  hist_bins_kernel<<<dim3(blocks, n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(bins), static_cast<int32_t*>(counts), p, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_to_f32_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const int32_t*>(counts), static_cast<float*>(out), total);
  return static_cast<int>(cudaGetLastError());
}
