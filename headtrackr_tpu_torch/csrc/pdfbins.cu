// The 4096-bin weight lookup of precomputed i32 bin ids, one table per
// stream, with its range check, for Hopper (sm_90a).
//
// pdf_bins replaces headtrackr_tpu/kernels/histpdf.py:123 pdf_pallas
// (_pdf_kernel) given bin ids, the reference's own K2 entry point
// (kernels.pdf_pallas here; backproject and backproject_rect take u8 RGB
// frames instead).  The TPU kernel splits the f32 table into three bf16
// planes and selects each pixel's weight with one-hot MXU products; an id
// outside [0, 4096) matches no one-hot row and looks up 0.  On Hopper the
// lookup is a load, so:
//   - Semantics: out[n, i] = weights[n, bins[n, i]] where 0 <= bins[n, i]
//     < 4096, else +0.0f.  No float arithmetic: bit-equal to the plain twin
//     (ops/histogram.py pdf_bins_plain), -0.0 and denormal weights too.
//   - Bound: bytes.  One read of a 4-byte id and one write of a 4-byte
//     float an id, and the 16 KB table a stream: 0.0482 ms at 256 streams
//     of 76,800 ids on an H100 SXM (3.35 TB/s).
//   - What held the first route back (take_along on the clamped ids, then
//     four elementwise passes for the range check and the select): six
//     device operations, ~0.75 GB moved at 256 streams where one pass moves
//     0.16 GB, and a 64-bit divide and modulo an element.
//   - Design: grid (C, N), C CTAs a stream (kernels/pdfbins.py pdf_split:
//     four waves of CTAs split over the streams, at least 2,048 ids a
//     CTA, so one stream of 76,800 ids still spreads over 38 SMs; 16 CTAs
//     a stream at 256 streams).  A CTA stages
//     its stream's table in shared memory with float4 loads (the 4 MB of
//     tables at 256 streams are re-read from L2), then takes its share of
//     the row's 16-byte vectors: int4 loads of ids that skip L1
//     (ld.global.nc.L1::no_allocate), four issued before the first is
//     used; four lookups; a float4 streaming store (st.global.cs).  The
//     range check is one unsigned compare in registers: every lookup reads
//     table[id & 4095], so no load leaves the table, and an id outside the
//     range selects +0.0f.  Offsets are 64-bit and nothing is divided an
//     element.
//   - Edges, in the same kernel: the ids before the row's first 16-byte
//     boundary and after its last whole vector (fewer than 4 each: a P
//     that is not a multiple of 4, or ids that are a view at an odd
//     offset) are CTA 0's, one id a thread.  The output's address equals
//     the ids' modulo 16 bytes (the wrapper allocates it so), so a row's
//     ids and outputs reach 16-byte boundaries together.  A row's vectors
//     are split over its CTAs as hist_bins splits them
//     (kernels/histbins.py id_shares mirrors the split).
//
// The launcher runs on the caller's stream, allocates nothing and returns
// the CUDA error of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 4096;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before its first lookup

// 16 bytes of ids that are read once: not kept in L1.
__device__ __forceinline__ int4 ld_once(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The weight of one id: the table's entry, or +0.0f outside [0, 4096).
__device__ __forceinline__ float look(const float* table, int32_t id) {
  const float w = table[id & (kBins - 1)];
  return static_cast<uint32_t>(id) < static_cast<uint32_t>(kBins) ? w : 0.0f;
}

// grid (C, N): CTA k of stream n looks up its share of the row's p ids.
__global__ void __launch_bounds__(kThreads)
pdf_bins_kernel(const int32_t* __restrict__ bins,
                const float* __restrict__ weights, float* __restrict__ out,
                int p) {
  __shared__ float4 table4[kBins / 4];
  const int n = blockIdx.y;
  const int k = blockIdx.x;
  const int c = gridDim.x;
  const int64_t at = static_cast<int64_t>(n) * p;
  const int32_t* row = bins + at;
  float* o = out + at;
  // ids before the row's first 16-byte boundary (the row is 4-byte aligned)
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2);
  head = head < p ? head : p;
  const int nvec = (p - head) >> 2;
  const int active = nvec < c ? (nvec > 1 ? nvec : 1) : c;
  if (k >= active) return;

  const float4* w4 = reinterpret_cast<const float4*>(
      weights + static_cast<int64_t>(n) * kBins);
  for (int i = threadIdx.x; i < kBins / 4; i += kThreads) table4[i] = w4[i];
  __syncthreads();
  const float* table = reinterpret_cast<const float*>(table4);

  const int v0 = static_cast<int>(static_cast<int64_t>(k) * nvec / active);
  const int v1 = static_cast<int>(static_cast<int64_t>(k + 1) * nvec / active);
  const int4* iv = reinterpret_cast<const int4*>(row + head);
  float4* ov = reinterpret_cast<float4*>(o + head);
  for (int base = v0 + threadIdx.x; base < v1; base += kUnroll * kThreads) {
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      q[u] = v < v1 ? ld_once(iv + v) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      if (v < v1) {
        __stcs(ov + v, make_float4(look(table, q[u].x), look(table, q[u].y),
                                   look(table, q[u].z), look(table, q[u].w)));
      }
    }
  }
  if (k == 0 && threadIdx.x < 8) {
    // threads 0-3: the head's ids; 4-7: the ids after the last whole vector
    const int t = threadIdx.x;
    const int i = t < 4 ? t : head + 4 * nvec + t - 4;
    if (t < 4 ? i < head : i < p) o[i] = look(table, __ldg(row + i));
  }
}

}  // namespace

// bins (n, p) i32 (4-byte aligned, p < 2^31), weights (n, 4096) f32
// (16-byte aligned), out (n, p) f32 at the same address modulo 16 as bins:
// out = weights[bin], +0.0f for an id outside [0, 4096).  c CTAs a row
// (c >= 1; n <= 65,535: the caller splits larger batches).
extern "C" int pdf_bins_launch(const void* bins, const void* weights,
                               void* out, int n, int p, int c, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  const auto b = reinterpret_cast<uintptr_t>(bins);
  const auto o = reinterpret_cast<uintptr_t>(out);
  if (n > 65535 || c < 1 || b % 4 != 0 || b % 16 != o % 16 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pdf_bins_kernel<<<dim3(c, n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(weights),
      static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
