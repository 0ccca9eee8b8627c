// The cluster histogram's machinery for Hopper (sm_90a), shared by the
// kernels that count one 4096-bin histogram a stream with a thread-block
// cluster of C CTAs (histpdf.cu: hist4096 and histpdf_band; histbins.cu:
// hist_bins):
//   - each counting CTA zeroes its own 16 KB shared i32 histogram
//     (zero_hist) and adds runs of equal bins to it, one shared atomic a
//     run (Run, count16);
//   - after a cluster barrier (sm90::cluster_sync) each CTA sums its 4096 / C
//     bins over the counting peers through distributed shared memory
//     (reduce_slice: mapa + ld.shared::cluster) and writes them out;
//   - a last cluster barrier keeps every CTA's histogram alive until its
//     peers have read it.
// Integer sums in any order are exact, so no float atomic is needed (F5).
// sm90::launch_cluster launches such a kernel over grid (C, n) in clusters
// of C (sm90.cuh holds the barrier and the launch, which meanshift.cu uses
// too).
// Header only; each .cu that includes it builds on its own.

#pragma once

#include <cstdint>

#include "sm90.cuh"

namespace chist {

constexpr int kBins = 4096;
constexpr int kMaxCluster = 16;

// A thread's pending run of equal bins, added to the histogram when the bin
// changes and at the end.
struct Run {
  int bin = -1;
  int count = 0;

  __device__ __forceinline__ void add(int b, int32_t* hist) {
    if (b == bin) {
      ++count;
    } else {
      if (count) atomicAdd(&hist[bin], count);
      bin = b;
      count = 1;
    }
  }
  __device__ __forceinline__ void flush(int32_t* hist) {
    if (count) atomicAdd(&hist[bin], count);
  }
};

// Add one unit's 16 bins (-1: none) to the histogram through the thread's
// run.  (tools/torch_histpdf_variants.py swaps this body, in its builds of
// histpdf.cu, for warp-collective orders, which histpdf.cu's block-uniform
// count_rows loop allows.)
__device__ __forceinline__ void count16(const int (&b)[16], Run& run,
                                        int32_t* hist) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (b[j] >= 0) run.add(b[j], hist);
  }
}

// Zero this CTA's 16 KB histogram (16-byte aligned) before any thread
// counts into it.
__device__ __forceinline__ void zero_hist(int32_t* hist) {
  int4* h4 = reinterpret_cast<int4*>(hist);
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) {
    h4[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
}

// This CTA's slice of the bins, [rank 4096 / c, (rank + 1) 4096 / c),
// summed over the histograms of the cluster's first `active` CTAs, four
// bins at a time: f(bin, counts of bin .. bin + 3).
template <class F>
__device__ __forceinline__ void reduce_slice(const int32_t* hist, int c,
                                             uint32_t rank, int active,
                                             F&& f) {
  const int slice = kBins / c;
  const int lo = static_cast<int>(rank) * slice;
  for (int i = threadIdx.x; i < slice / 4; i += blockDim.x) {
    int4 k = make_int4(0, 0, 0, 0);
    for (int p = 0; p < active; ++p) {
      const int4 v =
          sm90::ld_cluster_v4(sm90::map_rank(hist + lo + 4 * i, p));
      k.x += v.x;
      k.y += v.y;
      k.z += v.z;
      k.w += v.w;
    }
    f(lo + 4 * i, k);
  }
}

// n streams (the grid's y, at most 65,535) in clusters of c CTAs, c a power
// of two <= 16 (so that 4096 / c bins split into whole int4s).
inline bool cluster_ok(int n, int c) {
  return n <= 65535 && c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0;
}

}  // namespace chist
