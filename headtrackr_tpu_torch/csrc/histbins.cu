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
//     compare and at most one shared-memory atomic.
//   - What held the first design back (blocks flushed by global atomics
//     into a zero-filled i32 buffer, then a cast; a warp match of every
//     id): ~2M global atomics at 256 streams of random ids, a memset and a
//     cast launch a call, and one __match_any_sync an id, the order that
//     took hist4096 0.176 ms against 0.048 for per-thread runs (NVIDIA
//     H100 80GB HBM3 at 700 W, PERF.md).
//   - Design: hist4096's cluster histogram (cluster_hist.cuh) with an i32
//     loader.  A thread-block cluster of C CTAs a row (C from
//     kernels/histbins.py split_bins: 2 at 256 streams, 16 at one); CTA k
//     counts a contiguous share of the row's 16-byte vectors into its own
//     16 KB shared i32 histogram; after a cluster barrier each CTA sums its
//     4096 / C bins over the counting peers through distributed shared
//     memory and writes them as f32 straight to the output.  One launch a
//     call: no global atomics, no memset, no scratch, no cast; integer sums
//     in any order are exact, so the counts are bit-equal to the twin.
//   - What paces it (NVIDIA H100 80GB HBM3 at 700 W, PERF.md,
//     tools/torch_histbins_variants.py): as hist4096, each CTA's fixed cost,
//     so few long CTAs win once the card is full: at 256 rows of 76,800
//     random ids C = 2 took 0.034 ms (1.4x the bound), C = 1 0.042 and
//     C = 16 0.067; 512 threads a CTA 0.043.
//
// A CTA's share is dealt to its threads in units of 16 ids: four 16-byte
// loads, all issued before the first is used.  The ids before the row's
// first 16-byte boundary and after its last whole vector (fewer than 4
// each: a row of P % 4 != 0 ids, or a row that starts off the boundary) are
// one more unit of CTA 0, their loads issued together too.  A thread adds
// its ids through its run of equal bins, carried across its units, one
// shared atomic a run (count16); an id outside [0, 4096) is dropped without
// ending the run.  The shares: the row's vectors split evenly over its
// first `active` = min(C, vectors) CTAs (at least one); kernels/histbins.py
// id_shares mirrors the split.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// the CUDA error of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_hist.cuh"
#include "sm90.cuh"

namespace {

using chist::kBins;
constexpr int kThreads = 256;

__device__ __forceinline__ int bin_of(int id) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(kBins) ? id : -1;
}

// grid (C, N), one cluster of C CTAs a row of p ids (a power of two <= 16).
__global__ void __launch_bounds__(kThreads)
hist_bins_kernel(const int32_t* __restrict__ bins, float* __restrict__ out,
                 int p) {
  __shared__ alignas(16) int32_t hist[kBins];
  const int n = blockIdx.y;
  const int c = gridDim.x;
  const int rank = static_cast<int>(sm90::cluster_rank());
  const int32_t* row = bins + static_cast<int64_t>(n) * p;
  // ids before the row's first 16-byte boundary (the row is 4-byte aligned)
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2);
  head = head < p ? head : p;
  const int nvec = (p - head) >> 2;
  const int tail = head + 4 * nvec;  // the ids after the last whole vector
  const int active = nvec < c ? (nvec > 1 ? nvec : 1) : c;

  if (rank < active) {
    chist::zero_hist(hist);
    const int v0 =
        static_cast<int>(static_cast<int64_t>(rank) * nvec / active);
    const int v1 =
        static_cast<int>(static_cast<int64_t>(rank + 1) * nvec / active);
    const int4* vec = reinterpret_cast<const int4*>(row + head);
    const int units = (v1 - v0 + 3) / 4 + (rank == 0 ? 1 : 0);
    chist::Run run;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      int b[16];
      const int i = v0 + 4 * u;
      if (i < v1) {
        int4 q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          q[k] = i + k < v1 ? __ldg(vec + i + k) : make_int4(-1, -1, -1, -1);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          b[4 * k] = bin_of(q[k].x);
          b[4 * k + 1] = bin_of(q[k].y);
          b[4 * k + 2] = bin_of(q[k].z);
          b[4 * k + 3] = bin_of(q[k].w);
        }
      } else {
        // CTA 0's last unit: the head's and the tail's ids (< 4 each)
        int id[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          id[j] = j < head ? __ldg(row + j) : -1;
          id[4 + j] = tail + j < p ? __ldg(row + tail + j) : -1;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          b[j] = bin_of(id[j]);
          b[8 + j] = -1;
        }
      }
      chist::count16(b, run, hist);
    }
    run.flush(hist);
  }
  // every CTA's counts are in its shared memory, visible to the cluster
  sm90::cluster_sync();

  // this CTA's slice of the bins, summed over the counting peers
  float* o = out + static_cast<int64_t>(n) * kBins;
  chist::reduce_slice(hist, c, static_cast<uint32_t>(rank), active,
                      [&](int bin, int4 k) {
                        *reinterpret_cast<float4*>(o + bin) =
                            make_float4(k.x, k.y, k.z, k.w);
                      });
  // no peer reads this CTA's histogram any more
  sm90::cluster_sync();
}

}  // namespace

// bins (n, p) i32 with 4-byte aligned rows (p < 2^31), out (n, 4096) f32
// (16-byte aligned) = the count of each id of [0, 4096) in each row.  One
// cluster of c CTAs a row (c a power of two, at most 16; n <= 65,535: the
// caller splits larger batches).
extern "C" int hist_bins_launch(const void* bins, void* out, int n, int p,
                                int c, void* stream) {
  if (n <= 0) return 0;
  if (!chist::cluster_ok(n, c) || p < 0 ||
      reinterpret_cast<uintptr_t>(bins) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sm90::launch_cluster(hist_bins_kernel, dim3(c, n), c, kThreads, 0,
                              static_cast<cudaStream_t>(stream),
                              static_cast<const int32_t*>(bins),
                              static_cast<float*>(out), p);
}
