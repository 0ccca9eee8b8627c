// take_along for Hopper (sm_90a): a batched gather along one axis of a
// (B, S, L) f32 array, torch.take_along_dim's function.
//
// It replaces tools/kernel_experiments.py::ta_call (k8), the take_along_axis
// probe: (8, 128) f32 rows gathered with (8, 128) i32 lane indices.  On the
// TPU the question was whether Mosaic lowers a lane gather at all; for want
// of one, the JAX package's mean shift selects its prefix-sum lines with
// one-hot matmuls (headtrackr_tpu/models/camshift.py::_select_lines).  On
// Hopper a gather is an indexed load:
//   - Semantics: dim 2: out (B, S, K), out[b, i, j] = src[b, i, idx[b, i, j]]
//     with idx (B, S, K), or (B, 1, K) broadcast over the rows.  dim 1:
//     out (B, K, L), out[b, i, j] = src[b, idx[b, i, j], j] with idx
//     (B, K, L), or (B, K, 1) broadcast over the columns.  Indices must lie
//     in [0, S) (dim 1) or [0, L) (dim 2): the callers clamp them, and the
//     kernel does not check.
//   - Bound: bytes.  Each output element reads one index and one source
//     element and writes one float; there is no arithmetic.  On the
//     mean-shift path it served (meanshift.cu has taken that step whole)
//     the arrays were two lines of a prefix-sum plane per stream, so a
//     launch moved a few hundred KB and its latency dominated.
//   - Design: one thread per output element, consecutive threads on
//     consecutive outputs, so the writes coalesce; a dim-1 gather (rows of
//     the plane) reads whole rows, coalesced too.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kDim>
__global__ void take_along_kernel(const float* __restrict__ src,
                                  const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int64_t total,
                                  int s, int l, int k, bool idx_full) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  if (kDim == 2) {
    // o = (b * s + i) * k + j; bi = b * s + i is also src's row
    const int64_t j = o % k;
    const int64_t bi = o / k;
    const int64_t at = idx_full ? o : (bi / s) * k + j;
    out[o] = src[bi * l + __ldg(idx + at)];
  } else {
    // o = (b * k + i) * l + j; bi = b * k + i is also idx's broadcast row
    const int64_t j = o % l;
    const int64_t bi = o / l;
    const int64_t at = idx_full ? o : bi;
    out[o] = src[((bi / k) * s + __ldg(idx + at)) * l + j];
  }
}

}  // namespace

// src (b, s, l) f32, idx i32 (dim 2: (b, s or 1, k); dim 1: (b, k, l or 1)),
// out (b, s, k) for dim 2 and (b, k, l) for dim 1, all contiguous.
// idx_full: idx spans the other non-batch axis (else it has size 1 there).
extern "C" int take_along_launch(const void* src, const void* idx, void* out,
                                 int b, int s, int l, int dim, int k,
                                 int idx_full, void* stream) {
  if (dim != 1 && dim != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total =
      static_cast<int64_t>(b) * k * (dim == 2 ? s : l);
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float*>(src);
  const auto* ip = static_cast<const int32_t*>(idx);
  auto* op = static_cast<float*>(out);
  if (dim == 2) {
    take_along_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        sp, ip, op, total, s, l, k, idx_full != 0);
  } else {
    take_along_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        sp, ip, op, total, s, l, k, idx_full != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
