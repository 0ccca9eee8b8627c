// cascade for Hopper (sm_90a): every window of every stream through the BBF
// cascade, and the survivors in window order in a fixed buffer a stream.
//
// It replaces headtrackr_tpu/models/detector.py detect_candidates (with
// _dense_chunk_stacked and _patch_chunk: stage-chunked compaction into tiles
// and one-hot selection matmuls on the TPU) and the port's plain twin
// (ops/detect.py cascade_plain: the stages over the alive windows, one
// boolean compaction and one host read a stage).
//   - Semantics (models/detector.py, the twin's): window m of stream n reads
//     feature pixel (z, x, y) at buf[n][base[m, z] + y * rowstep[m, z] + x']
//     (x' = 2x on the interleaved quarter plane z = 2, else x).  A weak
//     classifier votes alpha[k, 1] iff min(valid positive pixels) > max(valid
//     negative pixels) (fills 255 and 0), else alpha[k, 0]; a stage sums its
//     f32 votes in f64 (exact in any order for these alphas) and rejects the
//     window when the sum is below the f32 threshold.  A survivor's
//     confidence is the f32 of its last stage sum.
//   - Design: two kernels.  cascade_eval: a thread a window, blockIdx.y the
//     stream, through the first kDense stages with early exit (most windows
//     die in those two stages of 4 weak classifiers each; ~0.5% survive on
//     the bench pool); then the warp takes its surviving windows one at a
//     time through the deep stages (up to 564 weak classifiers a stage),
//     its 32 lanes splitting each stage's weak classifiers and summing by
//     shuffles, so a deep window's chain is ~1/32 of a thread's walk.  A
//     warp's survivors go into one 32-bit word of a per-stream bitmap (a
//     ballot, no atomics) and a survivor's confidence into a per-window f32
//     array (only survivors write it).  cascade_compact: a CTA a stream
//     walks the bitmap in order (popcounts, a block scan, then each thread
//     its words' set bits) and
//     writes the first C survivors in window order (scale-major, then
//     row-major: the order that decides detect_best's ties) with their
//     boxes from the tables; overflow = the survivors beyond C.  So the kept
//     set and its order are the twin's for any count of survivors.
//   - Tables (models/detector.py DetectorTables, on the device once): a
//     weak classifier's 10 feature slots as i32 codes z | x' << 2 | y << 8
//     (-1: an empty slot), alpha (K, 2) f32, the thresholds and the stages'
//     ends, base and rowstep (M, 3) i32, the boxes out_x/y/w/h (M,) f32.
//   - Bound: the windows' reads of the first stage (8 weak classifiers'
//     pixels over every window) and the bitmap; little arithmetic.
//
// Each launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 10;  // feature pixels a weak classifier: 5 + 5
constexpr int kDense = 2;   // stages run a thread a window (4 + 4 weak)

__device__ __forceinline__ int pixel(const uint8_t* p, int code, int b0,
                                     int b1, int b2, int r0, int r1, int r2) {
  const int z = code & 3;
  const int x = (code >> 2) & 63;
  const int y = code >> 8;
  const int b = z == 0 ? b0 : (z == 1 ? b1 : b2);
  const int r = z == 0 ? r0 : (z == 1 ? r1 : r2);
  return p[b + y * r + x];
}

// Weak classifier k's vote at the window (b0..b2, r0..r2) of plane p.
__device__ __forceinline__ float vote(const uint8_t* p, const int32_t* feat,
                                      const float* alpha, int k, int b0,
                                      int b1, int b2, int r0, int r1, int r2) {
  const int32_t* f = feat + k * kSlots;
  int pmin = 255, nmax = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int code = __ldg(f + i);
    if (code >= 0) pmin = min(pmin, pixel(p, code, b0, b1, b2, r0, r1, r2));
  }
#pragma unroll
  for (int i = 5; i < kSlots; ++i) {
    const int code = __ldg(f + i);
    if (code >= 0) nmax = max(nmax, pixel(p, code, b0, b1, b2, r0, r1, r2));
  }
  return __ldg(alpha + 2 * k + (pmin > nmax));
}

__global__ void __launch_bounds__(kThreads)
cascade_eval_kernel(const uint8_t* __restrict__ buf, int l_len, int m_len,
                    const int32_t* __restrict__ base,
                    const int32_t* __restrict__ rowstep,
                    const int32_t* __restrict__ feat,
                    const float* __restrict__ alpha,
                    const float* __restrict__ thresh,
                    const int32_t* __restrict__ stage_end, int stages,
                    uint32_t* __restrict__ bits, float* __restrict__ conf,
                    int words) {
  const int64_t n = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint8_t* p = buf + n * l_len;
  bool alive = m < m_len;
  int b0 = 0, b1 = 0, b2 = 0, r0 = 0, r1 = 0, r2 = 0;
  double sum = 0.0;
  if (alive) {
    b0 = __ldg(base + 3 * m), b1 = __ldg(base + 3 * m + 1),
    b2 = __ldg(base + 3 * m + 2);
    r0 = __ldg(rowstep + 3 * m), r1 = __ldg(rowstep + 3 * m + 1),
    r2 = __ldg(rowstep + 3 * m + 2);
    int k = 0;
    for (int s = 0; s < min(stages, kDense); ++s) {  // a thread a window
      sum = 0.0;
      for (const int end = __ldg(stage_end + s); k < end; ++k) {
        sum += static_cast<double>(vote(p, feat, alpha, k, b0, b1, b2, r0,
                                        r1, r2));
      }
      if (sum < static_cast<double>(__ldg(thresh + s))) {
        alive = false;
        break;
      }
    }
  }
  // the deep stages: the warp takes its surviving windows one at a time,
  // its lanes splitting each stage's weak classifiers; the f64 stage sum
  // is exact in any order, so the decision and the confidence are the
  // thread-a-window walk's
  uint32_t todo = __ballot_sync(0xffffffffu, alive && stages > kDense);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const int w0 = __shfl_sync(0xffffffffu, b0, owner);
    const int w1 = __shfl_sync(0xffffffffu, b1, owner);
    const int w2 = __shfl_sync(0xffffffffu, b2, owner);
    const int q0 = __shfl_sync(0xffffffffu, r0, owner);
    const int q1 = __shfl_sync(0xffffffffu, r1, owner);
    const int q2 = __shfl_sync(0xffffffffu, r2, owner);
    bool live = true;
    double total = 0.0;
    int k = __ldg(stage_end + kDense - 1);
    for (int s = kDense; s < stages; ++s) {
      const int end = __ldg(stage_end + s);
      double part = 0.0;
      for (int j = k + lane; j < end; j += 32) {
        part += static_cast<double>(vote(p, feat, alpha, j, w0, w1, w2, q0,
                                         q1, q2));
      }
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      total = __shfl_sync(0xffffffffu, part, 0);  // one value for the warp
      k = end;
      if (total < static_cast<double>(__ldg(thresh + s))) {
        live = false;
        break;
      }
    }
    if (lane == owner) {
      alive = live;
      sum = total;
    }
  }
  if (alive) conf[n * m_len + m] = __double2float_rn(sum);
  const uint32_t ballot = __ballot_sync(0xffffffffu, alive);
  const int word = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (lane == 0 && word < words) bits[n * words + word] = ballot;
}

__global__ void __launch_bounds__(kThreads)
cascade_compact_kernel(const uint32_t* __restrict__ bits,
                       const float* __restrict__ conf, int words, int m_len,
                       const float* __restrict__ ox, const float* __restrict__ oy,
                       const float* __restrict__ ow, const float* __restrict__ oh,
                       int cap, int n_streams, float* __restrict__ out,
                       uint8_t* __restrict__ valid,
                       int32_t* __restrict__ overflow) {
  __shared__ int scan[kThreads];
  const int64_t n = blockIdx.x;
  const int t = threadIdx.x;
  const int per = (words + kThreads - 1) / kThreads;
  const int w0 = min(t * per, words), w1 = min(w0 + per, words);
  const uint32_t* b = bits + n * words;
  int cnt = 0;
  for (int w = w0; w < w1; ++w) cnt += __popc(b[w]);
  scan[t] = cnt;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {  // inclusive scan
    const int v = t >= d ? scan[t - d] : 0;
    __syncthreads();
    scan[t] += v;
    __syncthreads();
  }
  const int total = scan[kThreads - 1];
  int slot = scan[t] - cnt;
  const int64_t plane = static_cast<int64_t>(n_streams) * cap;
  float* o = out + n * cap;
  for (int w = w0; w < w1 && slot < cap; ++w) {
    uint32_t word = b[w];
    while (word && slot < cap) {
      const int m = w * 32 + __ffs(word) - 1;
      word &= word - 1;
      o[slot] = __ldg(ox + m);
      o[plane + slot] = __ldg(oy + m);
      o[2 * plane + slot] = __ldg(ow + m);
      o[3 * plane + slot] = __ldg(oh + m);
      o[4 * plane + slot] = conf[n * m_len + m];
      valid[n * cap + slot] = 1;
      ++slot;
    }
  }
  for (int s = t; s < cap; s += kThreads) {
    if (s >= total) {
      for (int f = 0; f < 5; ++f) o[f * plane + s] = 0.0f;
      valid[n * cap + s] = 0;
    }
  }
  if (t == 0) overflow[n] = max(total - cap, 0);
}

}  // namespace

// buf (n, l_len) u8, base / rowstep (m_len, 3) i32, feat (K, 10) i32, alpha
// (K, 2) f32, thresh (stages,) f32, stage_end (stages,) i32; bits (n,
// words) u32 with words = ceil(m_len / 32), conf (n, m_len) f32 (scratch).
extern "C" int cascade_eval_launch(const void* buf, const void* base,
                                   const void* rowstep, const void* feat,
                                   const void* alpha, const void* thresh,
                                   const void* stage_end, void* bits,
                                   void* conf, int n, int l_len, int m_len,
                                   int stages, void* stream) {
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || m_len <= 0) return 0;
  const int words = (m_len + 31) / 32;
  const dim3 grid((m_len + kThreads - 1) / kThreads, n);
  cascade_eval_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), l_len, m_len,
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(rowstep),
      static_cast<const int32_t*>(feat), static_cast<const float*>(alpha),
      static_cast<const float*>(thresh), static_cast<const int32_t*>(stage_end),
      stages, static_cast<uint32_t*>(bits), static_cast<float*>(conf), words);
  return static_cast<int>(cudaGetLastError());
}

// out (5, n, cap) f32: x, y, width, height, confidence; valid (n, cap) u8;
// overflow (n,) i32.
extern "C" int cascade_compact_launch(const void* bits, const void* conf,
                                      const void* ox, const void* oy,
                                      const void* ow, const void* oh,
                                      void* out, void* valid, void* overflow,
                                      int n, int m_len, int cap, void* stream) {
  if (n <= 0) return 0;
  const int words = (m_len + 31) / 32;
  cascade_compact_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const float*>(conf),
      words, m_len, static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<const float*>(ow),
      static_cast<const float*>(oh), cap, n, static_cast<float*>(out),
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
