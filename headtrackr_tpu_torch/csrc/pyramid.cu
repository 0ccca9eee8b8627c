// pyramid for Hopper (sm_90a): the detector's packed plane buffer, straight
// from the gray frames.
//
// It replaces headtrackr_tpu/ops/imageproc.py resize_bilinear and
// build_pyramid (the ~120 resizes of a detection pyramid, each ~23 PyTorch
// operations in the plain twin) together with the packing of the planes
// into one flat u8 buffer a stream (ops/imageproc.py pack_pyramid):
//   - Semantics: the defined drawImage of ops/imageproc.py: an output pixel
//     (r, c) of a job's [0, dh) x [0, dw) region is
//       top = s[y0, x0] * gx + s[y0, x1] * fx
//       bot = s[y1, x0] * gx + s[y1, x1] * fx
//       v   = top * gy + bot * fy
//     in f32, every product and sum rounded on its own (no fused
//     multiply-add: __fmul_rn / __fadd_rn), clamped to [0, 255] and
//     rounded half to even to u8; the rest of the plane is 0.  The grids
//     (x0, x1, gx = 1 - fx, fx and the rows' likewise) come from the host
//     (ops/imageproc.py _grid, NumPy f32), so the planes are the twin's to
//     the bit.
//   - Plan (ops/imageproc.py pyramid_plan): a job writes one output plane,
//     either to the scratch of intermediate levels or to the packed buffer
//     (row stride and column step given, so the quarter planes land
//     pixel-interleaved).  Level i reads level i - next, so the jobs come in
//     generations that read only the frame or the generation before: one
//     launch a generation, in order on the stream (6 at 240x320).
//   - Design: a thread an output pixel of the generation's jobs, blockIdx.y
//     the stream; a block copies its generation's job rows into shared
//     memory and finds a pixel's job by binary search on the jobs' first
//     pixels.  Consecutive threads write consecutive pixels of a plane.
//   - Bound: bytes.  A pixel reads four source bytes (mostly from L2: a
//     stream's levels are ~0.75 MB at 240x320) and writes one.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 13;      // PyramidPlan.jobs columns (JOB_COLS)
constexpr int kMaxJobs = 64;   // jobs a generation (36 at 480x640)

enum {
  kSrc, kSrcW, kOutW, kOutH, kDw, kDh, kXt, kYt, kDst, kOff, kRow, kCol,
  kStart
};

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const uint8_t* __restrict__ gray, uint8_t* __restrict__ scratch,
               uint8_t* __restrict__ packed, const int32_t* __restrict__ jobs,
               const int32_t* __restrict__ xi, const float* __restrict__ xf,
               const int32_t* __restrict__ yi, const float* __restrict__ yf,
               int njobs, int pixels, int hw, int s_len, int l_len) {
  __shared__ int32_t job[kMaxJobs * kCols];
  for (int i = threadIdx.x; i < njobs * kCols; i += kThreads) {
    job[i] = __ldg(jobs + i);
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= pixels) return;
  int lo = 0, hi = njobs - 1;  // the last job whose first pixel is <= p
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (job[mid * kCols + kStart] <= p) lo = mid; else hi = mid - 1;
  }
  const int32_t* j = job + lo * kCols;
  const int q = p - j[kStart];
  const int r = q / j[kOutW];
  const int c = q - r * j[kOutW];
  const int64_t n = blockIdx.y;
  const uint8_t* frame = gray + n * hw;
  uint8_t v = 0;
  if (j[kSrc] == -2) {  // level 0: the frame itself
    v = frame[r * j[kSrcW] + c];
  } else if (r < j[kDh] && c < j[kDw]) {
    const uint8_t* s = j[kSrc] == -1 ? frame
                                     : scratch + n * s_len + j[kSrc];
    const int sw = j[kSrcW];
    const int xr = j[kXt] + c, yr = j[kYt] + r;
    const int x0 = __ldg(xi + 2 * xr), x1 = __ldg(xi + 2 * xr + 1);
    const int y0 = __ldg(yi + 2 * yr), y1 = __ldg(yi + 2 * yr + 1);
    const float gx = __ldg(xf + 2 * xr), fx = __ldg(xf + 2 * xr + 1);
    const float gy = __ldg(yf + 2 * yr), fy = __ldg(yf + 2 * yr + 1);
    const float top = __fadd_rn(__fmul_rn(float(s[y0 * sw + x0]), gx),
                                __fmul_rn(float(s[y0 * sw + x1]), fx));
    const float bot = __fadd_rn(__fmul_rn(float(s[y1 * sw + x0]), gx),
                                __fmul_rn(float(s[y1 * sw + x1]), fx));
    float val = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
    val = fminf(fmaxf(val, 0.0f), 255.0f);
    v = static_cast<uint8_t>(__float2int_rn(val));
  }
  uint8_t* dst = j[kDst] == 0 ? scratch + n * s_len : packed + n * l_len;
  dst[j[kOff] + r * j[kRow] + c * j[kCol]] = v;
}

}  // namespace

// One generation of the plan: gray (n, h, w) u8, scratch (n, s_len) u8,
// packed (n, l_len) u8, jobs (njobs, 13) i32 (this generation's rows),
// xi / yi (., 2) i32, xf / yf (., 2) f32; pixels: the generation's output
// pixels a stream.
extern "C" int pyramid_launch(const void* gray, void* scratch, void* packed,
                              const void* jobs, const void* xi,
                              const void* xf, const void* yi, const void* yf,
                              int njobs, int pixels, int n, int hw, int s_len,
                              int l_len, void* stream) {
  if (njobs < 1 || njobs > kMaxJobs || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || pixels <= 0) return 0;
  const dim3 grid((pixels + kThreads - 1) / kThreads, n);
  pyramid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gray), static_cast<uint8_t*>(scratch),
      static_cast<uint8_t*>(packed), static_cast<const int32_t*>(jobs),
      static_cast<const int32_t*>(xi), static_cast<const float*>(xf),
      static_cast<const int32_t*>(yi), static_cast<const float*>(yf), njobs,
      pixels, hw, s_len, l_len);
  return static_cast<int>(cudaGetLastError());
}
