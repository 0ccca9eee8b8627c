// frame_prep for Hopper (sm_90a): one pass over each served stream's u8
// RGB frame, read through a slot index, giving the grayscale plane the
// detector reads and the whitebalance branch of the state machine.
//
// It replaces no Pallas kernel.  The reference leaves the work to XLA:
// headtrackr_tpu/ops/imageproc.py:35 grayscale and :43 whitebalance, and
// the WB branch of headtrackr_tpu/models/facetracker.py:186-195 (the ring
// push, wb_n, the stability test and the new mode), each its own pass over
// the frames; in the port the served streams' frames were first gathered
// into a sub-batch copy.  Its twin is ops/imageproc.py frame_prep_plain.
//   - Bound: bytes.  Each served stream's frame read once (230 KB at
//     320x240) and its gray plane written once (77 KB); the state rows are
//     a few dozen bytes.  At the relock bucket's 8 streams that is 0.0007
//     ms on an H100 SXM at 3.35 TB/s; the arithmetic is a multiply-add and
//     a division by 100 a pixel.
//   - Design: a CTA a stream (grid x, so no limit of 65,535 streams), its
//     threads over the frame four pixels at a time (three 4-byte loads,
//     one 4-byte gray store) where the frames' rows allow it, else a
//     pixel at a time; exact 64-bit channel sums reduced over the CTA (warp
//     shuffles, then shared memory); one thread then takes the means in
//     f64 and rounds once to f32, every operation an _rn intrinsic in the
//     twin's order ((m_r + m_g) + m_b) / 3 (no contraction), so the value
//     equals the twin's bit for bit in any batch, and writes the stream's
//     ring, wb_n and mode: the WB branch's where the stream enters in WB,
//     its own rows elsewhere.
//   - The frame's row is min(slot, N - 1): a slot of N is padding, whose
//     result the caller drops.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 15;  // PWB_LENGTH
constexpr int kModeWB = 0, kModeVJ = 1;

// kernels/frameprep.py _Args mirrors it field for field.
struct Args {
  const uint8_t* frames;
  long long n, h, w;
  const long long* slots;  // (S,) or null: row s
  const int32_t* mode;     // (S,) entry modes
  const float* ring;       // (S, 15)
  const int32_t* wb_n;     // (S,)
  uint8_t* gray;           // (S, H, W) or null
  float* wb;               // (S,)
  float* ring_out;         // (S, 15)
  int32_t* wb_n_out;       // (S,)
  int32_t* mode_out;       // (S,)
  int wb_vj;               // report wb on VJ streams too (wbtrack)
  int vec;                 // frames and gray allow 4 pixels a thread
};

__device__ __forceinline__ uint32_t gray_of(uint32_t r, uint32_t g,
                                            uint32_t b) {
  return (30u * r + 59u * g + 11u * b + 50u) / 100u;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) frame_prep_kernel(Args a) {
  __shared__ unsigned long long part[kWarps][3];
  const long long s = blockIdx.x;
  long long row = a.slots ? a.slots[s] : s;
  row = row < a.n - 1 ? row : a.n - 1;
  const long long hw = a.h * a.w;
  const uint8_t* f = a.frames + row * hw * 3;
  uint8_t* g = a.gray ? a.gray + s * hw : nullptr;
  unsigned long long sr = 0, sg = 0, sb = 0;
  if (a.vec) {
    const uint32_t* f4 = reinterpret_cast<const uint32_t*>(f);
    uint32_t* g4 = reinterpret_cast<uint32_t*>(g);
    for (long long q = threadIdx.x; q < hw / 4; q += kThreads) {
      const uint32_t w0 = f4[3 * q], w1 = f4[3 * q + 1], w2 = f4[3 * q + 2];
      const uint32_t r0 = w0 & 0xFF, g0 = (w0 >> 8) & 0xFF,
                     b0 = (w0 >> 16) & 0xFF;
      const uint32_t r1 = w0 >> 24, g1 = w1 & 0xFF, b1 = (w1 >> 8) & 0xFF;
      const uint32_t r2 = (w1 >> 16) & 0xFF, g2 = w1 >> 24, b2 = w2 & 0xFF;
      const uint32_t r3 = (w2 >> 8) & 0xFF, g3 = (w2 >> 16) & 0xFF,
                     b3 = w2 >> 24;
      sr += r0 + r1 + r2 + r3;
      sg += g0 + g1 + g2 + g3;
      sb += b0 + b1 + b2 + b3;
      if (g4) {
        g4[q] = gray_of(r0, g0, b0) | (gray_of(r1, g1, b1) << 8) |
                (gray_of(r2, g2, b2) << 16) | (gray_of(r3, g3, b3) << 24);
      }
    }
  } else {
    for (long long p = threadIdx.x; p < hw; p += kThreads) {
      const uint32_t r = f[3 * p], gr = f[3 * p + 1], b = f[3 * p + 2];
      sr += r;
      sg += gr;
      sb += b;
      if (g) g[p] = static_cast<uint8_t>(gray_of(r, gr, b));
    }
  }
  sr = warp_sum(sr);
  sg = warp_sum(sg);
  sb = warp_sum(sb);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = sr;
    part[warp][1] = sg;
    part[warp][2] = sb;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long t[3] = {0, 0, 0};
  for (int i = 0; i < kWarps; ++i) {
    for (int c = 0; c < 3; ++c) t[c] += part[i][c];
  }
  // the twin's order: exact sums, f64 means, ((r + g) + b) / 3, one
  // rounding to f32
  const double d = static_cast<double>(hw);
  const double m0 = __ddiv_rn(static_cast<double>(t[0]), d);
  const double m1 = __ddiv_rn(static_cast<double>(t[1]), d);
  const double m2 = __ddiv_rn(static_cast<double>(t[2]), d);
  const float wb = __double2float_rn(
      __ddiv_rn(__dadd_rn(__dadd_rn(m0, m1), m2), 3.0));
  const int32_t mode = a.mode[s];
  const bool is_wb = mode == kModeWB;
  a.wb[s] = (is_wb || (a.wb_vj && mode == kModeVJ)) ? wb : 0.0f;
  const float* old = a.ring + s * kRing;
  float* ring = a.ring_out + s * kRing;
  if (!is_wb) {
    for (int i = 0; i < kRing; ++i) ring[i] = old[i];
    a.wb_n_out[s] = a.wb_n[s];
    a.mode_out[s] = mode;
    return;
  }
  float v[kRing];
  v[0] = wb;
  for (int i = 1; i < kRing; ++i) v[i] = old[i - 1];
  float hi = v[0], lo = v[0];
  for (int i = 0; i < kRing; ++i) {
    ring[i] = v[i];
    hi = v[i] > hi ? v[i] : hi;
    lo = v[i] < lo ? v[i] : lo;
  }
  const int32_t n = a.wb_n[s] + 1 < kRing ? a.wb_n[s] + 1 : kRing;
  a.wb_n_out[s] = n;
  a.mode_out[s] =
      (n == kRing && __fsub_rn(hi, lo) < 2.0f) ? kModeVJ : kModeWB;
}

}  // namespace

extern "C" int frame_prep_args_bytes() { return sizeof(Args); }

// One CTA a served stream: ``streams`` of them (S), from ``args`` (Args).
extern "C" int frame_prep_launch(const void* args, int streams,
                                 void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (streams < 1 || a.n < 1 || a.h < 1 || a.w < 1 || a.frames == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  frame_prep_kernel<<<streams, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
