// handoff for Hopper (sm_90a): the VJ -> CS handoff of each served stream
// in one launch, the model histogram of the detection's rect and the
// bandHist handoff audit among it.
//
// It replaces no Pallas kernel.  The reference leaves the work to XLA:
// headtrackr_tpu/models/camshift.py:133 init_tracker (the rect's
// histogram) with :113 handoff_band_audit (a full-frame lookup of the
// model-bin indicator, masked to the band's complement, reduced by any),
// and the handoff of headtrackr_tpu/models/facetracker.py:197-216 (the
// found-masked result, the switch, the floored rect, the select of the new
// camshift state, the new mode).  In the port those were a histogram
// launch, a full-frame backprojection of a 0/1 table, ~15 operations of
// the audit and a select per leaf.  Its twin is ops/handoff.py
// handoff_plain.
//   - Bound: bytes.  A switching stream reads its rect's pixels and, with
//     the audit, the frame outside the band until the first model-colored
//     pixel (the whole frame outside the band, 230 KB less the band's,
//     where none is), and writes its 16 KB histogram row; any other stream
//     copies its 16 KB row.  The arithmetic is a shift and a shared atomic
//     a rect pixel, a bit test a frame pixel.
//   - Design: a CTA a stream (grid x: no limit of 65,535 streams).  One
//     thread takes the detection's result, the switch and the rect.  A
//     stream that does not switch copies its camshift rows and is done.
//     One that switches counts the rect (clamped as histpdf_band's
//     hist-only mode clamps it, band.cuh clamped_rect) into a 16 KB shared
//     i32 histogram with integer atomics (F5: exact in any order), writes
//     it as f32 and, with the audit, builds the 4096-bit model-bin mask
//     (512 B) from it, places the band for the rect by the one placement
//     rule (band.cuh place_band: models/camshift.py band_rect) and scans
//     the frame outside it a warp a row, a lane a column, stopping at the
//     first masked pixel (a shared flag read each row).  An empty rect (a
//     VJ miss) counts nothing, so its mask is empty and band_dirty False.
//   - The frame's row is min(slot, N - 1): a slot of N is padding, whose
//     result the caller drops.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 4096;
constexpr int kModeVJ = 1, kModeCS = 2;
constexpr float kThreshold = -10.0f;  // src/facetrackr.js:57
constexpr float kNoConf = -10000.0f;

// An input read where it lies: element i at p + i * s.
struct Plane {
  const void* p;
  long long s;
};

// kernels/handoff.py _Args mirrors it field for field.
struct Args {
  const uint8_t* frames;
  long long n, h, w;
  const long long* slots;       // (S,) or null: row s
  const int32_t* rect;          // the init form's (S, 4) rects, else null
  Plane found, x, y, bw, bh, conf;  // the handoff form's detection
  const int32_t* entry_mode;    // (S,)
  const int32_t* mode_in;       // (S,)
  int32_t* mode_out;            // (S,)
  const float* old_hist;        // (S, 4096)
  const int32_t* old_win;       // (S, 4)
  const int32_t* old_track[4];  // (S,) x, y, w, h
  const float* old_angle;       // (S,)
  const uint8_t* old_dirty;     // (S,) or null
  float* hist;                  // (S, 4096)
  int32_t* win;                 // (S, 4)
  int32_t* track[4];            // (S,)
  float* angle;                 // (S,)
  uint8_t* dirty;               // (S,) or null: no audit
  float* res[6];                // (S,) x, y, w, h, angle, conf
  int band_h, band_w;           // the audit's band
};

__device__ __forceinline__ float plane_f(const Plane& p, long long i) {
  return static_cast<const float*>(p.p)[i * p.s];
}

__device__ __forceinline__ int rgb_bin(const uint8_t* px) {
  return (static_cast<int>(px[0] >> 4) << 8) |
         (static_cast<int>(px[1] >> 4) << 4) | static_cast<int>(px[2] >> 4);
}

__global__ void __launch_bounds__(kThreads) handoff_kernel(Args a) {
  __shared__ int32_t hist[kBins];
  __shared__ uint32_t mask[kBins / 32];
  __shared__ int32_t rect[4];
  __shared__ int sw;
  __shared__ int flag;
  const long long s = blockIdx.x;
  const int t = threadIdx.x;
  long long row = a.slots ? a.slots[s] : s;
  row = row < a.n - 1 ? row : a.n - 1;
  const int h = static_cast<int>(a.h), w = static_cast<int>(a.w);
  const uint8_t* f = a.frames + row * a.h * a.w * 3;
  if (t == 0) {
    if (a.rect) {
      for (int i = 0; i < 4; ++i) rect[i] = a.rect[4 * s + i];
      sw = 1;
    } else {
      const bool found =
          static_cast<const uint8_t*>(a.found.p)[s * a.found.s] != 0;
      const float conf = found ? plane_f(a.conf, s) : kNoConf;
      const float box[4] = {found ? plane_f(a.x, s) : 0.0f,
                            found ? plane_f(a.y, s) : 0.0f,
                            found ? plane_f(a.bw, s) : 0.0f,
                            found ? plane_f(a.bh, s) : 0.0f};
      const bool vj = a.entry_mode[s] == kModeVJ;
      sw = vj && conf > kThreshold;
      for (int i = 0; i < 4; ++i) {
        rect[i] = static_cast<int32_t>(floorf(box[i]));
        a.res[i][s] = vj ? box[i] : 0.0f;
      }
      a.res[4][s] = 0.0f;
      a.res[5][s] = vj ? conf : kNoConf;
      a.mode_out[s] = vj ? (sw ? kModeCS : kModeVJ) : a.mode_in[s];
    }
  }
  __syncthreads();
  float* out = a.hist + s * kBins;
  if (!sw) {  // the stream keeps its camshift rows
    const float* old = a.old_hist + s * kBins;
    for (int i = t; i < kBins; i += kThreads) out[i] = old[i];
    if (t < 4) a.win[4 * s + t] = a.old_win[4 * s + t];
    if (t >= 4 && t < 8) a.track[t - 4][s] = a.old_track[t - 4][s];
    if (t == 8) a.angle[s] = a.old_angle[s];
    if (t == 9 && a.dirty) a.dirty[s] = a.old_dirty[s];
    return;
  }
  for (int i = t; i < kBins; i += kThreads) hist[i] = 0;
  if (t < kBins / 32) mask[t] = 0;
  if (t == 0) flag = 0;
  __syncthreads();
  const int warp = t / 32, lane = t & 31;
  const band::Rect rc = band::clamped_rect(rect, h, w);
  for (long long y = warp; y < rc.rh; y += kWarps) {
    const uint8_t* p = f + ((rc.y0 + y) * w + rc.x0) * 3;
    for (long long x = lane; x < rc.rw; x += 32) {
      atomicAdd(&hist[rgb_bin(p + 3 * x)], 1);
    }
  }
  __syncthreads();
  for (int i = t; i < kBins; i += kThreads) {
    const int32_t c = hist[i];
    out[i] = static_cast<float>(c);
    if (a.dirty && c > 0) atomicOr(&mask[i >> 5], 1u << (i & 31));
  }
  if (t < 4) a.win[4 * s + t] = rect[t];
  if (t >= 4 && t < 8) a.track[t - 4][s] = 0;
  if (t == 8) a.angle[s] = 0.0f;
  if (!a.dirty) return;
  __syncthreads();
  // the audit: a model-colored pixel outside the band placed for the rect
  const band::Rect b = band::place_band(rect, h, w, a.band_h, a.band_w);
  volatile int* seen = &flag;
  for (int y = warp; y < h; y += kWarps) {
    if (*seen) break;
    const bool in_rows = y >= b.y0 && y < b.y0 + b.rh;
    const uint8_t* p = f + static_cast<long long>(y) * w * 3;
    for (int x = lane; x < w; x += 32) {
      if (in_rows && x >= b.x0 && x < b.x0 + b.rw) continue;
      const int bin = rgb_bin(p + 3 * x);
      if ((mask[bin >> 5] >> (bin & 31)) & 1u) {
        *seen = 1;
        break;
      }
    }
  }
  __syncthreads();
  if (t == 0) a.dirty[s] = flag ? 1 : 0;
}

}  // namespace

extern "C" int handoff_args_bytes() { return sizeof(Args); }

// One CTA a stream: ``streams`` of them (S), from ``args`` (Args).
extern "C" int handoff_launch(const void* args, int streams, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (streams < 1 || a.n < 1 || a.h < 1 || a.w < 1 || a.frames == nullptr ||
      (a.dirty && (a.band_h < 1 || a.band_w < 1)) ||
      (a.rect == nullptr && (a.found.p == nullptr || a.old_hist == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  handoff_kernel<<<streams, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
