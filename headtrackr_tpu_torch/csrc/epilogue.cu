// tick_epilogue for Hopper (sm_90a): the end of a tracker tick, one thread a
// stream, one launch for the batch.
//
// It replaces, on the card, the XLA chain of small operations that ends each
// step of the JAX package (no Pallas kernel): headtrackr_tpu/models/
// camshift.py _finish (with _sqrt_shl2), the "track" variant's freeze of the
// streams not in CS, and headtrackr_tpu/models/facetracker.py full_step's
// supervision (lines 288-397, with models/headpose.py estimate_fov_width and
// track_head).  Its plain twin is ops/epilogue.py.
//   - Forms, by the flags word: kFinish alone is camshift's _finish (size
//     and angle from the central moments, the output box, the 1.1x window
//     growth); kSupervise alone is the supervision after a step's mode
//     branches (status bits, loss and retry, face_found, EMA smoothing, the
//     6-deep head-diagonal ring and its stability gate, FOV caching, head
//     position) on their merged result; kFinish | kFreeze | kSupervise is
//     the "track" step's whole end from the mean shift's outputs.  The
//     configuration's flags and f32 constants come with the launch.
//   - Float order: the twin's, every product, sum, difference, quotient
//     and square root an _rn intrinsic (no fused multiply-add, IEEE
//     division and square root); atan2f, atanf and tanf are the CUDA math
//     library's, which PyTorch's ops call on the card, so the kernel equals
//     the twin run on the card to the bit.  Each f32 constant is the twin's
//     (a Python float rounded to f32 by the wrapper).
//   - Inputs are read where they lie: each (N,) or (N, k) input is a base
//     and a stride between streams (the mean shift's moments are columns of
//     one (N, 12) tensor, its flags of one (N, 2) tensor).  The outputs are
//     one block the wrapper allocates, each row at a place fixed by N
//     (Out); a leaf the step leaves alone is not written (the wrapper
//     passes the input tensor through).
//   - Bound: latency.  A stream reads ~120 B and writes ~160 B.
//   - What held the first design back (one thread a stream, 256 streams a
//     CTA): at 256 streams the batch was one CTA on one SM, and each thread
//     loaded ~40 scalars one by one, many of them behind a branch on an
//     earlier load (the entry mode before the frozen state, diag_n before
//     the ring), so a thread paid several round trips in a chain.
//   - Design: kStreams = 32 streams a CTA of kWarps = 8 warps (8 CTAs at
//     256 streams, 320 at 10,240; the stream stays on grid x, so any N).
//     The CTA first stages every input row of its streams into shared
//     memory, every copy issued before any value is used: warp w takes the
//     inputs q = w, w + 8, ..., each input's rows of the CTA's streams one
//     segment of 16-byte cp.async copies spread over the lanes (the
//     (N, 12) moments, (N, 5) sm_sp and (N, 6) ring rows whole, the bool
//     planes as words), or for an input whose rows lie more than
//     kMaxPitch bytes apart the 4-byte word holding each element; each
//     input has a fixed slot, and the warp writes where its rows start
//     (Meta).  After one barrier the first warp computes a stream a thread
//     from shared memory; a value only some streams use (the FOV at
//     activation, the head position, an edge's correction) is computed
//     only where used.  A copied 16-byte unit always holds a byte of its
//     input, so no copy leaves the input's pages.
//   - What the card taught (tools/torch_epilogue_variants.py, PERF.md):
//     the time went to fetching the kernel's own instructions and
//     parameters, not to the copies.  With the loop over the inputs
//     unrolled and a layout computed by the host, the kernel was ~10K
//     instructions with ~500 constant loads and took longer than the first
//     design; a compact staging loop (each warp's few turns unrolled, the
//     parameters a __grid_constant__ block indexed in place) and the fixed
//     slots brought it to ~2,200.
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sm90.cuh"

namespace {

enum : unsigned {
  kFinish = 1u << 0,        // camshift's _finish from the moments
  kSupervise = 1u << 1,     // the supervision
  kFreeze = 1u << 2,        // "track": streams not in CS keep their state
  kWbtrack = 1u << 3,       // "wbtrack": VJ streams emit no status
  kCalcAngles = 1u << 4,
  kRetry = 1u << 5,         // retryDetection
  kSmoothing = 1u << 6,
  kHeadPosition = 1u << 7,
  kFov = 1u << 8,           // fov given (kFovRad), else estimated
  kEdge = 1u << 9,          // edgecorrection
  kSendEvents = 1u << 10,
  kEscaped = 1u << 11,      // escaped flags given: write esc & in CS
  kDirty = 1u << 12,        // band_dirty ORed into them
};

// the f32 constants (Args::k), each the twin's value
enum {
  kAlpha, kOffset, kFovRad, kDistance, kRad2Deg, kCamW, kCamH, kSin, kCos,
  kTan, kDiagCm, kPi, kHalfPi, kMargin, kWidthCm, kGrowth, kConsts
};
// the inputs (Args::in), in the wrapper's order
enum {
  iModeIn,                  // i32, the mode each stream entered the step in
  iMode,                    // i32, after the branches (supervision form)
  iRes,                     // f32 x, y, w, h, angle, conf, wb (supervision)
  iEsc = iRes + 7, iDirty,  // bool
  iWin,                     // (N, 4) i32, the mean shift's window
  iMom,                     // f32 mu20, mu02, mu11, invM00
  iZeroMass = iMom + 4,     // bool
  iOldWin,                  // (N, 4) i32, the camshift state's (freeze)
  iOldTrack,                // i32 track_x, track_y, track_w, track_h
  iOldAngle = iOldTrack + 4,  // f32 track_angle
  iFirstRun, iFaceFound, iSmInit, iHeadposeActive, iStopped,  // bool
  iSmSp,                    // (N, 5) f32
  iDiagRing,                // (N, 6) f32
  iDiagN,                   // i32
  iTanFov, iFovWidth, iHeadDiagCam,  // f32
  kInputs
};
// output rows (Args::of, oi, ob)
enum {
  oTrackAngle, oFaceX, oFaceY, oFaceW, oFaceH, oAngle, oConf, oWb, oSmoothX,
  oSmoothY, oSmoothW, oSmoothH, oHeadX, oHeadY, oHeadZ, oFovDeg, oTanFov,
  oFovWidth, oHeadDiag, kF32Rows
};
enum {
  oTrackX, oTrackY, oTrackW, oTrackH, oDetection, oStatus, oModeAfter,
  oDiagN, kI32Rows
};
enum {
  oHeadValid, oEventFace, oEscapedOut, oEsc, oSmInit, oFaceFound, oFirstRun,
  oHeadposeActive, oStopped, kBoolRows
};

constexpr int kModeWb = 0, kModeVj = 1, kModeCs = 2;
constexpr int kDiagLength = 6;
// streams a CTA (a thread each, the CTA's first warp), the CTA's warps (all
// of them stage), and the widest row pitch staged as a segment
constexpr int kStreams = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr long long kMaxPitch = 48;
// a CTA's first stream, kStreams i0, lies a multiple of 16 bytes past an
// input's base: its staged rows keep the base's offset into 16 bytes
static_assert(kStreams % 16 == 0, "a CTA's rows start at base mod 16");

// an input's bytes an element and elements a stream
__host__ __device__ constexpr int elem_bytes(int q) {
  return (q == iEsc || q == iDirty || q == iZeroMass ||
          (q >= iFirstRun && q <= iStopped)) ? 1 : 4;
}
__host__ __device__ constexpr int columns(int q) {
  return q == iWin || q == iOldWin ? 4
       : q == iSmSp ? 5
       : q == iDiagRing ? kDiagLength : 1;
}

// an input: its base (null: not read) and the elements between two
// streams' rows
struct Plane {
  const void* p;
  long long s;
};

// The launch's arguments: the inputs, one output block and the constants.
struct Args {
  Plane in[kInputs];
  uint8_t* out;
  float k[kConsts];
};

// The output block of n streams, every row at a place fixed by n: the f32
// rows, the i32 rows, sm_sp (N, 5), the ring (N, 6), the window (N, 4),
// then the bool rows (kernels/epilogue.py views it the same way).
struct Out {
  uint8_t* base;
  long long n;
  __device__ __forceinline__ float* f32(int r) const {
    return reinterpret_cast<float*>(base) + r * n;
  }
  __device__ __forceinline__ int* i32(int r) const {
    return reinterpret_cast<int*>(base) + (kF32Rows + r) * n;
  }
  __device__ __forceinline__ float* sm_sp() const {
    return reinterpret_cast<float*>(base) + (kF32Rows + kI32Rows) * n;
  }
  __device__ __forceinline__ float* ring() const {
    return reinterpret_cast<float*>(base) + (kF32Rows + kI32Rows + 5) * n;
  }
  __device__ __forceinline__ int* win() const {
    return reinterpret_cast<int*>(base) + (kF32Rows + kI32Rows + 11) * n;
  }
  __device__ __forceinline__ uint8_t* b8(int r) const {
    return base + (4 * (kF32Rows + kI32Rows + 15) + r) * n;
  }
};

// Each input's place in a CTA's shared memory: a fixed slot (kSlot bytes
// at kSlot q) that holds its kStreams rows whatever their pitch
constexpr int kSlot = kStreams * kMaxPitch + 32;
constexpr int kSmem = kInputs * kSlot;
static_assert(4 * kStreams * kDiagLength <= kSlot, "a word an element fits");

// Where a staged input's rows lie (the staging warp writes it): the CTA's
// first stream's element at row0 bytes from the dynamic base, each
// stream's pitch bytes after the one before; a word-an-element input's
// bools also need the base's and the stride's low two bits (lane, s4).
struct Meta {
  int row0, pitch, lane, s4;
};

// The word holding each element of an input whose rows lie far apart:
// columns k of e bytes, streams [i0, i0 + m), by a warp's lanes in turn.
// Out of line: one copy of its code serves every input.
__device__ __noinline__ void stage_words(const uint8_t* p, long long s,
                                         int e, int k, uint8_t* dst,
                                         long long i0, int m, int lane) {
  for (int t = lane; t < m * k; t += 32) {
    const int j = t / k, c = t - j * k;
    const uintptr_t at =
        reinterpret_cast<uintptr_t>(p) + ((i0 + j) * s + c) * e;
    sm90::cp_async4(dst + 4 * t,
                    reinterpret_cast<const void*>(at & ~uintptr_t{3}));
  }
}

// Copy the rows of streams [i0, i0 + m) of every input into its slot in
// shared memory: warp w copies the inputs q with q % kWarps == w, its
// lanes a 16-byte unit each in turn (from the unit holding stream i0's row
// to the one holding the last stream's last element; a word an element
// where rows lie more than kMaxPitch bytes apart), every copy issued
// before the first wait, and lane 0 writes the input's Meta.  Each warp
// reads only its own inputs' parameters (a __grid_constant__ block,
// indexed in place), the loop over them unrolled (kPerWarp turns) so that
// their loads issue together, and the code stays small: a CTA fetches each
// instruction once, and the loop unrolled over all the inputs fetched more
// code than its copies took time.
constexpr int kPerWarp = (kInputs + kWarps - 1) / kWarps;

__device__ __forceinline__ void stage(const Args& a, uint8_t* sm, Meta* meta,
                                      long long i0, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int q = warp + kWarps * r;
    if (q >= kInputs) break;
    const uint8_t* p = static_cast<const uint8_t*>(a.in[q].p);
    if (p == nullptr) continue;
    const long long s = a.in[q].s;
    const int e = elem_bytes(q), k = columns(q);
    const long long pitch = s * e;
    uint8_t* slot = sm + q * kSlot;
    if (pitch < 0 || pitch > kMaxPitch) {
      stage_words(p, s, e, k, slot, i0, m, lane);
      if (lane == 0) {
        meta[q] = {q * kSlot, 4 * k,
                   static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3),
                   static_cast<int>(s & 3)};
      }
      continue;
    }
    // kStreams i0 pitch is a multiple of 16: a CTA's first row keeps the
    // base's offset into 16 bytes
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    const uint8_t* src = p - head + i0 * pitch;
    const int bytes = static_cast<int>(
        (head + (m - 1) * pitch + k * e + 15) & ~15ll);
#pragma unroll 1
    for (int o = 16 * lane; o < bytes; o += 16 * 32) {
      sm90::cp_async16(slot + o, src + o);
    }
    if (lane == 0) meta[q] = {q * kSlot + head, static_cast<int>(pitch), 0, 0};
  }
  sm90::cp_async_wait_all();
  __syncthreads();
}

// stream i0 + j's staged inputs
struct Staged {
  const uint8_t* sm;
  const Meta* meta;
  int j;

  __device__ __forceinline__ const uint8_t* at(int q, int c) const {
    const Meta& t = meta[q];
    if (elem_bytes(q) == 1) {
      // a bool (one column): its byte in a segment (lane = s4 = 0), or in
      // its word (the base's and the stride's low two bits; kStreams i0 s
      // is a multiple of 4)
      return sm + t.row0 + j * t.pitch + ((t.lane + j * t.s4) & 3);
    }
    return sm + t.row0 + j * t.pitch + 4 * c;
  }
  template <typename T>
  __device__ __forceinline__ T get(int q, int c = 0) const {
    return *reinterpret_cast<const T*>(at(q, c));
  }
  __device__ __forceinline__ bool flag(int q) const { return *at(q, 0) != 0; }
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fsqrt(float a) { return __fsqrt_rn(a); }

// JS Math.sqrt(v) << 2: trunc(sqrt(v)) * 4; NaN (v < 0, zero mass) -> 0
__device__ __forceinline__ int sqrt_shl2(float v, bool bad) {
  const bool ok = !bad && v >= 0.0f && isfinite(v);
  const float r = fsqrt(fmaxf(v, 0.0f));
  return ok ? __float2int_rz(fmul(truncf(r), 4.0f)) : 0;
}

// floor(clamp(v, 0, hi)) as an int
__device__ __forceinline__ int floor_clamp(float v, float hi) {
  return __float2int_rz(floorf(fminf(fmaxf(v, 0.0f), hi)));
}

struct Finished {
  int win[4], tx, ty, tw, th;
  float ang;
};

// camshift's _finish (src/camshift.js:230-258)
__device__ __forceinline__ Finished finish(const Args& a, const Staged& S,
                                           unsigned flags) {
  Finished f;
  const float inv = S.get<float>(iMom + 3);
  const float am = fmul(S.get<float>(iMom + 0), inv);
  const float cm = fmul(S.get<float>(iMom + 1), inv);
  const bool zm = S.flag(iZeroMass);
  if (flags & kCalcAngles) {
    const float b = fmul(S.get<float>(iMom + 2), inv);
    const float d = fadd(am, cm);
    const float amc = fsub(am, cm);
    const float e = fsqrt(fadd(fmul(fmul(4.0f, b), b), fmul(amc, amc)));
    f.tw = sqrt_shl2(fmul(fsub(d, e), 0.5f), zm);
    f.th = sqrt_shl2(fmul(fadd(d, e), 0.5f), zm);
    float ang = atan2f(fmul(2.0f, b), fadd(amc, e));
    if (ang < 0.0f) ang = fadd(ang, a.k[kPi]);
    f.ang = zm ? __int_as_float(0x7fc00000) : ang;  // PyTorch's NaN
  } else {
    f.tw = sqrt_shl2(am, zm);
    f.th = sqrt_shl2(cm, zm);
    f.ang = a.k[kHalfPi];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) f.win[c] = S.get<int>(iWin, c);
  const float fw = __int2float_rn(f.win[2]), fh = __int2float_rn(f.win[3]);
  f.tx = floor_clamp(fadd(__int2float_rn(f.win[0]), fmul(fw, 0.5f)),
                     a.k[kCamW]);
  f.ty = floor_clamp(fadd(__int2float_rn(f.win[1]), fmul(fh, 0.5f)),
                     a.k[kCamH]);
  f.win[2] = __float2int_rz(floorf(fmul(a.k[kGrowth], __int2float_rn(f.tw))));
  f.win[3] = __float2int_rz(floorf(fmul(a.k[kGrowth], __int2float_rn(f.th))));
  return f;
}

// FOV estimate from the face diagonal (src/headposition.js:66-81), radians
__device__ __forceinline__ float fov_estimate(const Args& a, float w,
                                              float h) {
  const float head_diag = fsqrt(fadd(fmul(w, w), fmul(h, h)));
  const float head_width = fmul(a.k[kSin], head_diag);
  const float at_default = fmul(fdiv(a.k[kCamW], head_width), a.k[kWidthCm]);
  return fmul(atanf(fdiv(fmul(at_default, 0.5f), a.k[kDistance])), 2.0f);
}

// one head-position step (src/headposition.js:91-191): x, y, z and the new
// head diagonal
__device__ __forceinline__ void track_head(const Args& a, unsigned flags,
                                           float fx, float fy, float w,
                                           float h, float hdc, float tan_fov,
                                           float (&o)[4]) {
  const float camw = a.k[kCamW], camh = a.k[kCamH], m = a.k[kMargin];
  const float diag = fsqrt(fadd(fmul(w, w), fmul(h, h)));
  if (flags & kEdge) {
    const float w2 = fmul(w, 0.5f), h2 = fmul(h, 0.5f);
    const float left = fsub(fx, w2);
    const float right = fsub(camw, fadd(fx, w2));
    const float top = fsub(fy, h2);
    const float bottom = fsub(camh, fadd(fy, h2));
    const bool on_v = left < m || right < m;
    const bool on_h = top < m || bottom < m;
    if (on_h && on_v) {
      // corner: keep previous diagonal (src/headposition.js:111-127)
      const float sin2 = fmul(fmul(hdc, a.k[kSin]), 0.5f);
      const float cos2 = fmul(fmul(hdc, a.k[kCos]), 0.5f);
      fx = left < m ? fsub(w, sin2) : fadd(left, sin2);
      fy = top < m ? fsub(h, cos2) : fadd(top, cos2);
    } else if (on_h) {
      // top/bottom edge (src/headposition.js:130-143)
      const float t_ow = fdiv(top < m ? top : bottom, m);
      const float t_ew = fsub(1.0f, t_ow);
      const float hb_in = fadd(fmul(fmul(t_ow, h), 0.5f),
                               fmul(t_ew, fmul(fdiv(w, a.k[kTan]), 0.5f)));
      fy = top < m ? fsub(h, hb_in) : fadd(top, hb_in);
      hdc = fadd(fmul(t_ew, fdiv(w, a.k[kSin])), fmul(t_ow, diag));
    } else if (on_v) {
      // left/right edge (src/headposition.js:144-156)
      const float v_ow = fdiv(left < m ? left : right, m);
      const float v_ew = fsub(1.0f, v_ow);
      const float v_in = fadd(fmul(fmul(v_ow, w), 0.5f),
                              fmul(v_ew, fmul(fmul(h, a.k[kTan]), 0.5f)));
      fx = left < m ? fsub(w, v_in) : fadd(left, v_in);
      hdc = fadd(fmul(v_ew, fdiv(h, a.k[kCos])), fmul(v_ow, diag));
    } else {
      hdc = diag;
    }
  } else {
    hdc = diag;
  }
  const float z = fdiv(fmul(a.k[kDiagCm], camw), fmul(tan_fov, hdc));
  o[0] = fmul(fmul(-fsub(fdiv(fx, camw), 0.5f), z), tan_fov);
  o[1] = fadd(fmul(fmul(fmul(-fsub(fdiv(fy, camh), 0.5f), z), tan_fov),
                   fdiv(camh, camw)),
              a.k[kOffset]);
  o[2] = z;
  o[3] = hdc;
}

__global__ void __launch_bounds__(kThreads)
    tick_epilogue(const __grid_constant__ Args a, long long n,
                  unsigned flags) {
  extern __shared__ __align__(16) uint8_t staged[];
  __shared__ Meta meta[kInputs];
  const long long i0 = static_cast<long long>(blockIdx.x) * kStreams;
  const int m = n - i0 < kStreams ? static_cast<int>(n - i0) : kStreams;
  stage(a, staged, meta, i0, m);  // every load, before any branch on a value
  if (threadIdx.x >= kStreams) return;  // the first warp computes
  const Staged S{staged, meta, static_cast<int>(threadIdx.x)};
  const Out O{a.out, n};
  const long long i = i0 + threadIdx.x;
  if (i >= n) return;
  // the finish alone reads no mode
  const int entry =
      (flags & (kFreeze | kSupervise)) ? S.get<int>(iModeIn) : kModeCs;
  const bool is_cs = entry == kModeCs;
  float r[7];  // the result: x, y, w, h, angle, conf, wb
  int mode = entry;
  if (flags & kFinish) {
    const Finished f = finish(a, S, flags);
    const bool keep = (flags & kFreeze) && !is_cs;  // a frozen stream
    const int track[4] = {f.tx, f.ty, f.tw, f.th};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      O.win()[4 * i + c] = keep ? S.get<int>(iOldWin, c) : f.win[c];
      O.i32(oTrackX + c)[i] = keep ? S.get<int>(iOldTrack + c) : track[c];
    }
    O.f32(oTrackAngle)[i] = keep ? S.get<float>(iOldAngle) : f.ang;
    if (!(flags & kSupervise)) return;
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = __int2float_rn(track[c]);
    r[4] = f.ang;
    r[5] = (flags & kFreeze) && !is_cs ? 0.0f : 1.0f;
    r[6] = 0.0f;
#pragma unroll
    for (int c = 0; c < 7; ++c) O.f32(oFaceX + c)[i] = r[c];
  } else {
#pragma unroll
    for (int c = 0; c < 7; ++c) r[c] = S.get<float>(iRes + c);
    mode = S.get<int>(iMode);
  }

  const bool first_run = S.flag(iFirstRun);
  int status = entry == kModeWb ? 1 : 0;
  if (first_run && entry == kModeVj) status |= 2;
  if ((flags & kFreeze) && !is_cs) status = 0;
  if ((flags & kWbtrack) && entry == kModeVj) status = 0;
  const bool conf_gate = r[5] != 0.0f;  // src/main.js:186
  const bool lost = is_cs && conf_gate && (r[2] == 0.0f || r[3] == 0.0f);
  const bool tracking = is_cs && conf_gate && !lost;

  // loss / retry (src/main.js:230-248)
  int mode_after = mode;
  if (flags & kRetry) {
    if (lost) {
      status |= 8;
      mode_after = kModeVj;
    }
  } else {
    if (lost) status |= 16;
    O.b8(oStopped)[i] = S.flag(iStopped) || lost;
  }
  const bool found0 = S.flag(iFaceFound);
  bool active = S.flag(iHeadposeActive) && !lost;
  // found + smoothing (src/main.js:250-261)
  if (tracking && !found0) status |= 4;
  O.b8(oFaceFound)[i] = (found0 && !lost) || tracking;

  const float cur[5] = {r[0], r[1], 0.0f, r[2], r[3]};
  float sm[5];
  if (flags & kSmoothing) {
    const float alpha = a.k[kAlpha];
    const float beta = fsub(1.0f, alpha);
    const bool init = S.flag(iSmInit);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float sp = S.get<float>(iSmSp, c);
      const float sp1 = fadd(fmul(alpha, cur[c]), fmul(beta, init ? sp : cur[c]));
      O.sm_sp()[5 * i + c] = tracking ? sp1 : sp;
      sm[c] = tracking ? sp1 : cur[c];
    }
    O.b8(oSmInit)[i] = init || tracking;
  } else {
#pragma unroll
    for (int c = 0; c < 5; ++c) sm[c] = cur[c];
  }
  const float sx = sm[0], sy = sm[1], sw = sm[3], sh = sm[4];

  // head-diagonal stability gate + FOV (src/main.js:263-297)
  const float diag = fsqrt(fadd(fmul(sw, sw), fmul(sh, sh)));
  const bool gate = tracking && !active && (flags & kHeadPosition);
  const int dn = S.get<int>(iDiagN);
  const bool ring_full = dn >= kDiagLength;
  const int slot = dn < kDiagLength - 1 ? (dn < 0 ? 0 : dn) : kDiagLength - 1;
  float ring[kDiagLength], pushed[kDiagLength];
#pragma unroll
  for (int c = 0; c < kDiagLength; ++c) ring[c] = S.get<float>(iDiagRing, c);
  bool nan = false;
  float hi = -CUDART_INF_F, lo = CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < kDiagLength; ++c) {
    pushed[c] = ring_full ? (c < kDiagLength - 1 ? ring[c + 1] : diag)
                          : (c == slot ? diag : ring[c]);
    nan = nan || isnan(pushed[c]);
    hi = fmaxf(hi, pushed[c]);
    lo = fminf(lo, pushed[c]);
    O.ring()[kDiagLength * i + c] = gate ? pushed[c] : ring[c];
  }
  O.i32(oDiagN)[i] = gate ? (dn + 1 < kDiagLength ? dn + 1 : kDiagLength)
                         : dn;
  const bool activate = gate && ring_full && !nan && fsub(hi, lo) < 5.0f;

  // each value below is computed only where it is used (a stream that
  // activates; one whose head is tracked): the same values as the twin's
  // selects, without the math no lane of the warp needs
  const bool first = activate && first_run;
  float fov_width = S.get<float>(iFovWidth);
  float tan_fov = S.get<float>(iTanFov);
  if (first) {
    fov_width = (flags & kFov) ? a.k[kFovRad] : fov_estimate(a, sw, sh);
    tan_fov = fmul(2.0f, tanf(fmul(fov_width, 0.5f)));
  }
  O.b8(oFirstRun)[i] = first_run && !activate;
  // the constructor resets head_diag_cam from the activation faceObj
  // (src/headposition.js:66-68)
  float hdc = activate ? diag : S.get<float>(iHeadDiagCam);
  active = active || activate;
  const bool run_head =
      activate || (tracking && active && (flags & kHeadPosition));
  float head[4] = {0.0f, 0.0f, 0.0f, hdc};
  if (run_head) {
    track_head(a, flags, sx, sy, sw, sh, hdc,
               tan_fov > 0.0f ? tan_fov : 1.0f, head);
  }
  hdc = head[3];

  O.i32(oDetection)[i] = entry;
  O.i32(oStatus)[i] = status;
  O.i32(oModeAfter)[i] = mode_after;
  O.f32(oSmoothX)[i] = sx;
  O.f32(oSmoothY)[i] = sy;
  O.f32(oSmoothW)[i] = sw;
  O.f32(oSmoothH)[i] = sh;
  O.f32(oHeadX)[i] = run_head ? head[0] : 0.0f;
  O.f32(oHeadY)[i] = run_head ? head[1] : 0.0f;
  O.f32(oHeadZ)[i] = run_head ? head[2] : 0.0f;
  O.f32(oFovDeg)[i] = fmul(fov_width, a.k[kRad2Deg]);
  O.f32(oTanFov)[i] = tan_fov;
  O.f32(oFovWidth)[i] = fov_width;
  O.f32(oHeadDiag)[i] = hdc;
  O.b8(oHeadValid)[i] = run_head;
  O.b8(oEventFace)[i] = is_cs && (flags & kSendEvents);
  O.b8(oEscapedOut)[i] = 0;
  O.b8(oHeadposeActive)[i] = active;
  if (flags & kEscaped) {
    const bool esc = S.flag(iEsc) || ((flags & kDirty) && S.flag(iDirty));
    O.b8(oEsc)[i] = esc && is_cs;
  }
}

// an empty kernel at tick_epilogue's grid (its floor)
__global__ void __launch_bounds__(kThreads) epilogue_floor() {}

}  // namespace

extern "C" int tick_epilogue_args_bytes() { return sizeof(Args); }

// The empty kernel at the grid tick_epilogue takes for n streams.
extern "C" int tick_epilogue_floor_launch(long long n, cudaStream_t stream) {
  const long long blocks = (n + kStreams - 1) / kStreams;
  epilogue_floor<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tick_epilogue_launch(const void* args, long long n,
                                    unsigned flags, cudaStream_t stream) {
  if (n <= 0) return 0;
  Args a;
  std::memcpy(&a, args, sizeof(Args));
  const cudaError_t e = cudaFuncSetAttribute(
      tick_epilogue, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + kStreams - 1) / kStreams;
  tick_epilogue<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      a, n, flags);
  return static_cast<int>(cudaGetLastError());
}
