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
//     one (N, 12) tensor).  Outputs are rows the wrapper allocates, a
//     pointer each; a leaf the step leaves alone is not written (the
//     wrapper passes the input tensor through).
//   - Bound: latency.  A stream reads ~120 B and writes ~160 B; one thread
//     a stream on the grid's x dimension (any N), 256 threads a CTA.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <math_constants.h>

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
constexpr int kThreads = 256;

// an input: its base and the elements between two streams' rows
struct Plane {
  const void* p;
  long long s;
};

struct Args {
  Plane mode_in;  // i32, the mode each stream entered the step in
  Plane mode;     // i32, after the branches (supervision form)
  Plane res[7];   // f32 x, y, w, h, angle, conf, wb (supervision form)
  Plane esc, dirty;       // bool
  Plane win;              // (N, 4) i32, the mean shift's window
  Plane mom[4];           // f32 mu20, mu02, mu11, invM00
  Plane zero_mass;        // bool
  Plane old_win;          // (N, 4) i32, the camshift state's (freeze)
  Plane old_track[4];     // i32 track_x, track_y, track_w, track_h
  Plane old_angle;        // f32 track_angle
  Plane first_run, face_found, sm_init, headpose_active, stopped;  // bool
  Plane sm_sp;            // (N, 5) f32
  Plane diag_ring;        // (N, 6) f32
  Plane diag_n;           // i32
  Plane tan_fov, fov_width, head_diag_cam;  // f32
  float* of[kF32Rows];
  int* oi[kI32Rows];
  unsigned char* ob[kBoolRows];
  float* sm_sp_out;       // (N, 5)
  float* ring_out;        // (N, 6)
  int* win_out;           // (N, 4)
  float k[kConsts];
};

template <typename T>
__device__ __forceinline__ T ld(const Plane& a, long long i, int col = 0) {
  return static_cast<const T*>(a.p)[i * a.s + col];
}

__device__ __forceinline__ bool ldb(const Plane& a, long long i) {
  return static_cast<const unsigned char*>(a.p)[i * a.s] != 0;
}

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
__device__ __forceinline__ Finished finish(const Args& a, long long i,
                                           unsigned flags) {
  Finished f;
  const float inv = ld<float>(a.mom[3], i);
  const float am = fmul(ld<float>(a.mom[0], i), inv);
  const float cm = fmul(ld<float>(a.mom[1], i), inv);
  const bool zm = ldb(a.zero_mass, i);
  if (flags & kCalcAngles) {
    const float b = fmul(ld<float>(a.mom[2], i), inv);
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
  for (int c = 0; c < 4; ++c) f.win[c] = ld<int>(a.win, i, c);
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
    const float sin2 = fmul(fmul(hdc, a.k[kSin]), 0.5f);
    const float cos2 = fmul(fmul(hdc, a.k[kCos]), 0.5f);
    // corner: keep previous diagonal (src/headposition.js:111-127)
    const float c_fx = left < m ? fsub(w, sin2) : fadd(left, sin2);
    const float c_fy = top < m ? fsub(h, cos2) : fadd(top, cos2);
    // top/bottom edge (src/headposition.js:130-143)
    const float t_ow = fdiv(top < m ? top : bottom, m);
    const float t_ew = fsub(1.0f, t_ow);
    const float hb_in = fadd(fmul(fmul(t_ow, h), 0.5f),
                             fmul(t_ew, fmul(fdiv(w, a.k[kTan]), 0.5f)));
    const float hb_fy = top < m ? fsub(h, hb_in) : fadd(top, hb_in);
    const float hb_diag = fadd(fmul(t_ew, fdiv(w, a.k[kSin])),
                               fmul(t_ow, diag));
    // left/right edge (src/headposition.js:144-156)
    const float v_ow = fdiv(left < m ? left : right, m);
    const float v_ew = fsub(1.0f, v_ow);
    const float v_in = fadd(fmul(fmul(v_ow, w), 0.5f),
                            fmul(v_ew, fmul(fmul(h, a.k[kTan]), 0.5f)));
    const float v_fx = left < m ? fsub(w, v_in) : fadd(left, v_in);
    const float v_diag = fadd(fmul(v_ew, fdiv(h, a.k[kCos])),
                              fmul(v_ow, diag));
    const bool corner = on_h && on_v;
    const float nfx = corner ? c_fx : (on_v ? v_fx : fx);
    const float nfy = corner ? c_fy : (on_h ? hb_fy : fy);
    hdc = corner ? hdc : (on_h ? hb_diag : (on_v ? v_diag : diag));
    fx = nfx;
    fy = nfy;
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
    tick_epilogue(const Args a, long long n, unsigned flags) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  // the finish alone reads no mode
  const int entry =
      (flags & (kFreeze | kSupervise)) ? ld<int>(a.mode_in, i) : kModeCs;
  const bool is_cs = entry == kModeCs;
  float r[7];  // the result: x, y, w, h, angle, conf, wb
  int mode = entry;
  if (flags & kFinish) {
    const Finished f = finish(a, i, flags);
    const bool keep = (flags & kFreeze) && !is_cs;  // a frozen stream
    const int track[4] = {f.tx, f.ty, f.tw, f.th};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a.win_out[4 * i + c] = keep ? ld<int>(a.old_win, i, c) : f.win[c];
      a.oi[oTrackX + c][i] = keep ? ld<int>(a.old_track[c], i) : track[c];
    }
    a.of[oTrackAngle][i] = keep ? ld<float>(a.old_angle, i) : f.ang;
    if (!(flags & kSupervise)) return;
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = __int2float_rn(track[c]);
    r[4] = f.ang;
    r[5] = (flags & kFreeze) && !is_cs ? 0.0f : 1.0f;
    r[6] = 0.0f;
#pragma unroll
    for (int c = 0; c < 7; ++c) a.of[oFaceX + c][i] = r[c];
  } else {
#pragma unroll
    for (int c = 0; c < 7; ++c) r[c] = ld<float>(a.res[c], i);
    mode = ld<int>(a.mode, i);
  }

  const bool first_run = ldb(a.first_run, i);
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
    a.ob[oStopped][i] = ldb(a.stopped, i) || lost;
  }
  const bool found0 = ldb(a.face_found, i);
  bool active = ldb(a.headpose_active, i) && !lost;
  // found + smoothing (src/main.js:250-261)
  if (tracking && !found0) status |= 4;
  a.ob[oFaceFound][i] = (found0 && !lost) || tracking;

  const float cur[5] = {r[0], r[1], 0.0f, r[2], r[3]};
  float sm[5];
  if (flags & kSmoothing) {
    const float alpha = a.k[kAlpha];
    const float beta = fsub(1.0f, alpha);
    const bool init = ldb(a.sm_init, i);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float sp = ld<float>(a.sm_sp, i, c);
      const float sp1 = fadd(fmul(alpha, cur[c]), fmul(beta, init ? sp : cur[c]));
      a.sm_sp_out[5 * i + c] = tracking ? sp1 : sp;
      sm[c] = tracking ? sp1 : cur[c];
    }
    a.ob[oSmInit][i] = init || tracking;
  } else {
#pragma unroll
    for (int c = 0; c < 5; ++c) sm[c] = cur[c];
  }
  const float sx = sm[0], sy = sm[1], sw = sm[3], sh = sm[4];

  // head-diagonal stability gate + FOV (src/main.js:263-297)
  const float diag = fsqrt(fadd(fmul(sw, sw), fmul(sh, sh)));
  const bool gate = tracking && !active && (flags & kHeadPosition);
  const int dn = ld<int>(a.diag_n, i);
  const bool ring_full = dn >= kDiagLength;
  const int slot = dn < kDiagLength - 1 ? (dn < 0 ? 0 : dn) : kDiagLength - 1;
  float ring[kDiagLength], pushed[kDiagLength];
#pragma unroll
  for (int c = 0; c < kDiagLength; ++c) ring[c] = ld<float>(a.diag_ring, i, c);
  bool nan = false;
  float hi = -CUDART_INF_F, lo = CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < kDiagLength; ++c) {
    pushed[c] = ring_full ? (c < kDiagLength - 1 ? ring[c + 1] : diag)
                          : (c == slot ? diag : ring[c]);
    nan = nan || isnan(pushed[c]);
    hi = fmaxf(hi, pushed[c]);
    lo = fminf(lo, pushed[c]);
    a.ring_out[kDiagLength * i + c] = gate ? pushed[c] : ring[c];
  }
  a.oi[oDiagN][i] = gate ? (dn + 1 < kDiagLength ? dn + 1 : kDiagLength)
                         : dn;
  const bool activate = gate && ring_full && !nan && fsub(hi, lo) < 5.0f;

  const float fov_est = (flags & kFov) ? a.k[kFovRad]
                                       : fov_estimate(a, sw, sh);
  const bool first = activate && first_run;
  const float fov_width = first ? fov_est : ld<float>(a.fov_width, i);
  const float tan_fov = first ? fmul(2.0f, tanf(fmul(fov_est, 0.5f)))
                              : ld<float>(a.tan_fov, i);
  a.ob[oFirstRun][i] = first_run && !activate;
  // the constructor resets head_diag_cam from the activation faceObj
  // (src/headposition.js:66-68)
  float hdc = activate ? diag : ld<float>(a.head_diag_cam, i);
  active = active || activate;
  const bool run_head =
      activate || (tracking && active && (flags & kHeadPosition));
  float head[4];
  track_head(a, flags, sx, sy, sw, sh, hdc, tan_fov > 0.0f ? tan_fov : 1.0f,
             head);
  hdc = run_head ? head[3] : hdc;

  a.oi[oDetection][i] = entry;
  a.oi[oStatus][i] = status;
  a.oi[oModeAfter][i] = mode_after;
  a.of[oSmoothX][i] = sx;
  a.of[oSmoothY][i] = sy;
  a.of[oSmoothW][i] = sw;
  a.of[oSmoothH][i] = sh;
  a.of[oHeadX][i] = run_head ? head[0] : 0.0f;
  a.of[oHeadY][i] = run_head ? head[1] : 0.0f;
  a.of[oHeadZ][i] = run_head ? head[2] : 0.0f;
  a.of[oFovDeg][i] = fmul(fov_width, a.k[kRad2Deg]);
  a.of[oTanFov][i] = tan_fov;
  a.of[oFovWidth][i] = fov_width;
  a.of[oHeadDiag][i] = hdc;
  a.ob[oHeadValid][i] = run_head;
  a.ob[oEventFace][i] = is_cs && (flags & kSendEvents);
  a.ob[oEscapedOut][i] = 0;
  a.ob[oHeadposeActive][i] = active;
  if (flags & kEscaped) {
    const bool esc = ldb(a.esc, i) || ((flags & kDirty) && ldb(a.dirty, i));
    a.ob[oEsc][i] = esc && is_cs;
  }
}

}  // namespace

extern "C" int tick_epilogue_args_bytes() { return sizeof(Args); }

extern "C" int tick_epilogue_launch(const void* args, long long n,
                                    unsigned flags, cudaStream_t stream) {
  Args a;
  std::memcpy(&a, args, sizeof(Args));
  const long long blocks = (n + kThreads - 1) / kThreads;
  tick_epilogue<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, n, flags);
  return static_cast<int>(cudaGetLastError());
}
