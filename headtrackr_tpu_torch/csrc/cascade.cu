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
//   - Design: three kernels and no host read.  cascade_dense: a thread a
//     window, blockIdx.y the stream, through the first `dense` stages (the
//     leading stages, at most kDense, whose weak classifiers fit
//     kDenseWeak: 4 + 4 for the frontal-face cascade) with early exit; most
//     windows die there (~0.2% survive on the bench pool).  A CTA takes 256
//     consecutive windows of one scale step (its tile, starting on a
//     bitmap word); the codes, the alphas and the scale steps' geometry
//     come in the kernel's parameters, and the CTA first resolves each
//     feature slot to (plane, offset) for its scale in shared memory, so a
//     pixel is a thread's pick of its window's place in that plane, an add
//     and a byte load, with no branch (empty slots come filled with a slot
//     of their side).  A dense survivor's (stream, window) goes onto a work
//     list (one integer atomic ticket a warp ballot; the list holds
//     n * m_len entries, so nothing is ever dropped), and each warp ORs its
//     ballot into its 32-bit word of a per-stream bitmap (the word where
//     two scale steps meet gets both tiles' bits).
//     cascade_deep: one CTA of 32 warps an SM, the deep stages' alphas and
//     slot offsets (i16) in its shared memory; warp w takes list entries
//     w, w + W, ...: the windows around a face survive together and sit
//     together on the list, so their full-depth chains (up to 2,007 weak
//     classifiers) run side by side over the card, not back to back in the
//     warp that found them.  The warp copies its window's footprint (the
//     pixels any feature reads: 24 x 24, 12 x 12 and 11 x 6 bytes for the
//     frontal-face cascade) into its shared buffer, then its lanes split
//     each stage's weak classifiers, two at a time, reading only shared
//     memory, and sum by shuffles; a survivor that dies clears its bit (an
//     integer atomicAnd), one that lives writes its confidence.  The list's
//     order does not matter: the bitmap keeps window order.  The count and
//     the bitmap are zeroed by one memset on the stream before
//     cascade_dense, so a replayed CUDA graph starts from 0 each time.
//     cascade_compact: a CTA a stream walks the bitmap in order (popcounts,
//     a block scan, then each thread its words' set bits) and writes the
//     first C survivors in window order (scale-major, then row-major: the
//     order that decides detect_best's ties) with their boxes from the
//     tables; overflow = the survivors beyond C.  So the kept set and its
//     order are the twin's for any count of survivors.
//   - Tables (models/detector.py DetectorTables): a weak classifier's 10
//     feature slots as i32 codes z | x' << 2 | y << 8 (-1: an empty slot),
//     alpha (K, 2) f32, the thresholds and the stages' ends, base and
//     rowstep (M, 3) i32, the boxes out_x/y/w/h (M,) f32, the deep kernel's
//     footprint offsets (K, 10) i16 (on the device); the dense kernel's
//     parameters (host arrays).
//   - Bound: the windows' reads of the first stage (8 weak classifiers'
//     pixels over every window) and the bitmap; little arithmetic.  In
//     practice cascade_dense is bound by instruction issue (~12
//     instructions a feature slot a window), and cascade_deep, where
//     survivors are few (the relock bucket, the session), by one
//     survivor's chain of dependent shared-memory loads and shuffles.
//
// Each launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 10;      // feature pixels a weak classifier: 5 + 5
constexpr int kDense = 2;       // stages run a thread a window, at most
constexpr int kDenseWeak = 16;  // their weak classifiers, at most
constexpr int kMaxTile = 1024;  // windows a dense CTA takes, at most
constexpr int kMaxScales = 64;  // scale steps the dense kernel takes
constexpr int kSlotBytes = kDenseWeak * kSlots * 16;  // its slot table
constexpr int kScaleCols = 9;   // DetectorTables.dense scales' columns
constexpr int kDeepThreads = 1024;
constexpr int kDeepWarps = kDeepThreads / 32;
constexpr int kSmemLimit = 232448;  // shared memory a CTA may have

enum { kFirst, kCount, kCols, kOff0, kOff1, kOff2, kW0, kW1, kWi };

// The dense kernel's parameters, passed by value: the dense stages' weak
// classifiers, and the scale steps' geometry with each one's first tile.
// A code's empty slot (-1) comes filled with another slot of its side
// (min and max do not change for a repeated pixel); `side` bit 0 marks a
// weak classifier with no positive slot (min 255), bit 1 one with no
// negative slot (max 0), whose slots then hold code 0.
struct DenseProg {
  int stages;  // dense stages
  int scales;  // scale steps
  int end[kDense];
  float thresh[kDense];
  int code[kDenseWeak * kSlots];
  int side[kDenseWeak];
  float alpha[kDenseWeak * 2];
  int ext[3];  // plane z rows a window row needs: y < ext[z] (I: 2y + 1)
  int tile;    // windows a CTA takes (a multiple of kThreads)
  int tile_first[kMaxScales + 1];
  int scale[kMaxScales * kScaleCols];
};

// Copy global bytes [src, src + len) to shared memory at dst + (src & 15):
// 16-byte loads where the whole vector lies in [lo, hi), bytes elsewhere.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int len, const uint8_t* lo,
                                            const uint8_t* hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uint4* v = reinterpret_cast<const uint4*>(a);
  const int chunks = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) + len - a + 15) / 16);
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const uint8_t* c = reinterpret_cast<const uint8_t*>(v + i);
    if (c >= lo && c + 16 <= hi) {
      *reinterpret_cast<uint4*>(dst + 16 * i) = __ldg(v + i);
    } else {
      for (int b = 0; b < 16; ++b) {
        if (c + b >= src && c + b < src + len) dst[16 * i + b] = c[b];
      }
    }
  }
}

// The dense stages, a thread a window of the CTA's tile (blockIdx.x:
// prog.tile windows of one scale starting on a bitmap word, kThreads at a
// time; blockIdx.y the stream).
// The CTA stages the rows its windows read of planes 0, 1 and I (three
// contiguous runs) into shared memory, and resolves every feature slot
// for its scale to (plane masks, offset); a pixel is then, for a thread,
// its window's base in the slot's plane (two masks), an add and a byte
// load from shared memory, with no branch.
__global__ void __launch_bounds__(kThreads)
cascade_dense_kernel(const __grid_constant__ DenseProg prog,
                     const uint8_t* __restrict__ buf, int l_len, int m_len,
                     int n_all, bool deep, uint32_t* __restrict__ bits,
                     float* __restrict__ conf, int words,
                     uint32_t* __restrict__ list, int* __restrict__ count) {
  // [slots (m1, m2, u) | plane 0 rows | plane 1 rows | I rows]
  extern __shared__ __align__(16) uint8_t smem[];
  int4* slot = reinterpret_cast<int4*>(smem);
  uint8_t* tile = smem + kSlotBytes;
  const int64_t n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  int g = 0;  // the tile's scale step
  while (g + 1 < prog.scales && prog.tile_first[g + 1] <= blockIdx.x) ++g;
  const int* sc = prog.scale + g * kScaleCols;
  const int first = sc[kFirst], cols = sc[kCols];
  const int m0 = (first / 32) * 32 + (blockIdx.x - prog.tile_first[g]) * prog.tile;
  // the tile's window rows, and the plane rows they read
  const int y2lo = (max(m0, first) - first) / cols;
  const int y2hi = (min(m0 + prog.tile, first + sc[kCount]) - 1 - first) / cols;
  const int wz[3] = {sc[kW0], sc[kW1], sc[kWi]};
  const int row0[3] = {2 * y2lo, y2lo, y2lo};
  const int rows[3] = {prog.ext[0] ? 2 * (y2hi - y2lo) + prog.ext[0] : 0,
                       prog.ext[1] ? y2hi - y2lo + prog.ext[1] : 0,
                       prog.ext[2] ? y2hi - y2lo + prog.ext[2] : 0};
  const uint8_t* p = buf + n * l_len;
  int at[3];  // each plane's first staged byte, in `tile`
  {
    const int off[3] = {sc[kOff0], sc[kOff1], sc[kOff2]};
    int t = 0;
#pragma unroll
    for (int z = 0; z < 3; ++z) {
      const uint8_t* src = p + off[z] + row0[z] * wz[z];
      const int len = rows[z] * wz[z];
      at[z] = t + static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      if (len > 0) {
        stage_bytes(tile + t, src, len, buf,
                    buf + static_cast<int64_t>(n_all) * l_len);
        t += (len + 15 + 15) & ~15;
      }
    }
  }
  const int weak = prog.stages > 0 ? prog.end[prog.stages - 1] : 0;
  if (threadIdx.x < weak * kSlots) {
    const int code = prog.code[threadIdx.x];
    const int z = code & 3;
    const int r = z == 0 ? wz[0] : (z == 1 ? wz[1] : 2 * wz[2]);
    slot[threadIdx.x] = make_int4(z == 1 ? -1 : 0, z == 2 ? -1 : 0,
                                  (code >> 8) * r + ((code >> 2) & 63), 0);
  }
  __syncthreads();
  // window t of the tile: its feature (0, 0) in the staged planes 0, 1
  // and I, as plane 0's place a0 and planes 1 and I relative to it
  auto place = [&](int t, int& a0, int& d1, int& d2) {
    const int local = m0 + t - first;
    const int y2 = local / cols, x2 = local - y2 * cols;
    a0 = at[0] + 2 * (y2 - y2lo) * wz[0] + 2 * x2;
    d1 = at[1] + (y2 - y2lo) * wz[1] + x2 - a0;
    d2 = at[2] + (y2 - y2lo) * wz[2] + x2 - a0;
  };
  // stage s's f64 vote sum at the window (a0, d1, d2)
  auto stage_sum = [&](int s, int a0, int d1, int d2) {
    double sum = 0.0;
    for (int k = s > 0 ? prog.end[s - 1] : 0; k < prog.end[s]; ++k) {
      int pmin = 255, nmax = 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int4 e = slot[k * kSlots + i];
        const int v = tile[a0 + (d1 & e.x) + (d2 & e.y) + e.z];
        if (i < 5) {
          pmin = min(pmin, v);
        } else {
          nmax = max(nmax, v);
        }
      }
      const int side = prog.side[k];
      if (side & 1) pmin = 255;
      if (side & 2) nmax = 0;
      sum += static_cast<double>(prog.alpha[2 * k + (pmin > nmax)]);
    }
    return sum;
  };
  for (int t = threadIdx.x; t < prog.tile; t += kThreads) {
    const int m = m0 + t;
    const bool in = m >= first && m < first + sc[kCount];
    bool alive = in;
    double sum = 0.0;
    if (in) {
      int a0, d1, d2;
      place(t, a0, d1, d2);
      for (int s = 0; s < prog.stages; ++s) {
        sum = stage_sum(s, a0, d1, d2);
        if (sum < static_cast<double>(prog.thresh[s])) {
          alive = false;
          break;
        }
      }
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, alive);
    if (deep) {
      int at_list = 0;
      if (lane == 0 && ballot) at_list = atomicAdd(count, __popc(ballot));
      at_list = __shfl_sync(0xffffffffu, at_list, 0);
      if (alive) {
        list[at_list + __popc(ballot & ((1u << lane) - 1))] =
            static_cast<uint32_t>(n * m_len + m);
      }
    } else if (alive) {
      conf[n * m_len + m] = __double2float_rn(sum);
    }
    if (lane == 0 && ballot) atomicOr(bits + n * words + (m >> 5), ballot);
  }
}

// The deep kernel's footprint of a window: for each plane z, the rows
// y < h[z] of w[z] bytes from the window's feature (0, 0), in this order.
struct Footprint {
  int w[3], h[3];
  __host__ __device__ int bytes() const {
    return w[0] * h[0] + w[1] * h[1] + w[2] * h[2];
  }
};

// Bytes of a warp's footprint buffer, rounded to 16.
__host__ __device__ __forceinline__ int fp_stride(int bytes) {
  return (bytes + 15) & ~15;
}

// Weak classifier k's vote on a window's footprint: its slots' offsets
// into it and its alphas in shared memory.
__device__ __forceinline__ float foot_vote(const uint8_t* foot,
                                           const int16_t* offs,
                                           const float2* alpha, int k) {
  const int16_t* f = offs + k * kSlots;
  int pmin = 255, nmax = 0;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int o = f[q];
    if (o >= 0) {
      if (q < 5) {
        pmin = min(pmin, static_cast<int>(foot[o]));
      } else {
        nmax = max(nmax, static_cast<int>(foot[o]));
      }
    }
  }
  const float2 a = alpha[k];
  return pmin > nmax ? a.y : a.x;
}

// The deep stages, a warp a survivor of the work list (warp w of W takes
// entries w, w + W, ...), its lanes splitting each stage's weak
// classifiers.  The warp first copies its window's footprint (~0.8 KB: the
// 24 x 24, 12 x 12 and 11 x 6 pixels any feature reads) into its shared
// buffer; a feature slot is then an i16 offset into it (`offs`, -1
// empty), so a vote is shared-memory loads only.  The f64 stage sum is
// exact in any order, so the decision and the confidence are the
// thread-a-window walk's.
__global__ void __launch_bounds__(kDeepThreads)
cascade_deep_kernel(const uint8_t* __restrict__ buf, int l_len, int m_len,
                    const int32_t* __restrict__ base,
                    const int32_t* __restrict__ rowstep,
                    const int16_t* __restrict__ offs,
                    const float* __restrict__ alpha,
                    const float* __restrict__ thresh,
                    const int32_t* __restrict__ stage_end, int weak,
                    int dense, int stages, Footprint fp,
                    uint32_t* __restrict__ bits, float* __restrict__ conf,
                    int words, const uint32_t* __restrict__ list,
                    const int* __restrict__ count) {
  extern __shared__ __align__(16) uint8_t smem[];
  // [alpha (weak) float2 | thresh, ends (stages) | offs (weak, 10) i16 |
  //  a footprint buffer a warp]
  float2* salpha = reinterpret_cast<float2*>(smem);
  float* sthresh = reinterpret_cast<float*>(salpha + weak);
  int* send = reinterpret_cast<int*>(sthresh + stages);
  int16_t* soffs = reinterpret_cast<int16_t*>(send + stages);
  const int tables = fp_stride(weak * 8 + stages * 8 + weak * kSlots * 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* foot = smem + tables + warp * fp_stride(fp.bytes());
  {
    const float2* a = reinterpret_cast<const float2*>(alpha);
    for (int i = threadIdx.x; i < weak; i += kDeepThreads) {
      salpha[i] = __ldg(a + i);
    }
    for (int i = threadIdx.x; i < stages; i += kDeepThreads) {
      sthresh[i] = __ldg(thresh + i);
      send[i] = __ldg(stage_end + i);
    }
    // the offsets as 4-byte pairs (weak * 10 i16 is even)
    const uint32_t* c = reinterpret_cast<const uint32_t*>(offs);
    uint32_t* d = reinterpret_cast<uint32_t*>(soffs);
    for (int i = threadIdx.x; i < weak * kSlots / 2; i += kDeepThreads) {
      d[i] = __ldg(c + i);
    }
  }
  __syncthreads();
  const int total = *count;
  const int k0 = dense > 0 ? send[dense - 1] : 0;
  for (int i = blockIdx.x * kDeepWarps + warp; i < total;
       i += gridDim.x * kDeepWarps) {
    const uint32_t item = list[i];
    const int64_t n = item / static_cast<uint32_t>(m_len);
    const int m = static_cast<int>(item - n * m_len);
    const uint8_t* p = buf + n * l_len;
    uint8_t* dst = foot;
#pragma unroll
    for (int z = 0; z < 3; ++z) {
      const uint8_t* src = p + __ldg(base + 3 * m + z);
      const int r = __ldg(rowstep + 3 * m + z);
      if (lane < fp.w[z]) {
        for (int y = 0; y < fp.h[z]; ++y) {
          dst[y * fp.w[z] + lane] = __ldg(src + y * r + lane);
        }
      }
      dst += fp.w[z] * fp.h[z];
    }
    __syncwarp();
    bool live = true;
    double total_sum = 0.0;
    int k = k0;
    for (int s = dense; s < stages; ++s) {
      const int end = send[s];
      double part = 0.0;
      for (int j = k + lane; j < end; j += 64) {
        // two weak classifiers a turn: the second at a valid index, its
        // vote dropped past the stage, so both chains of loads overlap
        const int j2 = min(j + 32, end - 1);
        const float v1 = foot_vote(foot, soffs, salpha, j);
        const float v2 = foot_vote(foot, soffs, salpha, j2);
        part += static_cast<double>(v1);
        if (j + 32 < end) part += static_cast<double>(v2);
      }
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      total_sum = __shfl_sync(0xffffffffu, part, 0);  // one value a warp
      k = end;
      if (total_sum < static_cast<double>(sthresh[s])) {
        live = false;
        break;
      }
    }
    if (lane == 0) {
      if (live) {
        conf[n * m_len + m] = __double2float_rn(total_sum);
      } else {
        atomicAnd(bits + n * words + (m >> 5), ~(1u << (m & 31)));
      }
    }
    __syncwarp();  // every lane is done with the footprint
  }
}

int deep_smem(int weak, int stages, const Footprint& fp) {
  return fp_stride(weak * 8 + stages * 8 + weak * kSlots * 2) +
         kDeepWarps * fp_stride(fp.bytes());
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

// The dense stages: the leading `dense` stages (their weak classifiers
// dense_weak <= kDenseWeak) from the host arrays codes (dense_weak, 10) i32
// (empty slots filled, see DenseProg), side (dense_weak,) i32, alpha
// (dense_weak, 2) f32, thresh and ends (dense,), ext (3,) i32 (the plane
// rows a window row reads), tile (windows a CTA takes) with tile_bytes (a
// tile's staged rows, at most, with alignment), and the scale steps'
// geometry scales (n_scales, 9) i32 with tile_first (n_scales + 1,) i32
// (scale g's tiles: `tile` windows each from the word of its first one),
// all copied into the launch's parameters.  buf (n, l_len) u8; bits (n,
// words) u32 with words = ceil(m_len / 32) and the survivor count (one
// i32), both zeroed here on the stream (one memset where the count
// follows the bitmap); conf (n, m_len) f32, list (n * m_len,) u32
// (scratch).  deep: stages follow, so dense survivors go onto the list.
extern "C" int cascade_dense_launch(const void* codes, const void* side,
                                    const void* alpha, const void* thresh,
                                    const void* ends, int dense,
                                    int dense_weak, const void* ext, int tile,
                                    int tile_bytes, const void* scales,
                                    const void* tile_first, int n_scales,
                                    int deep, const void* buf, void* bits,
                                    void* count, void* conf, void* list,
                                    int n, int l_len, int m_len,
                                    void* stream) {
  if (n > 65535 || dense < 0 || dense > kDense || dense_weak < 0 ||
      dense_weak > kDenseWeak || n_scales < 0 || n_scales > kMaxScales ||
      tile_bytes < 0 || kSlotBytes + tile_bytes > kSmemLimit || tile <= 0 ||
      tile > kMaxTile || tile % kThreads != 0 ||
      static_cast<int64_t>(n) * m_len > 0xFFFFFFFFll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || m_len <= 0 || n_scales == 0) return 0;
  DenseProg prog = {};
  prog.stages = dense;
  prog.scales = n_scales;
  for (int s = 0; s < dense; ++s) {
    prog.end[s] = static_cast<const int32_t*>(ends)[s];
    prog.thresh[s] = static_cast<const float*>(thresh)[s];
  }
  for (int i = 0; i < dense_weak * kSlots; ++i) {
    prog.code[i] = static_cast<const int32_t*>(codes)[i];
  }
  for (int i = 0; i < dense_weak; ++i) {
    prog.side[i] = static_cast<const int32_t*>(side)[i];
  }
  for (int z = 0; z < 3; ++z) prog.ext[z] = static_cast<const int32_t*>(ext)[z];
  prog.tile = tile;
  for (int i = 0; i < dense_weak * 2; ++i) {
    prog.alpha[i] = static_cast<const float*>(alpha)[i];
  }
  for (int i = 0; i <= n_scales; ++i) {
    prog.tile_first[i] = static_cast<const int32_t*>(tile_first)[i];
  }
  for (int i = 0; i < n_scales * kScaleCols; ++i) {
    prog.scale[i] = static_cast<const int32_t*>(scales)[i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (m_len + 31) / 32;
  const size_t bit_bytes = static_cast<size_t>(n) * words * sizeof(uint32_t);
  uint32_t* b = static_cast<uint32_t*>(bits);
  cudaError_t err;
  if (count == static_cast<void*>(b + static_cast<size_t>(n) * words)) {
    err = cudaMemsetAsync(bits, 0, bit_bytes + sizeof(int), s);
  } else {
    err = cudaMemsetAsync(bits, 0, bit_bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(count, 0, sizeof(int), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = kSlotBytes + tile_bytes;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(cascade_dense_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  const dim3 grid(prog.tile_first[n_scales], n);
  cascade_dense_kernel<<<grid, kThreads, smem, s>>>(
      prog, static_cast<const uint8_t*>(buf), l_len, m_len, n, deep != 0, b,
      static_cast<float*>(conf), words, static_cast<uint32_t*>(list),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// The deep stages (stages dense.. of `stages`; weak classifiers in all) of
// the survivors cascade_dense_launch listed: base / rowstep (m_len, 3) i32,
// offs (weak, 10) i16 (a slot's offset in the footprint of w[z] x h[z]
// bytes a plane z, -1 empty; each w[z] <= 32), alpha (weak, 2) f32,
// thresh, stage_end (stages,); bits, count, conf and list as there.  One
// CTA an SM (`sms`).
extern "C" int cascade_deep_launch(const void* buf, const void* base,
                                   const void* rowstep, const void* offs,
                                   const void* alpha, const void* thresh,
                                   const void* stage_end, int weak,
                                   int dense, int stages, int w0, int h0,
                                   int w1, int h1, int w2, int h2,
                                   void* bits, const void* count, void* conf,
                                   const void* list, int n, int l_len,
                                   int m_len, int sms, void* stream) {
  const Footprint fp = {{w0, w1, w2}, {h0, h1, h2}};
  const int smem = deep_smem(weak, stages, fp);
  if (n > 65535 || sms <= 0 || smem > kSmemLimit || dense < 0 ||
      dense > stages || (weak * kSlots) % 2 != 0 || w0 > 32 || w1 > 32 ||
      w2 > 32 || w0 < 0 || w1 < 0 || w2 < 0 || h0 < 0 || h1 < 0 || h2 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || m_len <= 0 || stages <= dense) return 0;
  cudaFuncSetAttribute(cascade_deep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cascade_deep_kernel<<<sms, kDeepThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), l_len, m_len,
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(rowstep),
      static_cast<const int16_t*>(offs), static_cast<const float*>(alpha),
      static_cast<const float*>(thresh), static_cast<const int32_t*>(stage_end),
      weak, dense, stages, fp, static_cast<uint32_t*>(bits),
      static_cast<float*>(conf), (m_len + 31) / 32,
      static_cast<const uint32_t*>(list), static_cast<const int*>(count));
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
