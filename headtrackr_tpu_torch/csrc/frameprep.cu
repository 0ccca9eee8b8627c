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
//     ms on an H100 SXM at 3.35 TB/s; the arithmetic is a few dot products
//     of bytes and a division by 100 a pixel.
//   - What held the first design back (a CTA a stream, 4-byte loads): the
//     relock bucket's 8 streams ran on 8 of the 132 SMs, each CTA walking
//     its 230 KB at ~16 GB/s (0.0146 ms graph replay on an NVIDIA H100
//     80GB HBM3 at 700 W, PERF.md), so latency, not bytes, set the time.
//   - Design: a thread-block cluster of P CTAs a stream (P from
//     kernels/frameprep.py pick_split: about two waves of CTAs over the
//     card, a power of two <= 16; 16 at the relock bucket, 1 past 132
//     streams), the stream on grid x (cluster c is CTAs c P .. c P + P - 1,
//     so no limit of 65,535 streams).  Each CTA takes a contiguous share
//     of the frame's units: 16 pixels (three 16-byte loads, one 16-byte
//     gray store) where the stream's frame, the gray plane and H W allow
//     it, else 4 pixels (4-byte loads) or one; each thread keeps kUnroll
//     units' loads in flight.  The channel sums and the gray values are
//     byte dot products (__dp4a), exact integers.  Each CTA reduces its
//     sums (warp shuffles, then shared memory) and stores them into rank
//     0's shared memory through distributed shared memory; after a cluster
//     barrier rank 0 adds the P partial sums in rank order (exact u64, so
//     the split changes no bit) and one thread takes the means in f64 and
//     rounds once to f32, every operation an _rn intrinsic in the twin's
//     order ((m_r + m_g) + m_b) / 3 (no contraction), and writes the stream's
//     ring, wb_n and mode: the WB branch's where the stream enters in WB,
//     its own rows elsewhere (rank 0's first thread copies those state
//     rows into shared memory by cp.async at its start, so they land
//     while the frame is read).  P = 1 (the wbtrack tick's thousands of
//     streams) is a plain launch with no cluster barrier.
//   - The frame's row is min(slot, N - 1): a slot of N is padding, whose
//     result the caller drops.
//   - In place: given ``frame_at`` (the device address of an i64 word
//     holding the frames' address when the kernel runs: the serving
//     program's parameter block word that tick_select sets to tick k's
//     frames) the kernel reads the frames there, so the program's bodies
//     copy none.  That address exists only on the card, and a captured
//     graph replays its launch for every later scan, so the unit cannot
//     be chosen on the host from it: the launcher picks the widest unit
//     that H W and the gray plane allow (kMaxPx), and each CTA takes the
//     widest of those that its stream's frame address allows (16-byte
//     aligned: 16 pixels; 4-byte: 4; else one).  The sums are exact
//     integers, so the unit changes no bit.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // units a thread keeps in flight
constexpr int kMaxSplit = 16;
constexpr int kRing = 15;  // PWB_LENGTH
constexpr int kModeWB = 0, kModeVJ = 1;

// kernels/frameprep.py _Args mirrors it field for field.
struct Args {
  const uint8_t* frames;
  const long long* frame_at;  // null, or the word holding the frames' address
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
};

// Four pixels in three little-endian words (w0 = R0 G0 B0 R1, w1 = G1 B1
// R2 G2, w2 = B2 R3 G3 B3): their channel sums added to s, their gray
// values (30 r + 59 g + 11 b + 50) / 100 packed a byte each.
__device__ __forceinline__ uint32_t quad(uint32_t w0, uint32_t w1,
                                         uint32_t w2, uint32_t (&s)[3]) {
  s[0] = __dp4a(w2, 0x00000100u,
                __dp4a(w1, 0x00010000u, __dp4a(w0, 0x01000001u, s[0])));
  s[1] = __dp4a(w2, 0x00010000u,
                __dp4a(w1, 0x01000001u, __dp4a(w0, 0x00000100u, s[1])));
  s[2] = __dp4a(w2, 0x01000001u,
                __dp4a(w1, 0x00000100u, __dp4a(w0, 0x00010000u, s[2])));
  const uint32_t g0 = __dp4a(w0, 0x000B3B1Eu, 50u) / 100u;
  const uint32_t g1 = __dp4a(w1, 0x00000B3Bu, __dp4a(w0, 0x1E000000u, 50u))
                      / 100u;
  const uint32_t g2 = __dp4a(w2, 0x0000000Bu, __dp4a(w1, 0x3B1E0000u, 50u))
                      / 100u;
  const uint32_t g3 = __dp4a(w2, 0x0B3B1E00u, 50u) / 100u;
  return g0 | (g1 << 8) | (g2 << 16) | (g3 << 24);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This CTA's share [lo, hi) of the frame's units of kPx pixels: channel
// sums into t, gray values into g (or none).
template <int kPx>
__device__ __forceinline__ void sum_share(const uint8_t* f, uint8_t* g,
                                          long long lo, long long hi,
                                          unsigned long long (&t)[3]) {
  for (long long q0 = lo + threadIdx.x; q0 < hi;
       q0 += static_cast<long long>(kUnroll) * kThreads) {
    uint32_t s[3] = {0, 0, 0};
    if constexpr (kPx == 16) {
      const uint4* f16 = reinterpret_cast<const uint4*>(f);
      uint4 v[kUnroll][3];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long q = q0 + j * kThreads;
        if (q < hi) {
          v[j][0] = __ldg(f16 + 3 * q);
          v[j][1] = __ldg(f16 + 3 * q + 1);
          v[j][2] = __ldg(f16 + 3 * q + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long q = q0 + j * kThreads;
        if (q < hi) {
          const uint4 a = v[j][0], b = v[j][1], c = v[j][2];
          const uint4 o = make_uint4(quad(a.x, a.y, a.z, s),
                                     quad(a.w, b.x, b.y, s),
                                     quad(b.z, b.w, c.x, s),
                                     quad(c.y, c.z, c.w, s));
          if (g) reinterpret_cast<uint4*>(g)[q] = o;
        }
      }
    } else if constexpr (kPx == 4) {
      const uint32_t* f4 = reinterpret_cast<const uint32_t*>(f);
      uint32_t v[kUnroll][3];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long q = q0 + j * kThreads;
        if (q < hi) {
          v[j][0] = __ldg(f4 + 3 * q);
          v[j][1] = __ldg(f4 + 3 * q + 1);
          v[j][2] = __ldg(f4 + 3 * q + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long q = q0 + j * kThreads;
        if (q < hi) {
          const uint32_t o = quad(v[j][0], v[j][1], v[j][2], s);
          if (g) reinterpret_cast<uint32_t*>(g)[q] = o;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long q = q0 + j * kThreads;
        if (q < hi) {
          const uint32_t r = f[3 * q], gr = f[3 * q + 1], b = f[3 * q + 2];
          s[0] += r;
          s[1] += gr;
          s[2] += b;
          if (g) g[q] = static_cast<uint8_t>((30u * r + 59u * gr + 11u * b +
                                              50u) / 100u);
        }
      }
    }
    for (int c = 0; c < 3; ++c) t[c] += s[c];
  }
}

// CTA `rank` of `split`'s share of the hw pixels of frame f in units of
// kPx pixels (hw % kPx == 0): channel sums into t, gray values into g (or
// none).
template <int kPx>
__device__ __forceinline__ void sum_rank(const uint8_t* f, uint8_t* g,
                                         long long hw, uint32_t rank,
                                         uint32_t split,
                                         unsigned long long (&t)[3]) {
  const long long units = hw / kPx;
  const long long share = (units + split - 1) / split;
  const long long lo = rank * share;
  const long long hi = lo + share < units ? lo + share : units;
  sum_share<kPx>(f, g, lo, hi, t);
}

__device__ __forceinline__ bool aligned_at(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// grid (S P), clusters of P CTAs along x (P = 1: no cluster): CTA `rank`
// of stream s takes its share of the frame; rank 0 joins the sums and
// writes the stream's rows.  kMaxPx: the widest unit (16, 4 or 1 pixels)
// that H W and the gray plane allow; the CTA takes the widest of those
// that its frame's address allows.
template <int kMaxPx>
__global__ void __launch_bounds__(kThreads) frame_prep_kernel(Args a) {
  __shared__ unsigned long long part[kWarps][3];
  __shared__ unsigned long long join[kMaxSplit][3];  // rank 0's: each CTA's
  __shared__ int32_t rows_in[2];                     // mode, wb_n
  __shared__ float ring_in[kRing];
  const uint32_t split = sm90::cluster_ctas();
  const uint32_t rank = sm90::cluster_rank();
  const long long s = blockIdx.x / split;
  if (split > 1) sm90::cluster_arrive_relaxed();
  if (rank == 0 && threadIdx.x == 0) {
    // the stream's state rows, copied while the frame is read
    sm90::cp_async4(&rows_in[0], a.mode + s);
    sm90::cp_async4(&rows_in[1], a.wb_n + s);
    for (int i = 0; i < kRing; ++i) {
      sm90::cp_async4(&ring_in[i], a.ring + s * kRing + i);
    }
  }
  long long row = a.slots ? a.slots[s] : s;
  row = row < a.n - 1 ? row : a.n - 1;
  const long long hw = a.h * a.w;
  const uint8_t* frames =
      a.frame_at ? reinterpret_cast<const uint8_t*>(*a.frame_at) : a.frames;
  const uint8_t* f = frames + row * hw * 3;
  uint8_t* g = a.gray ? a.gray + s * hw : nullptr;
  unsigned long long t[3] = {0, 0, 0};
  if (kMaxPx >= 16 && aligned_at(f, 16)) {
    sum_rank<16>(f, g, hw, rank, split, t);
  } else if (kMaxPx >= 4 && aligned_at(f, 4)) {
    sum_rank<4>(f, g, hw, rank, split, t);
  } else {
    sum_rank<1>(f, g, hw, rank, split, t);
  }
  for (int c = 0; c < 3; ++c) t[c] = warp_sum(t[c]);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    for (int c = 0; c < 3; ++c) part[warp][c] = t[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < 3; ++c) {
      t[c] = 0;
      for (int i = 0; i < kWarps; ++i) t[c] += part[i][c];
    }
  }
  if (split > 1) {
    sm90::cluster_wait();  // every CTA of the cluster has started
    if (threadIdx.x == 0) {
      unsigned long long* dst = sm90::map_peer(&join[rank][0], 0);
      for (int c = 0; c < 3; ++c) dst[c] = t[c];
    }
    sm90::cluster_sync();  // every share's sums are in rank 0's memory
    if (rank != 0 || threadIdx.x != 0) return;
    for (int c = 0; c < 3; ++c) {
      t[c] = 0;
      for (uint32_t k = 0; k < split; ++k) t[c] += join[k][c];
    }
  } else if (threadIdx.x != 0) {
    return;
  }
  // the twin's order: exact sums, f64 means, ((r + g) + b) / 3, one
  // rounding to f32
  const double d = static_cast<double>(hw);
  const double m0 = __ddiv_rn(static_cast<double>(t[0]), d);
  const double m1 = __ddiv_rn(static_cast<double>(t[1]), d);
  const double m2 = __ddiv_rn(static_cast<double>(t[2]), d);
  const float wb = __double2float_rn(
      __ddiv_rn(__dadd_rn(__dadd_rn(m0, m1), m2), 3.0));
  sm90::cp_async_wait_all();
  const int32_t mode = rows_in[0], n_in = rows_in[1];
  const bool is_wb = mode == kModeWB;
  a.wb[s] = (is_wb || (a.wb_vj && mode == kModeVJ)) ? wb : 0.0f;
  const float* old = ring_in;
  float* ring = a.ring_out + s * kRing;
  if (!is_wb) {
    for (int i = 0; i < kRing; ++i) ring[i] = old[i];
    a.wb_n_out[s] = n_in;
    a.mode_out[s] = mode;
    return;
  }
  float v[kRing];
  v[0] = wb;
  for (int i = 1; i < kRing; ++i) v[i] = old[i - 1];
  float hi_v = v[0], lo_v = v[0];
  for (int i = 0; i < kRing; ++i) {
    ring[i] = v[i];
    hi_v = v[i] > hi_v ? v[i] : hi_v;
    lo_v = v[i] < lo_v ? v[i] : lo_v;
  }
  const int32_t n = n_in + 1 < kRing ? n_in + 1 : kRing;
  a.wb_n_out[s] = n;
  a.mode_out[s] =
      (n == kRing && __fsub_rn(hi_v, lo_v) < 2.0f) ? kModeVJ : kModeWB;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kMaxPx>
int launch(const Args& a, int streams, int split, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(streams) * split);
  if (split == 1) {
    frame_prep_kernel<kMaxPx><<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return sm90::launch_cluster(frame_prep_kernel<kMaxPx>, grid, split,
                              kThreads, 0, s, a);
}

}  // namespace

extern "C" int frame_prep_args_bytes() { return sizeof(Args); }

// Clusters of ``split`` CTAs (a power of two <= 16), one a served stream:
// ``streams`` of them (S), from ``args`` (Args).  The widest unit is 16
// pixels where the gray plane is 16-byte aligned and H W % 16 == 0, else 4
// (4-byte alignment, H W % 4 == 0), else one pixel; each CTA narrows it
// to what its frame's address allows (the frames may be read in place).
extern "C" int frame_prep_launch(const void* args, int streams, int split,
                                 void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (streams < 1 || a.n < 1 || a.h < 1 || a.w < 1 || a.frames == nullptr ||
      split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 ||
      static_cast<long long>(streams) * split > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long hw = a.h * a.w;
  const auto s = static_cast<cudaStream_t>(stream);
  if (hw % 16 == 0 && (a.gray == nullptr || aligned(a.gray, 16))) {
    return launch<16>(a, streams, split, s);
  }
  if (hw % 4 == 0 && (a.gray == nullptr || aligned(a.gray, 4))) {
    return launch<4>(a, streams, split, s);
  }
  return launch<1>(a, streams, split, s);
}
