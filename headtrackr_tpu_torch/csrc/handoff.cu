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
//   - What held the first design back (a CTA a stream): the audit walked
//     the frame outside the band a warp a row with byte loads, about one
//     load in flight a warp, so at the relock bucket's 8 slots 8 SMs spent
//     0.037 ms (graph replay, NVIDIA H100 80GB HBM3 at 700 W, PERF.md) on
//     64,512 pixels a switching stream.
//   - Design: a thread-block cluster of P CTAs a stream (P from
//     kernels/handoff.py pick_split, the rule of frame_prep's: 16 at the
//     relock bucket, 1 past 132 streams), the stream on grid x (cluster c
//     is CTAs c P .. c P + P - 1: no limit of 65,535 streams).  Each CTA
//     takes the detection's result, the switch and the rect (rank 0 writes
//     the result and the mode).  A stream that does not switch copies its
//     camshift rows, a 4096 / P slice of the histogram row a CTA.  One
//     that switches counts the rect (clamped as histpdf_band's hist-only
//     mode clamps it, band.cuh clamped_rect) with the cluster histogram's
//     row loader (cluster_hist.cuh count_rows: 16-pixel units of three
//     16-byte loads, runs of equal bins one shared atomic each), the rows
//     split over the first `active` CTAs (cta_share: one a 3,072 pixels);
//     after a cluster barrier each CTA sums its 4096 / P bins over the
//     counting peers through distributed shared memory (integer sums:
//     exact in any order, F5), writes them as f32 and, with the audit,
//     builds their words of the 4096-bit model-bin mask (shuffles over 8
//     lanes) and stores them into every peer's mask.  After a second
//     barrier each CTA scans its share of the frame's rows (rank k: rows
//     [k H / P, (k + 1) H / P)) outside the band placed for the rect (the
//     one placement rule, band.cuh place_band: models/camshift.py
//     band_rect), 16 pixels a thread a unit (three 16-byte loads where the
//     frame is 16-byte aligned and W % 16 == 0, else byte loads),
//     kUnroll units in flight, a unit inside the band skipped unread, each
//     pixel's bin tested against its own copy of the mask.  The first
//     model-colored pixel sets a flag in rank 0's shared memory, which
//     every thread polls between its steps, so the cluster stops early;
//     after a last barrier rank 0 writes band_dirty.  An empty rect (a VJ
//     miss) counts nothing, so its mask is empty, nothing is scanned and
//     band_dirty is False.
//   - The frame's row is min(slot, N - 1): a slot of N is padding, whose
//     result the caller drops.
//   - In place: given ``frame_at`` (the device address of an i64 word
//     holding the frames' address when the kernel runs: the serving
//     program's parameter block word that tick_select sets to tick k's
//     frames) both frame reads, the rect's rows and the audit's, take the
//     frames there, so the program's bodies copy none.  The rect's row
//     loader finds each row's aligned head itself; the audit takes its
//     16-byte loads where the stream's frame read is 16-byte aligned,
//     tested on the address read, not on the launch's argument.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "cluster_hist.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 4096;
constexpr int kMaxSplit = 16;
constexpr int kUnroll = 2;  // audit units a thread keeps in flight
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
  const long long* frame_at;    // null, or the word holding the frames' address
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
  float* hist;                  // (S, 4096), 16-byte aligned
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

// A barrier of the stream's CTAs: the cluster's, or the CTA's alone.
__device__ __forceinline__ void sync_stream(uint32_t split) {
  if (split > 1) {
    sm90::cluster_sync();
  } else {
    __syncthreads();
  }
}

// ``p`` (this CTA's shared memory) in CTA `rank`'s (itself where the
// stream has one CTA).
template <class T>
__device__ __forceinline__ T* at_rank(T* p, uint32_t rank, uint32_t split) {
  return split > 1 ? sm90::map_peer(p, rank) : p;
}

// The audit of this CTA's rows [y0, y1) of the frame f (h x w): sets
// *seen (rank 0's flag) where a pixel outside the band b has a bin set in
// mask.  16-pixel units, a row
// w / 16 of them (vec: three 16-byte loads) or ceil(w / 16) (byte loads);
// a unit wholly inside the band is skipped unread.  Stops early once
// *seen is set, by this CTA or a peer.
__device__ __forceinline__ void scan_rows(const uint8_t* f, int w, int y0,
                                          int y1, const band::Rect& b,
                                          const uint32_t* mask, bool vec,
                                          volatile int* seen) {
  const int per_row = vec ? w / 16 : (w + 15) / 16;
  const int total = (y1 - y0) * per_row;
  const int bx0 = static_cast<int>(b.x0);
  const int bx1 = static_cast<int>(b.x0 + b.rw);
  const int by0 = static_cast<int>(b.y0);
  const int by1 = static_cast<int>(b.y0 + b.rh);
  for (int q0 = threadIdx.x; q0 < total; q0 += kUnroll * kThreads) {
    if (*seen) return;
    int bins[kUnroll][16];
    int xs[kUnroll];
    bool in_rows[kUnroll];
    uint4 v[kUnroll][3];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int q = q0 + j * kThreads;
      xs[j] = w;  // none
      if (q >= total) continue;
      const int y = y0 + q / per_row;
      const int x = 16 * (q - (q / per_row) * per_row);
      in_rows[j] = y >= by0 && y < by1;
      if (in_rows[j] && x >= bx0 && x + 16 <= bx1) continue;
      xs[j] = x;
      const uint8_t* p = f + (static_cast<long long>(y) * w + x) * 3;
      if (vec) {
        const uint4* p4 = reinterpret_cast<const uint4*>(p);
        v[j][0] = __ldg(p4);
        v[j][1] = __ldg(p4 + 1);
        v[j][2] = __ldg(p4 + 2);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          bins[j][k] = x + k < w ? chist::rgb_bin(p + 3 * k) : -1;
        }
      }
    }
    bool hit = false;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (xs[j] >= w) continue;
      if (vec) chist::decode16(v[j][0], v[j][1], v[j][2], bins[j]);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int x = xs[j] + k;
        const int bin = bins[j][k];
        const bool outside = !in_rows[j] || x < bx0 || x >= bx1;
        hit |= outside && bin >= 0 && ((mask[bin >> 5] >> (bin & 31)) & 1u);
      }
    }
    if (hit) {
      *seen = 1;
      return;
    }
  }
}

// grid (S P), clusters of P CTAs along x: CTA `rank` of stream s.
__global__ void __launch_bounds__(kThreads) handoff_kernel(Args a) {
  __shared__ alignas(16) int32_t hist[kBins];
  __shared__ uint32_t mask[kBins / 32];
  __shared__ int32_t rect[4];
  __shared__ int sw;
  __shared__ int flag;  // rank 0's: a model-colored pixel outside the band
  const uint32_t split = sm90::cluster_ctas();
  const uint32_t rank = sm90::cluster_rank();
  const long long s = blockIdx.x / split;
  const int t = threadIdx.x;
  long long row = a.slots ? a.slots[s] : s;
  row = row < a.n - 1 ? row : a.n - 1;
  const int h = static_cast<int>(a.h), w = static_cast<int>(a.w);
  const uint8_t* frames =
      a.frame_at ? reinterpret_cast<const uint8_t*>(*a.frame_at) : a.frames;
  const uint8_t* f = frames + row * a.h * a.w * 3;
  if (t == 0) {
    if (a.rect) {
      for (int i = 0; i < 4; ++i) rect[i] = a.rect[4 * s + i];
      sw = 1;
    } else {
      // every load issued at once, the selects after them
      const bool found =
          static_cast<const uint8_t*>(a.found.p)[s * a.found.s] != 0;
      const float c = plane_f(a.conf, s);
      const float raw[4] = {plane_f(a.x, s), plane_f(a.y, s),
                            plane_f(a.bw, s), plane_f(a.bh, s)};
      const bool vj = a.entry_mode[s] == kModeVJ;
      const float conf = found ? c : kNoConf;
      const float box[4] = {found ? raw[0] : 0.0f, found ? raw[1] : 0.0f,
                            found ? raw[2] : 0.0f, found ? raw[3] : 0.0f};
      sw = vj && conf > kThreshold;
      for (int i = 0; i < 4; ++i) {
        rect[i] = static_cast<int32_t>(floorf(box[i]));
        if (rank == 0) a.res[i][s] = vj ? box[i] : 0.0f;
      }
      if (rank == 0) {
        a.res[4][s] = 0.0f;
        a.res[5][s] = vj ? conf : kNoConf;
        a.mode_out[s] = vj ? (sw ? kModeCS : kModeVJ) : a.mode_in[s];
      }
    }
  }
  __syncthreads();
  float* out = a.hist + s * kBins;
  const int slice = kBins / static_cast<int>(split);
  const int lo = static_cast<int>(rank) * slice;
  if (!sw) {  // the stream keeps its camshift rows, a slice a CTA
    const float* old = a.old_hist + s * kBins;
    if (reinterpret_cast<uintptr_t>(old) % 16 == 0) {
      for (int i = t; i < slice / 4; i += kThreads) {
        reinterpret_cast<float4*>(out + lo)[i] =
            reinterpret_cast<const float4*>(old + lo)[i];
      }
    } else {
      for (int i = t; i < slice; i += kThreads) out[lo + i] = old[lo + i];
    }
    if (rank != 0) return;
    if (t < 4) a.win[4 * s + t] = a.old_win[4 * s + t];
    if (t >= 4 && t < 8) a.track[t - 4][s] = a.old_track[t - 4][s];
    if (t == 8) a.angle[s] = a.old_angle[s];
    if (t == 9 && a.dirty) a.dirty[s] = a.old_dirty[s];
    return;
  }
  const band::Rect rc = band::clamped_rect(rect, h, w);
  const chist::Share sh = chist::cta_share(rc, split, rank);
  if (static_cast<int>(rank) < sh.active) {
    chist::zero_hist(hist);
    chist::count_rows<false>(f, w, rc, sh.r0, sh.nrows, hist, nullptr);
  }
  if (t == 0) flag = 0;
  // every CTA's counts are in its shared memory, visible to the cluster
  sync_stream(split);

  // this CTA's slice of the bins, summed over the counting peers; with
  // the audit its words of the model-bin mask, into every CTA's mask
  for (int i = t; i < slice / 4; i += kThreads) {
    int4 k = make_int4(0, 0, 0, 0);
    for (int p = 0; p < sh.active; ++p) {
      const int4 v = *reinterpret_cast<const int4*>(
          at_rank(hist + lo + 4 * i, p, split));
      k.x += v.x;
      k.y += v.y;
      k.z += v.z;
      k.w += v.w;
    }
    reinterpret_cast<float4*>(out + lo)[i] =
        make_float4(static_cast<float>(k.x), static_cast<float>(k.y),
                    static_cast<float>(k.z), static_cast<float>(k.w));
    if (a.dirty) {
      // bins lo + 4 i .. + 3 are bits 4 (i % 8) .. of word (lo + 4 i) / 32
      uint32_t word = ((k.x > 0) | (k.y > 0) << 1 | (k.z > 0) << 2 |
                       (k.w > 0) << 3) << (4 * (i & 7));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      if ((i & 7) == 0) {
        for (uint32_t p = 0; p < split; ++p) {
          *at_rank(&mask[(lo + 4 * i) / 32], p, split) = word;
        }
      }
    }
  }
  if (rank == 0) {
    if (t < 4) a.win[4 * s + t] = rect[t];
    if (t >= 4 && t < 8) a.track[t - 4][s] = 0;
    if (t == 8) a.angle[s] = 0.0f;
  }
  // no peer reads this CTA's counts any more, and every mask word landed
  sync_stream(split);
  if (!a.dirty) return;

  // the audit: a model-colored pixel outside the band placed for the rect
  if (rc.rw * rc.rh > 0) {  // an empty rect's mask is empty
    const band::Rect b = band::place_band(rect, h, w, a.band_h, a.band_w);
    const bool vec = reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                     w % 16 == 0;
    volatile int* seen = at_rank(&flag, 0, split);
    scan_rows(f, w, static_cast<int>(rank) * h / static_cast<int>(split),
              (static_cast<int>(rank) + 1) * h / static_cast<int>(split), b,
              mask, vec, seen);
  }
  // every CTA's finding is in rank 0's flag
  sync_stream(split);
  if (rank == 0 && t == 0) a.dirty[s] = flag ? 1 : 0;
}

}  // namespace

extern "C" int handoff_args_bytes() { return sizeof(Args); }

// Clusters of ``split`` CTAs (a power of two <= 16), one a stream:
// ``streams`` of them (S), from ``args`` (Args).
extern "C" int handoff_launch(const void* args, int streams, int split,
                              void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (streams < 1 || a.n < 1 || a.h < 1 || a.w < 1 || a.frames == nullptr ||
      (a.dirty && (a.band_h < 1 || a.band_w < 1)) ||
      (a.rect == nullptr && (a.found.p == nullptr || a.old_hist == nullptr)) ||
      reinterpret_cast<uintptr_t>(a.hist) % 16 != 0 || split < 1 ||
      split > kMaxSplit || (split & (split - 1)) != 0 ||
      static_cast<long long>(streams) * split > INT_MAX ||
      a.h * a.w * 3 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sm90::launch_cluster(
      handoff_kernel, dim3(static_cast<unsigned>(streams) * split), split,
      kThreads, 0, static_cast<cudaStream_t>(stream), a);
}
