// Camshift pixel kernels for Hopper (sm_90a): the 4096-bin RGB histogram,
// the ratio-weight backprojection and the fused band histogram + weights +
// pdf, over a batch of u8 RGB frames.
//
// hist4096 replaces headtrackr_tpu/kernels/histpdf.py::hist_pallas
// (_hist_kernel, _onehots, _pad_blocks).  The TPU kernel builds hi/lo
// one-hot factors per 7,680-pixel block and contracts them on the MXU into a
// (64, 64) count matrix.  Here the native form is a shared-memory histogram:
//   - Bound: bytes.  One read of the frame, 230 KB of RGB per 320x240
//     stream, 0.019 ms at 256 streams; the arithmetic per pixel is a few
//     shifts and at most one shared-memory atomic.
//   - What held the first design back (one block per 8,192 pixels, flushed
//     by global atomics into a zero-filled buffer, then a cast): ~41k global
//     atomics a stream on spread bins, a 64-bit division and modulo and
//     three byte loads a pixel, and two extra launches.
//   - Design: a thread-block cluster of C CTAs a stream (C from
//     kernels/histpdf.py cluster_split: 2 at 256 streams, 16 at one), the
//     kernel below (cluster_hist_kernel) shared with histpdf_band, its
//     cluster machinery with hist_bins (cluster_hist.cuh).  Each CTA
//     counts a contiguous share of the rect's rows into its own 16 KB
//     shared i32 histogram; after a cluster barrier each CTA sums its
//     4096 / C bins over the peers' histograms through distributed shared
//     memory and writes them as f32 straight to the output.  No global
//     atomics, no memset, no cast launch; integer sums in any order are
//     exact, so the counts are bit-equal to the twin.
//   - What paces it (H100 SXM, PERF.md, tools/torch_histpdf_variants.py):
//     each CTA's fixed cost (zeroing its histogram, reading its slice from
//     every peer, two cluster barriers), so few long CTAs win once the
//     card is full: at 256 streams C = 2 took 0.039 ms on the bench pool,
//     2.1x the bound, C = 8 0.045 and C = 16 0.068.
//
// backproject replaces headtrackr_tpu/kernels/histpdf.py::pdf_pallas
// (_pdf_kernel).  The TPU kernel needs a triple-bf16 split of the weight
// table and three one-hot matmuls to select an exact f32 weight.  Here:
//   - Bound: bytes.  One read of the frame (230 KB) and one write of the f32
//     pdf (300 KB) per 320x240 stream.
//   - Design: each block stages its stream's 16 KB weight table in shared
//     memory, then each thread bins its pixels and loads the weight.  A table
//     load is exact by construction, so no split is needed.  Blocks cover
//     16,384 pixels each so the table load stays small against the pixels.
//   - Ratio form (the camshift step's, replacing the XLA path
//     headtrackr_tpu/ops/histogram.py:141 backprojection_weights): given
//     the model histogram and the current counts instead of weights, each
//     block forms min(model / cur, 1), 0 where cur == 0, as it stages its
//     table (IEEE division, bit-equal to the torch formulation on the
//     card, F6).  The (N, 4096) weights tensor, its write and its read,
//     and the PyTorch operations that made it are gone; a block reads 32
//     KB of tables from L2 instead of 16.
//
// backproject_rect is the same lookup over a per-stream (bh, bw) band (the
// band pdf of the band-local camshift with full-frame histograms), on the
// band configuration's steady tick once a tick.  It takes each stream's
// search window and places the band itself (band.cuh place_band, the
// twin's models/camshift.py band_rect), so the host computes no origin.
//   - Bound: bytes.  At a 96x128 band: 36 KB of RGB in, 48 KB of pdf out
//     and the 16 KB weight row per stream; 0.0078 ms at 256 streams.
//   - Design: a thread-block cluster of kCluster CTAs per stream splits the
//     band's rows.  The stream's 16 KB weight row reaches every CTA's shared
//     memory by TMA: each CTA copies a quarter with .multicast::cluster, so
//     the row is read once a stream, not once a CTA, and no thread stages
//     it.  Row and column loops, advanced without division.  Where the
//     band's rows start 4-byte aligned and its width is a multiple of 4 (the
//     serving path: the band's x origin is a multiple of 8), a thread takes
//     4 pixels at a time: three 4-byte loads, four lookups and one 16-byte
//     store (the placement's x origin is a multiple of 8 except where it is
//     clipped to w - bw).  Any other origin or width takes the
//     pixel-at-a-time loop.
//   - Ratio form: each CTA forms the ratio weights of its quarter of the
//     bins from the model and counts rows (one float4 of each a thread)
//     and stores them into every peer's table through distributed shared
//     memory, as histpdf_band does with its slices; no TMA, no mbarrier.
//
// histpdf_band replaces tools/kernel_experiments.py hp_call (k4) and
// hp7_call (k7), the fused per-stream histogram + min(model/cur, 1) weights +
// pdf, and in hist-only mode hist_call (k3).  On the TPU each grid step is
// one stream, the histogram is a one-hot MXU contraction and the pdf a
// bf16-plane weight matmul.  Here:
//   - Bound: bytes.  At a 96x128 band: 36 KB of RGB in, a 16 KB model in,
//     16 KB of counts and 48 KB of pdf out per stream, 0.0091 ms at 256
//     streams; the frame (X7's workload) 0.0436 ms.
//   - What held the first design back (one 512-thread block a stream): 256
//     blocks on 132 SMs left every load's latency exposed; the band was
//     read twice (counting, then the pdf), each time with a 64-bit division
//     a pixel, and one block formed all 4,096 weights.
//   - Placement: the pdf mode takes each stream's search window; every CTA
//     places the band from it in its prologue (band.cuh place_band, i32
//     arithmetic as models/camshift.py band_rect), so the serving tick
//     runs no operation of the band on the host or as small PyTorch ops.
//   - Design: the same cluster of C CTAs a stream as hist4096 (C from the
//     band's size and the streams: 2 at 256 streams, 4 for one stream's
//     96x128 band).  Each CTA counts its share of the band's rows and keeps
//     each pixel's bin in shared memory as u16 (12 KB at 96x128 and C = 2),
//     so no pixel is read twice.  After a cluster barrier each CTA sums its 4096 / C bins over
//     the peers (distributed shared memory), writes them to cur, forms
//     their weights with IEEE division (bit-equal to the torch formulation)
//     and stores that slice of the table into every peer's 16 KB table.
//     After a second barrier each CTA writes pdf = table[bin] for its rows
//     from the kept bins, 16 bytes a store where the band's width is a
//     multiple of 4.  A share too large to keep (bands past ~96 KB of bins
//     a CTA) bins its rows from the frame again instead, which doubled the
//     time at 96x128 and over the frame when tried everywhere.  Hist-only
//     mode is hist4096's kernel on each rect clamped to the frame.
//   - What paces it (H100 SXM, PERF.md): the same fixed cost a CTA, and
//     the three phases (count, weights, pdf) in turn behind two barriers:
//     0.016-0.017 ms at 96x128, 1.8x the bound.
//   - In place: given ``frame_at``, the device address of a word holding
//     the frames' address (the serving program's parameter block, which
//     its tick_select sets to tick k's frames of a scan), each CTA loads
//     the frames' base from it before its first frame read, so the
//     program's all-CS tick reads each tick's frames where the caller put
//     them and copies none.  The row loads decide their alignment from
//     each row's address on the device, so nothing depends on where the
//     frames lie.
//
// In place: hist4096 and both backproject forms take ``frame_at`` as
// histpdf_band does (frames_base), so the serving program's all-CS body of
// every configuration reads each tick's frames where they lie.  hist4096
// without rects counts the whole frame (no rect is made on the card).
//
// The cluster kernel counts a row as one run of rw x 3 bytes: a thread
// takes 16 neighbouring pixels at a time with three 16-byte loads, and
// another the row's unaligned head or tail (< 16 pixels each) pixel by
// pixel; no division or modulo a pixel.  A thread merges runs of equal bins among the
// pixels it takes (a flat background costs one atomic a run, not a pixel)
// and adds each run with one shared atomic.  A warp match of the run heads
// (__match_any_sync) or of every pixel, the first design's order, was
// slower on every workload measured (tools/torch_histpdf_variants.py).
// The rows a CTA takes: the rect's rh rows split evenly over its first
// `active` CTAs, active = min(C, ceil(rw rh / 3072), rh) (at least 1), so
// a small detection box is counted by one or two CTAs and the rest only
// help reduce; kernels/histpdf.py cluster_rows mirrors the split.
//
// All launch on the caller's stream, allocate nothing and return
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "cluster_hist.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBins = 4096;
constexpr int kThreads = 256;
constexpr int kPdfPixelsPerBlock = 16384;
constexpr int kCluster = 4;  // backproject_rect's CTAs per stream
// the most shared memory a CTA of the cluster histogram spends keeping its
// pixels' bins
constexpr int kMaxStashBytes = 96 * 1024;

// The rect and band rules (band.cuh), one copy for every kernel.
using band::Rect;
using band::clamped_rect;
using band::place_band;
// The pixel bins and the row loader of the cluster histogram
// (cluster_hist.cuh, shared with handoff.cu).
using chist::active_ctas;
using chist::bin_of;
using chist::count_rows;
using chist::cta_share;
using chist::rgb_bin;
using chist::Share;

// The ratio weight min(model / cur, 1), 0 where cur == 0, as
// ops/histogram.py backprojection_weights computes it on the card: IEEE
// round-to-nearest division (F6) and the clamp's rule (a NaN stays NaN, as
// torch.clamp keeps it), so each weight is bit-equal to the twin's.
__device__ __forceinline__ float ratio_weight(float m, float c) {
  if (c == 0.0f) return 0.0f;
  const float q = __fdiv_rn(m, c);
  return q > 1.0f ? 1.0f : q;
}

__device__ __forceinline__ float4 ratio_weights(const float4& m,
                                                const float4& c) {
  return make_float4(ratio_weight(m.x, c.x), ratio_weight(m.y, c.y),
                     ratio_weight(m.z, c.z), ratio_weight(m.w, c.w));
}

// Stage stream n's table in shared memory (kThreads threads): its weight
// row, or (kRatio) the ratio weights of its model row ``table`` and counts
// row ``cur``, formed as they are staged (both 16-byte aligned rows).
// Every load of a thread is issued before its first store: the compiler
// cannot prove that a store into shared memory misses the rows.
template <bool kRatio>
__device__ __forceinline__ const float* stage_table(const float* table,
                                                    const float* cur, int n,
                                                    float4* table4) {
  constexpr int kPer = kBins / 4 / kThreads;  // float4s a thread
  const int64_t row = static_cast<int64_t>(n) * kBins;
  const float4* t4 = reinterpret_cast<const float4*>(table + row);
  const float4* c4 = reinterpret_cast<const float4*>(cur + row);
  float4 t[kPer], c[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    t[j] = __ldg(t4 + threadIdx.x + j * kThreads);
    if constexpr (kRatio) c[j] = __ldg(c4 + threadIdx.x + j * kThreads);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if constexpr (kRatio) t[j] = ratio_weights(t[j], c[j]);
    table4[threadIdx.x + j * kThreads] = t[j];
  }
  __syncthreads();
  return reinterpret_cast<const float*>(table4);
}

// The frames a launch reads: ``frames``, or given ``frame_at`` (the
// device address of an i64 word holding the frames' address when the
// kernel runs: the serving program's parameter block word) that address
// plus ``frame_off`` bytes.
__device__ __forceinline__ const uint8_t* frames_base(
    const uint8_t* frames, const long long* frame_at, long long frame_off) {
  return frame_at ? reinterpret_cast<const uint8_t*>(*frame_at + frame_off)
                  : frames;
}

// grid (blocks, N): block x of stream n looks up its 16,384 pixels in the
// stream's table (the weights, or kRatio: formed from model and cur).
template <bool kRatio>
__global__ void __launch_bounds__(kThreads)
backproject_kernel(const uint8_t* __restrict__ frames,
                   const float* __restrict__ weights,
                   const float* __restrict__ cur, float* __restrict__ out,
                   int64_t hw, const long long* __restrict__ frame_at,
                   long long frame_off) {
  __shared__ float4 table4[kBins / 4];
  const int n = blockIdx.y;
  const float* table = stage_table<kRatio>(weights, cur, n, table4);

  const uint8_t* f = frames_base(frames, frame_at, frame_off) +
                     static_cast<int64_t>(n) * hw * 3;
  float* o = out + static_cast<int64_t>(n) * hw;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kPdfPixelsPerBlock;
  int64_t end = start + kPdfPixelsPerBlock;
  end = end < hw ? end : hw;
  // kUnroll pixels a thread a step, every load before the first store:
  // frames_base's pointer carries no __restrict__, so the compiler cannot
  // hoist a load above a store to ``o`` itself
  constexpr int kUnroll = 4;
  for (int64_t p0 = start + threadIdx.x; p0 < end;
       p0 += kUnroll * kThreads) {
    int b[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t p = p0 + j * kThreads;
      const uint8_t* q = f + 3 * (p < end ? p : p0);
      b[j] = bin_of(__ldg(q), __ldg(q + 1), __ldg(q + 2));
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t p = p0 + j * kThreads;
      if (p < end) o[p] = table[b[j]];
    }
  }
}

// grid (kCluster, N), one cluster a stream: CTA `rank` of stream n places
// the band around the stream's window and looks up its share of its rows.
// The table reaches every CTA's shared memory in quarters, one from each
// CTA: the weights by a multicast TMA copy, or (kRatio) the ratio weights
// of the CTA's quarter of the model and counts rows, formed in registers
// and stored into every peer's table through distributed shared memory.
// vec: the launcher found w and bw multiples of 4 and out 16-byte aligned
// (the kernel checks the frames' 4-byte alignment itself).  frame_at,
// frame_off: frames_base.
template <bool kRatio>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
backproject_rect_kernel(const uint8_t* __restrict__ frames,
                        const float* __restrict__ weights,
                        const float* __restrict__ cur,
                        const int32_t* __restrict__ windows,
                        float* __restrict__ out, int h, int w, int bh, int bw,
                        bool vec, const long long* __restrict__ frame_at,
                        long long frame_off) {
  __shared__ alignas(16) float table[kBins];
  __shared__ uint64_t bar;
  constexpr int kSlice = kBins / kCluster;  // a CTA's quarter of the bins
  static_assert(kSlice / 4 == kThreads, "one float4 of weights a thread");
  const int n = blockIdx.y;
  const uint32_t rank = sm90::cluster_rank();
  const int64_t trow = static_cast<int64_t>(n) * kBins;  // the table rows
  if constexpr (kRatio) {
    // every CTA has started (its table may be written) after the wait; the
    // weights are formed while the cluster arrives
    sm90::cluster_arrive_relaxed();
    const int b = static_cast<int>(rank) * kSlice + 4 * threadIdx.x;
    const float4 wt = ratio_weights(
        *reinterpret_cast<const float4*>(weights + trow + b),
        *reinterpret_cast<const float4*>(cur + trow + b));
    sm90::cluster_wait();
    for (int p = 0; p < kCluster; ++p) {
      sm90::st_cluster_v4(sm90::map_rank(table + b, p), wt);
    }
  } else {
    if (threadIdx.x == 0) {
      sm90::mbar_init(&bar, 1);
      sm90::mbar_init_fence();
    }
    // every CTA's barrier is set before any CTA's copy lands on it
    sm90::cluster_sync();
    if (threadIdx.x == 0) {
      constexpr uint32_t kBytes = kSlice * sizeof(float);
      sm90::mbar_arrive_expect_tx(&bar, kBins * sizeof(float));
      sm90::bulk_load_multicast(
          reinterpret_cast<char*>(table) + rank * kBytes,
          reinterpret_cast<const char*>(weights + trow) + rank * kBytes,
          kBytes, &bar, static_cast<uint16_t>((1u << kCluster) - 1));
    }
  }
  const Rect rc =
      place_band(windows + 4 * static_cast<int64_t>(n), h, w, bh, bw);
  const int x0 = static_cast<int>(rc.x0);
  const int rows = (bh + kCluster - 1) / kCluster;
  const int r0 = static_cast<int>(rank) * rows;
  const int nrows = max(0, min(bh - r0, rows));
  const uint8_t* base = frames_base(frames, frame_at, frame_off);
  const uint8_t* f = base + static_cast<int64_t>(n) * h * w * 3 +
                     (static_cast<int64_t>(rc.y0 + r0) * w + x0) * 3;
  float* o = out + static_cast<int64_t>(n) * bh * bw +
             static_cast<int64_t>(r0) * bw;
  if constexpr (kRatio) {
    // every quarter of every CTA's table has landed
    sm90::cluster_sync();
  } else {
    sm90::mbar_wait(&bar, 0);
    // this CTA holds the whole row, so every copy into it has landed
    sm90::cluster_arrive();
  }

  const bool quad = vec && x0 % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(base) & 3) == 0;
  const int cols = quad ? bw / 4 : bw;  // units a row: 4 pixels or 1
  const int units = nrows * cols;
  // unit u = (row, col), advanced by blockDim.x units a step
  const int step_r = blockDim.x / cols;
  const int step_c = blockDim.x - step_r * cols;
  int row = threadIdx.x / cols;
  int col = threadIdx.x - row * cols;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int src = row * w + (quad ? 4 * col : col);
    const int dst = row * bw + (quad ? 4 * col : col);
    if (quad) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(f + 3 * src);
      const uint32_t a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      // little-endian bytes: a = R0 G0 B0 R1, b = G1 B1 R2 G2, c = B2 R3 G3 B3
      float4 v;
      v.x = table[bin_of(a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF)];
      v.y = table[bin_of(a >> 24, b & 0xFF, (b >> 8) & 0xFF)];
      v.z = table[bin_of((b >> 16) & 0xFF, b >> 24, c & 0xFF)];
      v.w = table[bin_of((c >> 8) & 0xFF, (c >> 16) & 0xFF, c >> 24)];
      *reinterpret_cast<float4*>(o + dst) = v;
    } else {
      const uint8_t* q = f + 3 * src;
      o[dst] = table[bin_of(__ldg(q), __ldg(q + 1), __ldg(q + 2))];
    }
    col += step_c;
    row += step_r;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
  // no CTA exits while a copy it issued may still land in another
  if constexpr (!kRatio) sm90::cluster_wait();
}

// ---- the cluster histogram (hist4096, histpdf_band) ----------------------
// (its machinery and row loader, shared with histbins.cu and handoff.cu:
// cluster_hist.cuh)

// grid (C, N), one cluster of C CTAs a stream (C a power of two <= 16).
// kPdf: histpdf_band's pdf mode (``rects`` the search windows, each CTA
// placing its stream's (bh, bw) band with place_band; model, pdf);
// otherwise the counts of each rect clamped to the frame, or of the whole
// frame where ``rects`` is null (hist4096, hist-only mode).
// kStash: the pdf mode keeps its pixels' bins in shared memory.  vec: bw %
// 4 == 0 and pdf 16-byte aligned.  frame_at: null, or the address of a
// word holding the frames' address, read in place of ``frames``, whose
// first frame lies ``frame_off`` bytes past it (a launch over streams r0..
// of a larger batch: r0 frames).  Dynamic
// shared memory: the i32 histogram, then in pdf mode the f32 weight table
// and the u16 bins.
template <bool kPdf, bool kStash>
__global__ void __launch_bounds__(kThreads)
cluster_hist_kernel(const uint8_t* __restrict__ frames,
                    const int32_t* __restrict__ rects,
                    const float* __restrict__ model, float* __restrict__ cur,
                    float* __restrict__ pdf, int h, int w, int bh, int bw,
                    bool vec, const long long* __restrict__ frame_at,
                    long long frame_off) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* hist = reinterpret_cast<int32_t*>(smem);
  float* table = reinterpret_cast<float*>(smem + kBins * sizeof(int32_t));
  uint16_t* stash = reinterpret_cast<uint16_t*>(smem + 2 * kBins * 4);
  const int n = blockIdx.y;
  const int c = gridDim.x;
  const uint32_t rank = sm90::cluster_rank();
  const int32_t* r = rects + 4 * static_cast<int64_t>(n);
  // hist-only mode without rects: the whole frame
  const Rect rc = kPdf    ? place_band(r, h, w, bh, bw)
                  : rects ? clamped_rect(r, h, w)
                          : Rect{0, 0, w, h};
  const Share sh = cta_share(rc, c, static_cast<int>(rank));
  const uint8_t* f = frames_base(frames, frame_at, frame_off) +
                     static_cast<int64_t>(n) * h * w * 3;
  if (static_cast<int>(rank) < sh.active) {
    chist::zero_hist(hist);
    count_rows<kPdf && kStash>(f, w, rc, sh.r0, sh.nrows, hist, stash);
  }
  // every CTA's counts are in its shared memory, visible to the cluster
  sm90::cluster_sync();

  // this CTA's slice of the bins, summed over the counting peers
  float* cn = cur + static_cast<int64_t>(n) * kBins;
  chist::reduce_slice(hist, c, rank, sh.active, [&](int bin, int4 k) {
    const float4 cf = make_float4(k.x, k.y, k.z, k.w);
    *reinterpret_cast<float4*>(cn + bin) = cf;
    if constexpr (kPdf) {
      // min(model / cur, 1), 0 where cur == 0: IEEE round-to-nearest
      // division, as the torch formulation (ops/histogram.py)
      const float4 m = *reinterpret_cast<const float4*>(
          model + static_cast<int64_t>(n) * kBins + bin);
      const float4 wt = make_float4(
          k.x != 0 ? fminf(__fdiv_rn(m.x, cf.x), 1.0f) : 0.0f,
          k.y != 0 ? fminf(__fdiv_rn(m.y, cf.y), 1.0f) : 0.0f,
          k.z != 0 ? fminf(__fdiv_rn(m.z, cf.z), 1.0f) : 0.0f,
          k.w != 0 ? fminf(__fdiv_rn(m.w, cf.w), 1.0f) : 0.0f);
      for (int p = 0; p < sh.active; ++p) {
        sm90::st_cluster_v4(sm90::map_rank(table + bin, p), wt);
      }
    }
  });
  // no peer reads this CTA's histogram any more, and (pdf mode) every
  // slice of its weight table has landed
  sm90::cluster_sync();
  if constexpr (kPdf) {
    if (sh.nrows == 0) return;
    float* o = pdf + (static_cast<int64_t>(n) * bh + sh.r0) * bw;
    if constexpr (kStash) {
      const int npx = sh.nrows * bw;
      if (vec) {
        const uint2* s2 = reinterpret_cast<const uint2*>(stash);
        float4* o4 = reinterpret_cast<float4*>(o);
        for (int i = threadIdx.x; i < npx / 4; i += blockDim.x) {
          const uint2 q = s2[i];
          o4[i] = make_float4(table[q.x & 0xFFFF], table[q.x >> 16],
                              table[q.y & 0xFFFF], table[q.y >> 16]);
        }
      } else {
        for (int i = threadIdx.x; i < npx; i += blockDim.x) {
          o[i] = table[stash[i]];
        }
      }
    } else {
      for (int row = 0; row < sh.nrows; ++row) {
        const uint8_t* p = f + ((rc.y0 + sh.r0 + row) * w + rc.x0) * 3;
        for (int x = threadIdx.x; x < bw; x += blockDim.x) {
          o[row * bw + x] = table[rgb_bin(p + 3 * x)];
        }
      }
    }
  }
}

// Launch cluster_hist_kernel over grid (c, n) in clusters of c, with `smem`
// bytes of dynamic shared memory.
template <bool kPdf, bool kStash>
int launch_cluster(int n, int c, int smem, cudaStream_t s, const uint8_t* f,
                   const int32_t* r, const float* m, float* cur, float* pdf,
                   int h, int w, int bh, int bw, bool vec,
                   const long long* frame_at, long long frame_off) {
  return sm90::launch_cluster(cluster_hist_kernel<kPdf, kStash>, dim3(c, n),
                              c, kThreads, smem, s, f, r, m, cur, pdf, h, w,
                              bh, bw, vec, frame_at, frame_off);
}

int blocks_for(int64_t pixels, int per_block) {
  const int64_t b = (pixels + per_block - 1) / per_block;
  return b > 0 ? static_cast<int>(b) : 1;
}

}  // namespace

// frames (n, h, w, 3) u8, rects (n, 4) i32 [x, y, w, h] or null, out (n,
// 4096) f32 (16-byte aligned): the counts of each rect clamped to the
// frame, or of the whole frame where rects is null.  One cluster of c CTAs
// a stream (c a power of two, at most 16).  frame_at, frame_off: as
// histpdf_band_launch's (null: the kernel reads ``frames``).
extern "C" int hist4096_launch(const void* frames, const void* rects, void* out,
                               int n, int h, int w, int c,
                               const void* frame_at, long long frame_off,
                               void* stream) {
  if (n <= 0) return 0;
  if (!chist::cluster_ok(n, c) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cluster<false, false>(
      n, c, kBins * sizeof(int32_t), static_cast<cudaStream_t>(stream),
      static_cast<const uint8_t*>(frames), static_cast<const int32_t*>(rects),
      nullptr, static_cast<float*>(out), nullptr, h, w, 0, 0, false,
      static_cast<const long long*>(frame_at), frame_off);
}

// frames (n, h, w, 3) u8, table (n, 4096) f32, out (n, h, w) f32: pdf =
// table[bin] where cur is null, else pdf = min(table / cur, 1)[bin] with
// cur (n, 4096) f32 the current counts and table the model histogram (the
// ratio weights formed as each block stages its table; table and cur
// 16-byte aligned).  n <= 65,535 (the grid's y: kernels/histpdf.py splits
// a larger batch, as it does for every launcher here).  frame_at,
// frame_off: as histpdf_band_launch's.
extern "C" int backproject_launch(const void* frames, const void* table,
                                  void* out, int n, int h, int w,
                                  const void* cur, const void* frame_at,
                                  long long frame_off, void* stream) {
  if (n <= 0) return 0;
  if (n > 65535 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cur) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hw = static_cast<int64_t>(h) * w;
  const dim3 grid(blocks_for(hw, kPdfPixelsPerBlock), n);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* t = static_cast<const float*>(table);
  const auto* cu = static_cast<const float*>(cur);
  auto* o = static_cast<float*>(out);
  const auto* at = static_cast<const long long*>(frame_at);
  if (cu) {
    backproject_kernel<true><<<grid, kThreads, 0, s>>>(f, t, cu, o, hw, at,
                                                       frame_off);
  } else {
    backproject_kernel<false><<<grid, kThreads, 0, s>>>(f, t, cu, o, hw, at,
                                                        frame_off);
  }
  return static_cast<int>(cudaGetLastError());
}

// frames (n, h, w, 3) u8, table (n, 4096) f32, windows (n, 4) i32 [x, y,
// w, h] search windows, each placing its stream's (bh, bw) band
// (place_band; 1 <= bh <= h, 1 <= bw <= w), out (n, bh, bw) f32: the
// table's lookup over the band, the table the weights where cur is null,
// else the model histogram whose ratio weights against the counts cur (n,
// 4096) f32 the kernel forms (table and cur 16-byte aligned).  One cluster
// of kCluster CTAs a stream.  frame_at, frame_off: as
// histpdf_band_launch's.
extern "C" int backproject_rect_launch(const void* frames, const void* table,
                                       const void* windows, void* out, int n,
                                       int h, int w, int bh, int bw,
                                       const void* cur, const void* frame_at,
                                       long long frame_off, void* stream) {
  if (n <= 0) return 0;
  if (n > 65535 || bh < 1 || bw < 1 || bh > h || bw > w ||
      static_cast<int64_t>(h) * w * 3 > INT32_MAX ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cur) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && w % 4 == 0 &&
                   bw % 4 == 0;
  const dim3 grid(kCluster, n);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* t = static_cast<const float*>(table);
  const auto* cu = static_cast<const float*>(cur);
  const auto* r = static_cast<const int32_t*>(windows);
  auto* o = static_cast<float*>(out);
  const auto* at = static_cast<const long long*>(frame_at);
  if (cu) {
    backproject_rect_kernel<true><<<grid, kThreads, 0, s>>>(
        f, t, cu, r, o, h, w, bh, bw, vec, at, frame_off);
  } else {
    backproject_rect_kernel<false><<<grid, kThreads, 0, s>>>(
        f, t, cu, r, o, h, w, bh, bw, vec, at, frame_off);
  }
  return static_cast<int>(cudaGetLastError());
}

// frames (n, h, w, 3) u8, windows (n, 4) i32 [x, y, w, h] search windows,
// each placing its stream's (bh, bw) band (place_band; 1 <= bh <= h, 1 <=
// bw <= w), model (n, 4096)
// f32, cur (n, 4096) f32 (both 16-byte aligned): cur = the band's counts,
// pdf (n, bh, bw) f32 = min(model / cur, 1)[bin].  One cluster of c CTAs a
// stream (c a power of two, at most 16).  frame_at: null, or the device
// address of an i64 word that holds the frames' address when the kernel
// runs (then ``frames`` is not read: the kernel reads the word's address
// plus ``frame_off`` bytes, the first frame of this launch's streams when
// the wrapper splits a batch).  The hist-only mode is hist4096_launch.
extern "C" int histpdf_band_launch(const void* frames, const void* windows,
                                   const void* model, void* cur, void* pdf,
                                   int n, int h, int w, int bh, int bw, int c,
                                   const void* frame_at, long long frame_off,
                                   void* stream) {
  if (n <= 0) return 0;
  if (!chist::cluster_ok(n, c) || model == nullptr || bh < 1 || bw < 1 ||
      bh > h || bw > w || reinterpret_cast<uintptr_t>(cur) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(model) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* r = static_cast<const int32_t*>(windows);
  const auto* m = static_cast<const float*>(model);
  auto* cu = static_cast<float*>(cur);
  auto* o = static_cast<float*>(pdf);
  const auto* at = static_cast<const long long*>(frame_at);
  const bool vec = bw % 4 == 0 && reinterpret_cast<uintptr_t>(pdf) % 16 == 0;
  // the rows of the largest share (cta_share over the band)
  const int active = active_ctas(static_cast<int64_t>(bh) * bw, bh, c);
  const int64_t rows = (bh + active - 1) / active;
  const int64_t stash = (rows * bw * sizeof(uint16_t) + 15) / 16 * 16;
  const int tables = 2 * kBins * 4;
  if (stash <= kMaxStashBytes) {
    return launch_cluster<true, true>(n, c, tables + static_cast<int>(stash),
                                      s, f, r, m, cu, o, h, w, bh, bw, vec,
                                      at, frame_off);
  }
  return launch_cluster<true, false>(n, c, tables, s, f, r, m, cu, o, h, w, bh,
                                     bw, vec, at, frame_off);
}
