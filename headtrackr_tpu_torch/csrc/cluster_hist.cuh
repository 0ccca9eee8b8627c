// The cluster histogram's machinery for Hopper (sm_90a), shared by the
// kernels that count one 4096-bin histogram a stream with a thread-block
// cluster of C CTAs (histpdf.cu: hist4096 and histpdf_band; histbins.cu:
// hist_bins):
//   - each counting CTA zeroes its own 16 KB shared i32 histogram
//     (zero_hist) and adds runs of equal bins to it, one shared atomic a
//     run (Run, count16);
//   - after a cluster barrier (sm90::cluster_sync) each CTA sums its 4096 / C
//     bins over the counting peers through distributed shared memory
//     (reduce_slice: mapa + ld.shared::cluster) and writes them out;
//   - a last cluster barrier keeps every CTA's histogram alive until its
//     peers have read it.
// Integer sums in any order are exact, so no float atomic is needed (F5).
// sm90::launch_cluster launches such a kernel over grid (C, n) in clusters
// of C (sm90.cuh holds the barrier and the launch, which meanshift.cu uses
// too).  The row loader (count_rows: a rect's rows in 16-pixel units of
// three 16-byte loads, its share of them by cta_share) and the pixel bins
// (rgb_bin, bin_of, bins16) serve histpdf.cu and handoff.cu.
// Header only; each .cu that includes it builds on its own.

#pragma once

#include <cstdint>

#include "band.cuh"
#include "sm90.cuh"

namespace chist {

constexpr int kBins = 4096;
constexpr int kMaxCluster = 16;
// pixels a counting CTA takes at least (as kernels/histpdf.py _MIN_CTA_PX)
constexpr int kMinCtaPx = 3072;

__device__ __forceinline__ int rgb_bin(const uint8_t* px) {
  return (static_cast<int>(px[0] >> 4) << 8) |
         (static_cast<int>(px[1] >> 4) << 4) |
         static_cast<int>(px[2] >> 4);
}

__device__ __forceinline__ int bin_of(uint32_t R, uint32_t G, uint32_t B) {
  return static_cast<int>(((R >> 4) << 8) | ((G >> 4) << 4) | (B >> 4));
}

// A thread's pending run of equal bins, added to the histogram when the bin
// changes and at the end.
struct Run {
  int bin = -1;
  int count = 0;

  __device__ __forceinline__ void add(int b, int32_t* hist) {
    if (b == bin) {
      ++count;
    } else {
      if (count) atomicAdd(&hist[bin], count);
      bin = b;
      count = 1;
    }
  }
  __device__ __forceinline__ void flush(int32_t* hist) {
    if (count) atomicAdd(&hist[bin], count);
  }
};

// Add one unit's 16 bins (-1: none) to the histogram through the thread's
// run.  (tools/torch_histpdf_variants.py swaps this body, in its builds of
// histpdf.cu, for warp-collective orders, which histpdf.cu's block-uniform
// count_rows loop allows.)
__device__ __forceinline__ void count16(const int (&b)[16], Run& run,
                                        int32_t* hist) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (b[j] >= 0) run.add(b[j], hist);
  }
}

// Zero this CTA's 16 KB histogram (16-byte aligned) before any thread
// counts into it.
__device__ __forceinline__ void zero_hist(int32_t* hist) {
  int4* h4 = reinterpret_cast<int4*>(hist);
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) {
    h4[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
}

// This CTA's slice of the bins, [rank 4096 / c, (rank + 1) 4096 / c),
// summed over the histograms of the cluster's first `active` CTAs, four
// bins at a time: f(bin, counts of bin .. bin + 3).
template <class F>
__device__ __forceinline__ void reduce_slice(const int32_t* hist, int c,
                                             uint32_t rank, int active,
                                             F&& f) {
  const int slice = kBins / c;
  const int lo = static_cast<int>(rank) * slice;
  for (int i = threadIdx.x; i < slice / 4; i += blockDim.x) {
    int4 k = make_int4(0, 0, 0, 0);
    for (int p = 0; p < active; ++p) {
      const int4 v =
          sm90::ld_cluster_v4(sm90::map_rank(hist + lo + 4 * i, p));
      k.x += v.x;
      k.y += v.y;
      k.z += v.z;
      k.w += v.w;
    }
    f(lo + 4 * i, k);
  }
}

// n streams (the grid's y, at most 65,535) in clusters of c CTAs, c a power
// of two <= 16 (so that 4096 / c bins split into whole int4s).
inline bool cluster_ok(int n, int c) {
  return n <= 65535 && c >= 1 && c <= kMaxCluster && (c & (c - 1)) == 0;
}

// The rows of a rect's rh rows that CTA `rank` of a cluster of c counts:
// [r0, r0 + nrows), over the first `active` CTAs (kernels/histpdf.py
// cluster_rows is the same split).
struct Share {
  int r0, nrows, active;
};

// The CTAs of a cluster of c that count a rect of `rows` rows and `npx`
// pixels: one a kMinCtaPx pixels, at most one a row, at least one.
__host__ __device__ __forceinline__ int active_ctas(int64_t npx, int64_t rows,
                                                    int c) {
  int64_t a = (npx + kMinCtaPx - 1) / kMinCtaPx;
  a = a < c ? a : c;
  a = a < rows ? a : rows;
  return a > 1 ? static_cast<int>(a) : 1;
}

__device__ __forceinline__ Share cta_share(const band::Rect& rc, int c,
                                           int rank) {
  const int a = active_ctas(rc.rw * rc.rh, rc.rh, c);
  const int rh = static_cast<int>(rc.rh);
  if (rank >= a) return {rh, 0, a};
  const int r0 = rank * rh / a;
  return {r0, (rank + 1) * rh / a - r0, a};
}

// The bins of 16 neighbouring pixels from their 48 bytes q0, q1, q2.
__device__ __forceinline__ void decode16(const uint4& q0, const uint4& q1,
                                         const uint4& q2, int (&b)[16]) {
  const uint32_t v[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                          q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // little-endian: byte k of the run is byte k % 4 of v[k / 4]
    const uint32_t r = (v[(3 * j) / 4] >> (8 * ((3 * j) % 4))) & 0xFF;
    const uint32_t g = (v[(3 * j + 1) / 4] >> (8 * ((3 * j + 1) % 4))) & 0xFF;
    const uint32_t bl = (v[(3 * j + 2) / 4] >> (8 * ((3 * j + 2) % 4))) & 0xFF;
    b[j] = bin_of(r, g, bl);
  }
}

// The bins of 16 neighbouring pixels: 48 bytes from a 16-byte aligned p.
__device__ __forceinline__ void bins16(const uint8_t* p, int (&b)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  decode16(__ldg(q), __ldg(q + 1), __ldg(q + 2), b);
}

// Keep a chunk's 16 bins at s as u16, in the widest stores its alignment
// allows: two 16-byte stores, eight 4-byte ones, or (s 2 bytes past a
// 4-byte boundary) one u16, seven 4-byte stores and one u16.
__device__ __forceinline__ void stash16(uint16_t* s, const int (&b)[16]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  if ((a & 15) == 0) {
    uint4* s4 = reinterpret_cast<uint4*>(s);
    s4[0] = make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16,
                       b[4] | b[5] << 16, b[6] | b[7] << 16);
    s4[1] = make_uint4(b[8] | b[9] << 16, b[10] | b[11] << 16,
                       b[12] | b[13] << 16, b[14] | b[15] << 16);
  } else if ((a & 3) == 0) {
    uint32_t* s1 = reinterpret_cast<uint32_t*>(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) s1[j] = b[2 * j] | b[2 * j + 1] << 16;
  } else {
    s[0] = static_cast<uint16_t>(b[0]);
    uint32_t* s1 = reinterpret_cast<uint32_t*>(s + 1);
#pragma unroll
    for (int j = 0; j < 7; ++j) s1[j] = b[2 * j + 1] | b[2 * j + 2] << 16;
    s[15] = static_cast<uint16_t>(b[15]);
  }
}

// Count rows [r0, r0 + nrows) of the rect into hist; with kStash also keep
// each pixel's bin, stash[(row - r0) * rw + x].  A row is rw / 16 + 2
// units: unit 0 its unaligned head, units 1..body its 16-pixel chunks,
// unit body + 1 its tail (head and tail < 16 pixels, taken one pixel at a
// time but with every load issued before the first is used).  Units are
// dealt to threads in order, advanced without division; the loop's trip
// count is uniform over the block.
template <bool kStash>
__device__ __forceinline__ void count_rows(const uint8_t* f, int w,
                                           const band::Rect& rc, int r0,
                                           int nrows, int32_t* hist,
                                           uint16_t* stash) {
  const int rw = static_cast<int>(rc.rw);
  const int units = rw / 16 + 2;
  const int total = nrows * units;
  const int step_r = blockDim.x / units;
  const int step_c = blockDim.x - step_r * units;
  int row = threadIdx.x / units;
  int col = threadIdx.x - row * units;
  chist::Run run;
  for (int base = 0; base < total; base += blockDim.x) {
    int b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = -1;
    if (base + static_cast<int>(threadIdx.x) < total) {
      const uint8_t* p = f + ((rc.y0 + r0 + row) * w + rc.x0) * 3;
      // 3 head == -p (mod 16): the pixel at `head` starts 16-byte aligned
      int head = static_cast<int>(
          ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) * 11) & 15);
      head = head < rw ? head : rw;
      const int body = (rw - head) / 16;
      const int tail = head + 16 * body;
      uint16_t* s = stash + row * rw;
      if (col == 0 || col == body + 1) {
        const int x = col == 0 ? 0 : tail;
        const int m = col == 0 ? head : rw - tail;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j < m) b[j] = rgb_bin(p + 3 * (x + j));
        }
        if constexpr (kStash) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < m) s[x + j] = static_cast<uint16_t>(b[j]);
          }
        }
      } else if (col <= body) {
        const int x = head + 16 * (col - 1);
        bins16(p + 3 * x, b);
        if constexpr (kStash) stash16(s + x, b);
      }
    }
    chist::count16(b, run, hist);
    col += step_c;
    row += step_r;
    if (col >= units) {
      col -= units;
      ++row;
    }
  }
  run.flush(hist);
}

}  // namespace chist
