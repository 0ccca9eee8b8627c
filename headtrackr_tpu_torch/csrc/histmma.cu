// hist_mma for Hopper (sm_90a): the 4096-bin RGB histogram of each stream's
// rect as an int8 one-hot product on the tensor cores.
//
// It replaces tools/kernel_experiments.py mk_call(hist_k6) (:257, the kernel
// at :277), the Pallas form of the JAX package's default histogram
// (headtrackr_tpu/ops/histogram.py histogram_scan): with bin = 64 hi + lo,
// hist (64, 64) = OneHot(hi)^T @ OneHot(lo) in int8, accumulated in i32.
//   - Semantics: frames (N, H, W, 3) u8 + rects (N, 4) i32 [x, y, w, h] ->
//     (N, 4096) f32 exact counts of the pixels inside each rect clamped to
//     the frame: hist4096's contract, so the two are interchangeable.
//   - Bound: bytes, as for hist4096: a histogram reads each pixel's 3 bytes
//     once, 59 MB at 256 streams x 76,800 px, 0.019 ms at 3.35 TB/s.  The
//     dense one-hot product this formulation would issue (4,096 int8
//     multiply-adds a pixel, 80.5 GMAC, 0.08 ms at the card's dense int8
//     rate) is not the function's work, and the vote below skips most of it.
//   - Design: a warp takes 32 pixels at a time (k = 32 of
//     mma.m16n8k32.s8), one a lane: it reads the step's 96 bytes as 24
//     words, the next 8 steps' words in flight while it bins the current
//     8, and each lane bins its own pixel.  The fragment layouts give
//     thread (g, t) = (lane / 4, lane % 4) the same 8 k-slots in A (the hi
//     one-hot, 4 m-tiles of 16 rows) and B (the lo one-hot, 8 n-tiles of 8
//     columns), so it fetches those 8 pixels' bins with shuffles and sets a
//     byte to 1 where a bin equals the fragment's row (column), four bytes
//     at a time.  The 64 x 64 i32 histogram stays in the mma accumulators
//     (4 x 8 tiles, 128 registers a thread); there are no atomics.  A warp
//     vote finds the (m-tile, n-tile) pairs the 32 pixels fall in and skips
//     the others' mma (their product is zero): a camera frame's pixels
//     share few bins, uniform random ones fill all 32 pairs.  Pixels
//     outside the rect or past the block's span take hi = 0xFF, which
//     matches no row (the TPU kernel's -1 padding).  At the end the block's
//     four warps add their accumulators in shared memory one warp after the
//     other, the block writes its i32 partial histogram, and a second
//     kernel sums each stream's partials in block order and converts to
//     f32: exact and deterministic (no float atomics, F5).
//   - Where it stands: the 128 accumulators put a thread at 194 registers,
//     so an SM holds 8 warps, and each 32-pixel step is a chain of
//     dependent shuffles, byte permutes and the vote; the kernel runs at
//     about 15 times its byte bound (PERF.md).  A wgmma form with the one-hots staged
//     in shared memory is the next design.
//
// The launch is on the caller's stream, allocates nothing (the caller passes
// the (N, blocks, 4096) i32 partials) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBins = 4096;
constexpr uint32_t kOnes = 0x01010101u;
constexpr int kReduceThreads = 256;
constexpr int kSteps = 8;  // 32-pixel steps whose loads a warp issues together

// 0x01 in each byte of x that is zero, else 0x00 (exact for any byte value:
// (b | 0x80) - 1 never borrows from the next byte)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  const uint32_t t = (x | 0x80808080u) - kOnes;
  return (~(t | x) & 0x80808080u) >> 7;
}

// c += A (16 x 32 s8, row) x B (32 x 8 s8, col), i32 accumulators
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Rect {
  int x0, y0, x1, y1;  // clamped to the frame; empty when x1 <= x0 or y1 <= y0
  bool full;           // covers the whole frame
};

constexpr unsigned kFull = 0xFFFFFFFFu;

// This lane's word of the 32-pixel step at c0 (px: the stream's first
// byte): the step's 96 bytes as 24 aligned words, when vec and the step lies
// before `lim`; else 0 (lane_bin then reads its pixel's bytes itself).
__device__ __forceinline__ uint32_t step_word(const uint8_t* __restrict__ px,
                                              int c0, int lane, int lim,
                                              bool vec) {
  if (!vec || c0 + 32 > lim || lane >= 24) return 0u;
  return __ldg(reinterpret_cast<const uint32_t*>(
                   px + 3 * static_cast<int64_t>(c0)) + lane);
}

// This lane's pixel p = c0 + lane: hi | lo << 8, hi = 0xFF when the pixel
// is at or past `lim` or outside the rect.  word: the lane's step_word; on
// the vec path each lane takes its 3 bytes from two of the 24 words.
__device__ __forceinline__ uint32_t lane_bin(const uint8_t* __restrict__ px,
                                             uint32_t word, int c0, int lane,
                                             int lim, int w, const Rect& r,
                                             bool vec) {
  const int p = c0 + lane;
  bool in = p < lim;
  uint32_t rgb = 0;  // R | G << 8 | B << 16
  if (vec && c0 + 32 <= lim) {
    const int b0 = 3 * lane;  // the pixel's first byte in the step
    const uint32_t w0 = __shfl_sync(kFull, word, b0 >> 2);
    const uint32_t w1 = __shfl_sync(kFull, word, (b0 >> 2) + 1);
    const uint32_t o = static_cast<uint32_t>(b0 & 3);
    rgb = __byte_perm(w0, w1, o | (o + 1) << 4 | (o + 2) << 8);
  } else if (in) {
    const uint8_t* q = px + 3 * static_cast<int64_t>(p);
    rgb = __ldg(q) | static_cast<uint32_t>(__ldg(q + 1)) << 8 |
          static_cast<uint32_t>(__ldg(q + 2)) << 16;
  }
  if (!r.full && in) {
    const int y = p / w;
    const int x = p - y * w;
    in = x >= r.x0 && x < r.x1 && y >= r.y0 && y < r.y1;
  }
  const uint32_t R = rgb & 0xFFu, G = (rgb >> 8) & 0xFFu;
  const uint32_t B = (rgb >> 16) & 0xFFu;
  // bin = 256 (R >> 4) + 16 (G >> 4) + (B >> 4); hi = bin >> 6, lo = bin & 63
  const uint32_t hi = in ? (((R >> 4) << 2) | (G >> 6)) : 0xFFu;
  const uint32_t lo = (G & 0x30u) | (B >> 4);
  return hi | lo << 8;
}

// acc += the one-hot product of one 32-pixel step, v: this lane's
// lane_bin.  kDense: every (m-tile, n-tile) pair; else only the pairs the
// step's pixels fall in (the product of an absent pair is zero).
template <bool kDense>
__device__ __forceinline__ void step_mma(int32_t (&acc)[4][8][4], uint32_t v,
                                         uint32_t pairs, int t, uint32_t grep) {
  // k-slots 4t..4t+3 take pixels 8t..8t+3 of the step, 16+4t.. the next
  // 4: their hi (ha, hb) and lo (la, lb) bins, one a byte
  uint32_t q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = __shfl_sync(kFull, v, 8 * t + j);
  const uint32_t p01 = __byte_perm(q[0], q[1], 0x5140);  // hi0 hi1 lo0 lo1
  const uint32_t p23 = __byte_perm(q[2], q[3], 0x5140);
  const uint32_t p45 = __byte_perm(q[4], q[5], 0x5140);
  const uint32_t p67 = __byte_perm(q[6], q[7], 0x5140);
  // x ^ grep ^ C is zero where x == g + C (C's low 3 bits are 0)
  const uint32_t ha = __byte_perm(p01, p23, 0x5410) ^ grep;
  const uint32_t la = __byte_perm(p01, p23, 0x7632) ^ grep;
  const uint32_t hb = __byte_perm(p45, p67, 0x5410) ^ grep;
  const uint32_t lb = __byte_perm(p45, p67, 0x7632) ^ grep;
  uint32_t b[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {  // B: column 8 nt + g of the lo one-hot
    if (kDense || (pairs & (0x01010101u << nt))) {
      b[nt][0] = zero_bytes(la ^ (8u * nt) * kOnes);
      b[nt][1] = zero_bytes(lb ^ (8u * nt) * kOnes);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {  // A: rows 16 mt + g and 16 mt + g + 8
    if (!kDense && !(pairs & (0xFFu << (8 * mt)))) continue;
    const uint32_t r0 = (16u * mt) * kOnes, r1 = (16u * mt + 8u) * kOnes;
    const uint32_t a0 = zero_bytes(ha ^ r0), a1 = zero_bytes(ha ^ r1);
    const uint32_t a2 = zero_bytes(hb ^ r0), a3 = zero_bytes(hb ^ r1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (kDense || (pairs & (1u << (8 * mt + nt)))) {
        mma_s8(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  }
}

// grid (blocks, N), kThreads threads: block s of stream n counts pixels
// [s * block_px, (s + 1) * block_px) and writes partial[n][s][:].
__global__ void __launch_bounds__(kThreads)
hist_mma_kernel(const uint8_t* __restrict__ frames,
                const int32_t* __restrict__ rects,
                int32_t* __restrict__ partial, int h, int w, int block_px,
                bool vec) {
  __shared__ int32_t hist[kBins];
  const int n = blockIdx.y;
  const int s = blockIdx.x;
  const int P = h * w;
  const uint8_t* px = frames + static_cast<int64_t>(n) * P * 3;
  const int64_t rx = rects[4 * n], ry = rects[4 * n + 1];
  const int64_t rw = rects[4 * n + 2], rh = rects[4 * n + 3];
  Rect r;
  r.x0 = static_cast<int>(rx < 0 ? 0 : (rx > w ? w : rx));
  r.y0 = static_cast<int>(ry < 0 ? 0 : (ry > h ? h : ry));
  r.x1 = static_cast<int>(rx + rw < 0 ? 0 : (rx + rw > w ? w : rx + rw));
  r.y1 = static_cast<int>(ry + rh < 0 ? 0 : (ry + rh > h ? h : ry + rh));
  r.full = r.x0 == 0 && r.y0 == 0 && r.x1 == w && r.y1 == h;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t g = static_cast<uint32_t>(lane >> 2);  // fragment row/col
  const int t = lane & 3;                               // its k-slots
  const uint32_t grep = g * kOnes;
  const int start = s * block_px;
  const int lim = min(start + block_px, P);

  int32_t acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0;

  // warp w takes groups of kSteps 32-pixel steps, (w + kWarps i) groups
  // after `start`; the next group's words load while this one is binned
  constexpr int kGroup = 32 * kSteps;
  const int stride = kGroup * kWarps;
  uint32_t next[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    next[k] = step_word(px, start + kGroup * warp + 32 * k, lane, lim, vec);
  }
  for (int g0 = start + kGroup * warp; g0 < lim; g0 += stride) {
    uint32_t words[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      words[k] = next[k];
      next[k] = step_word(px, g0 + stride + 32 * k, lane, lim, vec);
    }
#pragma unroll 1
    for (int k = 0; k < kSteps; ++k) {
      const int c0 = g0 + 32 * k;
      if (c0 >= lim) break;
      const uint32_t v = lane_bin(px, words[0], c0, lane, lim, w, r, vec);
#pragma unroll
      for (int j = 0; j + 1 < kSteps; ++j) words[j] = words[j + 1];
      // the (m-tile, n-tile) pairs the step's pixels fall in, bit 8 mt +
      // nt, the same for the whole warp: the branches are uniform
      const uint32_t hi = v & 0xFFu;
      const uint32_t pair =
          hi == 0xFFu ? 0u : 1u << ((hi >> 4) * 8 + (v >> 11));
      const uint32_t pairs = __reduce_or_sync(kFull, pair);
      if (__popc(pairs) > 8) {
        step_mma<true>(acc, v, pairs, t, grep);
      } else if (pairs) {
        step_mma<false>(acc, v, pairs, t, grep);
      }
    }
  }

  // the warps' accumulators into shared memory, one warp after the other:
  // c0, c1 hold (row 16 mt + g, cols 8 nt + 2t, +1); c2, c3 row + 8
#pragma unroll
  for (int ww = 0; ww < kWarps; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int i0 = (16 * mt + static_cast<int>(g)) * 64 + 8 * nt + 2 * t;
          const int i1 = i0 + 8 * 64;
          if (ww == 0) {
            hist[i0] = acc[mt][nt][0];
            hist[i0 + 1] = acc[mt][nt][1];
            hist[i1] = acc[mt][nt][2];
            hist[i1 + 1] = acc[mt][nt][3];
          } else {
            hist[i0] += acc[mt][nt][0];
            hist[i0 + 1] += acc[mt][nt][1];
            hist[i1] += acc[mt][nt][2];
            hist[i1 + 1] += acc[mt][nt][3];
          }
        }
      }
    }
    __syncthreads();
  }
  int32_t* out = partial + (static_cast<int64_t>(n) * gridDim.x + s) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads) out[i] = hist[i];
}

// out[n][b] = f32(sum over s, in order, of partial[n][s][b])
__global__ void hist_mma_reduce(const int32_t* __restrict__ partial,
                                float* __restrict__ out, int64_t total,
                                int blocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / kBins;
  const int64_t bin = i - n * kBins;
  const int32_t* p = partial + n * blocks * kBins + bin;
  int32_t sum = 0;
  for (int k = 0; k < blocks; ++k) sum += p[static_cast<int64_t>(k) * kBins];
  out[i] = static_cast<float>(sum);
}

}  // namespace

// frames (n, h, w, 3) u8, rects (n, 4) i32, partial (n, blocks, 4096) i32
// scratch, out (n, 4096) f32, all contiguous.  Block s of a stream counts
// pixels [s * block_px, (s + 1) * block_px); block_px is a multiple of 32 and
// blocks * block_px covers the frame.
extern "C" int hist_mma_launch(const void* frames, const void* rects,
                               void* partial, void* out, int n, int h, int w,
                               int blocks, int block_px, void* stream) {
  if (n <= 0) return 0;
  const int64_t P = static_cast<int64_t>(h) * w;
  if (h <= 0 || w <= 0 || n > 65535 || blocks < 1 || block_px < 32 ||
      block_px % 32 != 0 || static_cast<int64_t>(blocks) * block_px < P ||
      static_cast<int64_t>(blocks - 1) * block_px >= P || P * 3 > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec =
      P % 4 == 0 && reinterpret_cast<uintptr_t>(frames) % 4 == 0;
  hist_mma_kernel<<<dim3(blocks, n), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int32_t*>(rects),
      static_cast<int32_t*>(partial), h, w, block_px, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(n) * kBins;
  hist_mma_reduce<<<static_cast<unsigned>((total + kReduceThreads - 1) /
                                          kReduceThreads),
                    kReduceThreads, 0, st>>>(
      static_cast<const int32_t*>(partial), static_cast<float*>(out), total,
      blocks);
  return static_cast<int>(cudaGetLastError());
}
