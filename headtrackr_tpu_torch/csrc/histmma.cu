// hist_mma for Hopper (sm_90a): the 4096-bin RGB histogram of each stream's
// rect as an int8 one-hot product on the tensor cores, by warpgroup matrix
// multiply (wgmma).
//
// It replaces tools/kernel_experiments.py mk_call(hist_k6) (:257, the kernel
// at :277), the Pallas form of the JAX package's default histogram
// (headtrackr_tpu/ops/histogram.py histogram_scan): with bin = 64 hi + lo,
// hist (64, 64) = OneHot(hi)^T @ OneHot(lo) in int8, accumulated in i32.
//   - Semantics: frames (N, H, W, 3) u8 + rects (N, 4) i32 [x, y, w, h] ->
//     (N, 4096) f32 exact counts of the pixels inside each stream's rect
//     clamped to the frame: hist4096's contract, so the two are
//     interchangeable.
//   - Bound: bytes, as for hist4096: a histogram reads each pixel's 3 bytes
//     once, 59 MB at 256 streams x 76,800 px, 0.019 ms at 3.35 TB/s.  The
//     dense one-hot product this formulation issues (4,096 int8
//     multiply-adds a pixel, 80.5 GMAC, 0.08 ms at the card's dense int8
//     rate) is its floor here.
//   - Design: a block is one warpgroup (128 threads) over a contiguous
//     slice of one stream's pixels.  The 64 x 64 i32 histogram is the
//     warpgroup's m64n64k32 accumulator: 32 registers a thread.  Frame
//     bytes arrive in a ring of four 1,024-pixel stages by TMA bulk copies
//     (cp.async.bulk; a full-frame stream is contiguous), each on its own
//     mbarrier, issued three stages ahead.  A thread takes a run of 8
//     neighbouring pixels of a stage (its 24 bytes in three 8-byte loads)
//     and gives one pixel to each of the stage's eight 128-pixel tiles.  A
//     tile is two one-hot operands in shared memory, A (hi) and B (lo), each
//     64 rows x 128 bytes, K-major, no swizzle, in two buffers: the next
//     tile is built while the previous one's four wgmma run.  The operands
//     stay zero but for one byte a pixel: a thread sets its pixel's byte and
//     clears the one it set in the same buffer two tiles before, once the
//     wgmma that read it has retired.  The tiles of one buffer take
//     neighbouring pixels of the run, so where they share a bin the byte is
//     already set and the thread stores nothing.  Pixels outside the rect or
//     past the slice set no byte (the TPU kernel's -1 padding, which matches
//     no row).  At the end each block writes its i32 partial histogram, and
//     a second kernel sums each stream's partials in block order and
//     converts to f32: exact and deterministic (no float atomics, F5).
//   - What paces it (H100 SXM, PERF.md): the wgmma stream itself.  The same
//     loop with no operand stores ran at 1.2 times the dense product's
//     time; the byte stores into one buffer while the tensor cores read the
//     other cost the rest, up to 1.8 times on uniformly random bins, where
//     no store can be skipped (tools/torch_histmma_variants.py times
//     these variants).
//   - Frames whose pixel count is not a multiple of 16, or that do not
//     start 16-byte aligned (a view), cannot take the bulk copies: there
//     each thread loads its run's bytes from global memory itself, into
//     the registers the bulk-copy path fills from shared memory, so the
//     tile loop is one code on both paths.
//   - In place: given frame_at (the device address of a word holding the
//     frames' address when the kernel runs, the serving program's
//     parameter block word), the kernel reads the frames there, and the
//     host cannot see that address.  Each block then tests it (one load of
//     the word, the same for every thread) and takes the bulk copies where
//     it is 16-byte aligned, else the per-thread loads: a uniform branch
//     once a stage around the loads only, so the tile loop and its wgmma
//     stream are the same on both.
//   - Rects null: the whole frame, no rect read.
//
// The launch is on the caller's stream, allocates nothing (the caller passes
// the (N, blocks, 4096) i32 partials) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBins = 4096;
constexpr int kTile = 128;     // pixels of a one-hot tile: one a thread
constexpr int kBufs = 2;       // one-hot tile buffers
constexpr int kStagePx = 1024;  // pixels of a bulk copy
constexpr int kStageBytes = 3 * kStagePx;
constexpr int kRing = 4;        // stages in the ring
constexpr int kTileBytes = 64 * kTile;  // one operand: 64 rows x kTile bytes
// the no-swizzle K-major layout: core matrix (row / 8, k / 16) at
// (row / 8) * kSbo + (k / 16) * kLbo, 16 bytes a row inside it
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = 8 * kTile;
constexpr int kReduceThreads = 256;

constexpr int kRun = kStagePx / kThreads;  // a thread's pixels a stage
static_assert(kRun == 8 && kBufs == 2, "run_slot assumes 8 tiles, 2 buffers");

struct alignas(128) Smem {
  uint8_t onehot[kBufs][2][kTileBytes];  // [buffer][0: A (hi), 1: B (lo)]
  uint8_t ring[kRing][kStageBytes];
  uint64_t full[kRing];
};

// Tile c of a stage holds pixel run_slot(c) of each thread's run of kRun:
// 0, 4, 1, 5, 2, 6, 3, 7, so the tiles of one buffer take neighbouring
// pixels (0, 1, 2, 3 and 4, 5, 6, 7), which often share their bins.
__host__ __device__ constexpr int run_slot(int c) { return (c >> 1) | (c & 1) << 2; }

struct Rect {
  int x0, y0, x1, y1;  // clamped to the frame; empty when x1 <= x0 or y1 <= y0
  bool full;           // covers the whole frame
};

// byte offset of one-hot row `row`, column k, in a tile
__device__ __forceinline__ int tile_offset(uint32_t row, int k) {
  return static_cast<int>((row >> 3) * kSbo + (row & 7) * 16) +
         (k >> 4) * static_cast<int>(kLbo) + (k & 15);
}

// How a block's frame bytes arrive: each thread loads its own, TMA bulk
// copies (the launcher checked alignment), or either as the frames'
// address read from frame_at allows.
enum Load { kLoadThreads = 0, kLoadTma = 1, kLoadAt = 2 };

// grid (blocks, N), kThreads threads: block s of stream n counts pixels
// [s * block_px, (s + 1) * block_px) and writes partial[n][s][:].  kLoad:
// Load; with kLoadAt the frames lie frame_off bytes past the address that
// *frame_at holds.  rects null: the whole frame.
template <int kLoad>
__global__ void __launch_bounds__(kThreads)
hist_mma_kernel(const uint8_t* __restrict__ frames,
                const int32_t* __restrict__ rects,
                int32_t* __restrict__ partial, int h, int w, int block_px,
                const long long* __restrict__ frame_at, long long frame_off) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127});
  const int n = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = h * w;
  const uint8_t* base =
      kLoad == kLoadAt
          ? reinterpret_cast<const uint8_t*>(*frame_at + frame_off)
          : frames;
  // uniform over the grid: the word and P are the same for every thread
  const bool tma = kLoad == kLoadTma ||
                   (kLoad == kLoadAt && P % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(base) & 15) == 0);
  const uint8_t* px = base + static_cast<int64_t>(n) * P * 3;
  Rect r = {0, 0, w, h, true};
  if (rects) {
    const int64_t rx = rects[4 * n], ry = rects[4 * n + 1];
    const int64_t rw = rects[4 * n + 2], rh = rects[4 * n + 3];
    r.x0 = static_cast<int>(rx < 0 ? 0 : (rx > w ? w : rx));
    r.y0 = static_cast<int>(ry < 0 ? 0 : (ry > h ? h : ry));
    r.x1 = static_cast<int>(rx + rw < 0 ? 0 : (rx + rw > w ? w : rx + rw));
    r.y1 = static_cast<int>(ry + rh < 0 ? 0 : (ry + rh > h ? h : ry + rh));
    r.full = r.x0 == 0 && r.y0 == 0 && r.x1 == w && r.y1 == h;
  }

  const int start = blk * block_px;
  const int lim = min(start + block_px, P);
  const int stages = (lim - start + kStagePx - 1) / kStagePx;

  uint4* z = reinterpret_cast<uint4*>(&sm.onehot[0][0][0]);
  for (int i = tid; i < static_cast<int>(sizeof(sm.onehot) / 16);
       i += kThreads) {
    z[i] = make_uint4(0, 0, 0, 0);
  }
  auto issue = [&](int st) {  // stage st into its ring slot
    const int slot = st % kRing;
    const int p0 = start + st * kStagePx;
    const uint32_t bytes = 3u * static_cast<uint32_t>(min(kStagePx, lim - p0));
    sm90::mbar_arrive_expect_tx(&sm.full[slot], bytes);
    sm90::bulk_load(sm.ring[slot], px + 3 * static_cast<int64_t>(p0), bytes,
                    &sm.full[slot]);
  };
  if (tma && tid == 0) {
    for (int i = 0; i < kRing; ++i) sm90::mbar_init(&sm.full[i], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tma && tid == 0) {
    for (int st = 0; st < min(kRing, stages); ++st) issue(st);
  }

  const int k_off = tile_offset(0, tid);
  const uint64_t desc0 = sm90::smem_desc(&sm.onehot[0][0][0], kLbo, kSbo);
  constexpr uint64_t kOperand = kTileBytes >> 4;  // descriptor units
  constexpr uint64_t kStep = (2 * kLbo) >> 4;     // k = 32: two core matrices

  int32_t acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  // the A and B byte offsets this thread has set in each buffer (-1: none)
  int set_a[kBufs], set_b[kBufs];
#pragma unroll
  for (int i = 0; i < kBufs; ++i) set_a[i] = set_b[i] = -1;
  for (int st = 0; st < stages; ++st) {
    const int slot = st % kRing;
    // this thread's run: pixels p_run .. p_run + kRun - 1 of the stream
    const int p_run = start + st * kStagePx + kRun * tid;
    // the run's 24 bytes: from the stage's bulk copy, else from global
    // memory where they lie (three 8-byte loads where the run is whole and
    // 8-byte aligned, else the bytes of its pixels inside the block), so
    // the tile loop below is the same on both paths
    uint32_t wd[6] = {};
    if (tma) {
      sm90::mbar_wait(&sm.full[slot], (st / kRing) & 1);
      const uint2* q = reinterpret_cast<const uint2*>(
          &sm.ring[slot][3 * kRun * tid]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint2 v = q[i];
        wd[2 * i] = v.x;
        wd[2 * i + 1] = v.y;
      }
    } else {
      const uint8_t* q = px + 3 * static_cast<int64_t>(p_run);
      const int bytes = 3 * min(kRun, lim - p_run);
      if (bytes == 3 * kRun && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
        const uint2* q2 = reinterpret_cast<const uint2*>(q);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint2 v = __ldg(q2 + i);
          wd[2 * i] = v.x;
          wd[2 * i + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3 * kRun; ++k) {
          if (k < bytes) {
            wd[k >> 2] |= static_cast<uint32_t>(__ldg(q + k)) << (8 * (k & 3));
          }
        }
      }
    }
    int x = 0, y = 0;  // of pixel p_run, when the rect is not the frame
    if (!r.full) {
      y = p_run / w;
      x = p_run - y * w;
    }
#pragma unroll
    for (int c = 0; c < kStagePx / kTile; ++c) {
      const int j = run_slot(c);
      bool in = p_run + j < lim;
      const uint32_t R = (wd[(3 * j) >> 2] >> (8 * ((3 * j) & 3))) & 0xFFu;
      const uint32_t G =
          (wd[(3 * j + 1) >> 2] >> (8 * ((3 * j + 1) & 3))) & 0xFFu;
      const uint32_t B =
          (wd[(3 * j + 2) >> 2] >> (8 * ((3 * j + 2) & 3))) & 0xFFu;
      if (!r.full) {
        int xj = x + j, yj = y;
        while (xj >= w) {
          xj -= w;
          ++yj;
        }
        in = in && xj >= r.x0 && xj < r.x1 && yj >= r.y0 && yj < r.y1;
      }
      // bin = 256 (R >> 4) + 16 (G >> 4) + (B >> 4); hi = bin >> 6, lo = bin & 63
      const uint32_t hi = ((R >> 4) << 2) | (G >> 6);
      const uint32_t lo = (G & 0x30u) | (B >> 4);
      const int buf = c % kBufs;
      uint8_t* ta = sm.onehot[buf][0];
      uint8_t* tb = sm.onehot[buf][1];
      const int a = in ? tile_offset(hi, 0) + k_off : -1;
      const int b = in ? tile_offset(lo, 0) + k_off : -1;
      // the wgmma kBufs tiles back, the last reader of buf, has retired;
      // a byte already set stays (neighbouring pixels share bins)
      sm90::wgmma_wait<kBufs - 1>();
      if (a != set_a[buf]) {
        if (set_a[buf] >= 0) ta[set_a[buf]] = 0;
        if (a >= 0) ta[a] = 1;
        set_a[buf] = a;
      }
      if (b != set_b[buf]) {
        if (set_b[buf] >= 0) tb[set_b[buf]] = 0;
        if (b >= 0) tb[b] = 1;
        set_b[buf] = b;
      }
      sm90::fence_proxy_async();
      __syncthreads();
      const uint64_t da = desc0 + (2 * buf) * kOperand;
      const uint64_t db = da + kOperand;
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTile / 32; ++k) {
        sm90::wgmma_s8_64x64x32(acc, da + k * kStep, db + k * kStep);
      }
      sm90::wgmma_commit();
      sm90::fence_operands(acc);
    }
    // every thread has read its run from the slot (before the barriers)
    if (tma && tid == 0 && st + kRing < stages) issue(st + kRing);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);

  // thread (warp wg, lane 4 g + t) holds rows 16 wg + g (+ 8) of the
  // histogram, columns 8 j + 2 t and + 1
  const int wg = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  int32_t* out = partial + (static_cast<int64_t>(n) * gridDim.x + blk) * kBins;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * wg + g + 8 * hh;
      *reinterpret_cast<int2*>(out + row * 64 + 8 * j + 2 * t) =
          make_int2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// dynamic shared memory, so the ring and the tile buffers may grow past the
// 48 KB of a static allocation; + the alignment slack
constexpr int kSmemBytes = sizeof(Smem) + 128;

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

// frames (n, h, w, 3) u8, rects (n, 4) i32 or null (the whole frame),
// partial (n, blocks, 4096) i32 scratch, out (n, 4096) f32, all
// contiguous.  Block s of a stream counts pixels [s * block_px, (s + 1) *
// block_px); block_px is a multiple of 1,024 (a bulk-copy stage) and
// blocks * block_px covers the frame.  frame_at: null, or the device
// address of an i64 word that holds the frames' address when the kernel
// runs (then ``frames`` is not read: the kernel reads the word's address
// plus ``frame_off`` bytes).
extern "C" int hist_mma_launch(const void* frames, const void* rects,
                               void* partial, void* out, int n, int h, int w,
                               int blocks, int block_px, const void* frame_at,
                               long long frame_off, void* stream) {
  if (n <= 0) return 0;
  const int64_t P = static_cast<int64_t>(h) * w;
  if (h <= 0 || w <= 0 || n > 65535 || blocks < 1 || block_px < kStagePx ||
      block_px % kStagePx != 0 ||
      static_cast<int64_t>(blocks) * block_px < P ||
      static_cast<int64_t>(blocks - 1) * block_px >= P || P * 3 > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, n);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* r = static_cast<const int32_t*>(rects);
  auto* part = static_cast<int32_t*>(partial);
  const auto* at = static_cast<const long long*>(frame_at);
  using Kernel = void (*)(const uint8_t*, const int32_t*, int32_t*, int, int,
                          int, const long long*, long long);
  auto run = [&](Kernel kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    kernel<<<grid, kThreads, kSmemBytes, st>>>(f, r, part, h, w, block_px, at,
                                               frame_off);
  };
  if (at) {
    run(hist_mma_kernel<kLoadAt>);
  } else if (P % 16 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0) {
    run(hist_mma_kernel<kLoadTma>);
  } else {
    run(hist_mma_kernel<kLoadThreads>);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(n) * kBins;
  hist_mma_reduce<<<static_cast<unsigned>((total + kReduceThreads - 1) /
                                          kReduceThreads),
                    kReduceThreads, 0, st>>>(part, static_cast<float*>(out),
                                             total, blocks);
  return static_cast<int>(cudaGetLastError());
}
