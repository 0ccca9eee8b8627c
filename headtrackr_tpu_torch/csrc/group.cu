// group for Hopper (sm_90a): ccv's grouping of each stream's candidates, the
// containment filter and facetrackr's pick, one CTA a stream.
//
// It replaces headtrackr_tpu/models/detector.py group_candidates (a K x K
// transitive closure by repeated boolean matmuls on the TPU) and the pick of
// detect_best, and the port's plain twin (ops/detect.py group_plain).
//   - Semantics (src/ccv.js:249-331, the twin's): slots i, j are neighbours
//     when both are valid and gfunc(i, j) or gfunc(j, i) holds (|x, y
//     offsets| <= floor(w / 4 + 0.5) of either and the widths within each
//     other's floor(1.5 w + 0.5)); a component's label is its smallest
//     member slot.  A component's count n and its member sums of x, y, w, h
//     are exact and rounded once to f32, so a stream's boxes do not depend
//     on its batch; its confidence is its members' max.  A representative
//     (label == slot, n >= min_neighbors) is kept unless it lies within
//     (+- dist) a representative with more neighbours (src/ccv.js:305-331).
//     The pick: the kept slot of the largest confidence, the first such slot
//     on ties (slot 0 when none is kept).  min_neighbors <= 0 skips the
//     grouping: every valid candidate is kept as it is, with 1 neighbour.
//     Every f32 operation is an _rn intrinsic (no fused multiply-add).
//   - Inputs: the six (N, C) planes through their own pointers (the
//     cascade's five float planes are views of one buffer): one device
//     operation a call.  A thread a slot stages the stream's slots once,
//     coalesced; no loop reads global memory.
//   - Work by the stream's k (its last valid slot + 1: each warp ballots
//     the stream's whole valid row, so no barrier decides): at k <= 32 (the detector's streams hold a few candidates)
//     warp 0 groups alone, a lane a slot, its row, label and sums in
//     registers and shuffles between lanes, while the other warps write
//     their empty slots and exit; past 32 the CTA's 8 warps share the work
//     through shared memory.
//   - Neighbour rows: lane b of a warp tests the pair (i, 32 q + b) and
//     __ballot_sync gives row i's word q (8 KB of rows at C = 256).
//   - Components: labels start at each slot's smallest neighbour (its row's
//     lowest bit), then rounds of pointer jumping (a label to its label's
//     label until none moves) and hooking (a root takes the smallest label
//     that its slots see among their neighbours: atomicMin on shared labels
//     in the CTA, a shuffle gather in warp 0) until no slot hooks.  A label
//     only falls and stays a member of its component, so at the end every
//     component holds one label, its smallest slot (the union-find root
//     rule).  Rounds follow the log of a component's depth.
//   - Member sums: each member's values go to its root in an exact fixed
//     point (below), so the order does not matter: by integer atomics in
//     the CTA, by shuffles in warp 0; the count likewise, the confidence as
//     the max of the f32's ordered-integer form.  No float atomics.
//   - Fixed point: a nonzero f32 is m 2^(b - 150), m < 2^24 an integer and b
//     its exponent field (1 for subnormals).  With E the smallest b of a
//     plane's nonzero valid values in the stream, each value is the integer
//     m 2^(b - E) in units of 2^(E - 150), and a member sum is exact in an
//     int64 while the component's magnitudes sum to under 2^63 units.  The
//     sum times 2^(E - 150) is then exact in f64 below 2^53 units, where the
//     twin's f64 sum is exact in any order too, and both round once to f32.
//     The detector's coordinates lie in {0} u [2, 2^12) (E >= 128, units of
//     2^-22 or coarser): 256 of them sum to under 2^42 units.
//   - Then each representative tests the others (a ballot mask of the
//     representatives), and the pick is a warp max (__reduce_max_sync) of
//     the kept slots' ordered confidences, its first lane by a ballot.
//   - Bound: latency.  A stream moves ~6 KB; the work is ~k^2 pair tests, a
//     few rounds over k labels, and ~k^2 containment tests at most.
//
// The launches are on the caller's stream, allocate nothing and return
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // also the most slots
constexpr int kWords = kThreads / 32;
constexpr int kRow = kWords + 1;  // a neighbour row's words, padded
constexpr unsigned kAll = 0xffffffffu;

struct Shared {
  float4 box[kThreads];  // x, y, w, wide = floor(1.5 w + 0.5)
  float4 win[kThreads];  // x - d, x + d, y - d, y + d; d = floor(w / 4 + 0.5)
  float4 g[kThreads];    // a slot's grouped x, y, w, h
  float2 gnd[kThreads];  // its neighbours and floor(w / 4 + 0.5)
  unsigned long long sum[4][kThreads];  // fixed-point member sums (CTA)
  int cnt[kThreads];
  int cmax[kThreads];  // the members' largest confidence, ordered ints
  int lab[kThreads];
  uint32_t adj[kThreads * kRow];
  uint32_t vmask[kWords];    // valid slots, a word a warp
  uint32_t repmask[kWords];  // representatives
  int emin[4][kWords];       // each plane's smallest exponent, a warp's
  unsigned wkey[kWords];     // each warp's best ordered score
  int widx[kWords];          // and its first slot
};

// slots i and j are neighbours (gfunc either way); symmetric in i and j
__device__ __forceinline__ bool near(float4 bi, float4 wi, float4 bj,
                                     float4 wj) {
  const bool size = bj.z <= bi.w && bi.z <= bj.w;
  const bool a = bj.x >= wi.x && bj.x <= wi.y && bj.y >= wi.z && bj.y <= wi.w;
  const bool b = bi.x >= wj.x && bi.x <= wj.y && bi.y >= wj.z && bi.y <= wj.w;
  return size && (a || b);
}

// the exponent field of a nonzero f32 (1 for subnormals); 255 for zero
__device__ __forceinline__ int binade(float v) {
  const int b = static_cast<int>((__float_as_uint(v) >> 23) & 255u);
  return v == 0.0f ? 255 : max(b, 1);
}

// v in units of 2^(e - 150), e <= binade(v): an exact integer
__device__ __forceinline__ unsigned long long fixed(float v, int e) {
  const uint32_t u = __float_as_uint(v);
  const int b = static_cast<int>((u >> 23) & 255u);
  const unsigned long long m = (u & 0x7fffffu) | (b ? 0x800000u : 0u);
  const unsigned long long q = m << min(max(max(b, 1) - e, 0), 39);
  return (u >> 31) ? 0ull - q : q;
}

// a fixed-point sum in units of 2^(e - 150), rounded once to f32
__device__ __forceinline__ float unfixed(unsigned long long s, int e) {
  const double unit = __hiloint2double((e - 150 + 1023) << 20, 0);
  return __double2float_rn(
      __dmul_rn(__ll2double_rn(static_cast<long long>(s)), unit));
}

// an f32's order as a signed int (the members' largest confidence)
__device__ __forceinline__ int okey(float c) {
  const int i = __float_as_int(c);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ofloat(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// an f32's order as an unsigned int, above 0 (the pick's scores)
__device__ __forceinline__ unsigned ukey(float c) {
  const unsigned u = __float_as_uint(c);
  return (u >> 31) ? ~u : u | 0x80000000u;
}

// a slot's grouped box from its members' sums (none: 0s and -inf)
__device__ __forceinline__ void grouped(const unsigned long long (&sum)[4],
                                        int cnt, int cmax, const int (&e)[4],
                                        float (&o)[6]) {
  const float on = static_cast<float>(cnt);
  const float two_n = __fmul_rn(2.0f, fmaxf(on, 1.0f));
#pragma unroll
  for (int f = 0; f < 4; ++f)
    o[f] = __fdiv_rn(__fadd_rn(__fmul_rn(unfixed(sum[f], e[f]), 2.0f), on),
                     two_n);
  o[4] = on;
  o[5] = ofloat(cmax);
}

// the containment filter by the first 32 NW threads (a representative
// within +- dist of a representative with more neighbours is dropped)
template <int NW>
__device__ __forceinline__ bool not_inside(Shared& s, int t, int kw,
                                           const float (&o)[6], bool is_rep) {
  const int lane = t & 31, warp = t >> 5;
  s.g[t] = make_float4(o[0], o[1], o[2], o[3]);
  s.gnd[t] = make_float2(o[4], floorf(__fadd_rn(__fmul_rn(o[2], 0.25f), 0.5f)));
  const uint32_t reps = __ballot_sync(kAll, is_rep);
  if (lane == 0) s.repmask[warp] = reps;
  if (NW == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  bool inside = false;
  if (is_rep) {
    const float on = o[4];
    const float xr = __fadd_rn(o[0], o[2]), yb = __fadd_rn(o[1], o[3]);
    for (int q = 0; q < kw && !inside; ++q) {
      uint32_t bits = s.repmask[q];
      if (q == warp) bits &= ~(1u << lane);
      while (bits && !inside) {
        const int j = 32 * q + __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 gj = s.g[j];
        const float2 nj = s.gnd[j];
        inside = o[0] >= __fsub_rn(gj.x, nj.y) &&
                 o[1] >= __fsub_rn(gj.y, nj.y) &&
                 xr <= __fadd_rn(__fadd_rn(gj.x, gj.z), nj.y) &&
                 yb <= __fadd_rn(__fadd_rn(gj.y, gj.w), nj.y) &&
                 (nj.x > fmaxf(on, 3.0f) || on < 3.0f);
      }
    }
  }
  return is_rep && !inside;
}

// ccv's grouping by warp 0 alone (k <= 32): a lane a slot; its row, label
// and member sums in registers, shuffles between the lanes
__device__ __forceinline__ void group_warp(Shared& s, int lane, uint32_t vm,
                                           float x, float y, float w,
                                           float h, float c,
                                           const int (&e)[4],
                                           int min_neighbors, float (&o)[6],
                                           bool& keep) {
  const bool v = (vm >> lane) & 1u;
  const float4 bj = s.box[lane], wj = s.win[lane];
  uint32_t row = 0;  // this slot's neighbours, itself included
  for (uint32_t rest = vm; rest; rest &= rest - 1) {
    const int i = __ffs(rest) - 1;
    const bool nb = v && (lane == i || near(s.box[i], s.win[i], bj, wj));
    const uint32_t bits = __ballot_sync(kAll, nb);
    if (lane == i) row = bits;
  }
  int lab = v ? __ffs(row) - 1 : lane;  // the smallest neighbour
  for (;;) {
    for (;;) {  // pointer jumping
      const int ll = __shfl_sync(kAll, lab, lab);
      if (!__any_sync(kAll, ll != lab)) break;
      lab = ll;
    }
    int m = lab;  // the neighbours' smallest label
    for (uint32_t rest = vm; rest; rest &= rest - 1) {
      const int j = __ffs(rest) - 1;
      const int lj = __shfl_sync(kAll, lab, j);
      if ((row >> j) & 1u) m = min(m, lj);
    }
    if (!__any_sync(kAll, m < lab)) break;
    int hook = lab;  // a root: the smallest m of its slots
    for (uint32_t rest = vm; rest; rest &= rest - 1) {
      const int t = __ffs(rest) - 1;
      const int lt = __shfl_sync(kAll, lab, t), mt = __shfl_sync(kAll, m, t);
      if (lt == lane) hook = min(hook, mt);
    }
    lab = hook;
  }
  const unsigned long long fx[4] = {fixed(x, e[0]), fixed(y, e[1]),
                                    fixed(w, e[2]), fixed(h, e[3])};
  const int ck = okey(c);
  unsigned long long sum[4] = {0ull, 0ull, 0ull, 0ull};
  int cnt = 0, cmax = okey(-CUDART_INF_F);
  for (uint32_t rest = vm; rest; rest &= rest - 1) {  // member sums
    const int t = __ffs(rest) - 1;
    const bool mine = __shfl_sync(kAll, lab, t) == lane;
    const int kt = __shfl_sync(kAll, ck, t);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const unsigned long long ft = __shfl_sync(kAll, fx[f], t);
      if (mine) sum[f] += ft;
    }
    if (mine) ++cnt, cmax = max(cmax, kt);
  }
  grouped(sum, cnt, cmax, e, o);
  const bool is_rep = cnt > 0 && o[4] >= static_cast<float>(min_neighbors);
  keep = not_inside<1>(s, lane, 1, o, is_rep);
}

// ccv's grouping by the CTA (k > 32): a thread a slot, rows, labels and
// sums in shared memory
__device__ __forceinline__ void group_cta(Shared& s, int t, bool v, int k,
                                          float x, float y, float w, float h,
                                          float c, const int (&e)[4],
                                          int min_neighbors, float (&o)[6],
                                          bool& keep) {
  const int lane = t & 31, warp = t >> 5;
  const int kw = (k + 31) >> 5;
#pragma unroll
  for (int f = 0; f < 4; ++f) s.sum[f][t] = 0ull;
  s.cnt[t] = 0;
  s.cmax[t] = okey(-CUDART_INF_F);
  // neighbour rows: lane b tests the pair (i, 32 q + b), rows i a warp's
  for (int q = 0; q < kw; ++q) {
    const int j = 32 * q + lane;
    const float4 bj = s.box[j], wj = s.win[j];
    const bool vj = (s.vmask[q] >> lane) & 1u;
    for (int i = warp; i < k; i += kWords) {
      if (!((s.vmask[i >> 5] >> (i & 31)) & 1u)) continue;  // warp-uniform
      const bool nb = vj && (j == i || near(s.box[i], s.win[i], bj, wj));
      const uint32_t bits = __ballot_sync(kAll, nb);
      if (lane == 0) s.adj[i * kRow + q] = bits;
    }
  }
  __syncthreads();
  uint32_t row[kWords];  // this slot's neighbours, itself included
#pragma unroll
  for (int q = 0; q < kWords; ++q)
    row[q] = v && q < kw ? s.adj[t * kRow + q] : 0u;
  int first = t;  // the smallest neighbour
#pragma unroll
  for (int q = kWords - 1; q >= 0; --q)
    if (row[q]) first = 32 * q + __ffs(row[q]) - 1;
  s.lab[t] = first;
  __syncthreads();
  for (;;) {
    for (;;) {  // pointer jumping
      bool moved = false;
      if (v) {
        const int l = s.lab[t], ll = s.lab[l];
        if (ll != l) {
          s.lab[t] = ll;
          moved = true;
        }
      }
      if (!__syncthreads_or(moved)) break;
    }
    bool hooked = false;  // hooking onto the neighbours' smallest label
    if (v) {
      const int l = s.lab[t];
      int m = l;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        if (q < kw && row[q]) {
#pragma unroll
          for (int b = 0; b < 32; ++b)
            if ((row[q] >> b) & 1u) m = min(m, s.lab[32 * q + b]);
        }
      }
      if (m < l) {
        atomicMin(&s.lab[l], m);
        hooked = true;
      }
    }
    if (!__syncthreads_or(hooked)) break;
  }
  if (v) {  // member sums at the root, in any order
    const int r = s.lab[t];
    atomicAdd(&s.sum[0][r], fixed(x, e[0]));
    atomicAdd(&s.sum[1][r], fixed(y, e[1]));
    atomicAdd(&s.sum[2][r], fixed(w, e[2]));
    atomicAdd(&s.sum[3][r], fixed(h, e[3]));
    atomicAdd(&s.cnt[r], 1);
    atomicMax(&s.cmax[r], okey(c));
  }
  __syncthreads();
  const int cnt = s.cnt[t];  // 0 but at a component's root
  const unsigned long long sum[4] = {s.sum[0][t], s.sum[1][t], s.sum[2][t],
                                     s.sum[3][t]};
  grouped(sum, cnt, s.cmax[t], e, o);
  const bool is_rep = cnt > 0 && o[4] >= static_cast<float>(min_neighbors);
  keep = not_inside<kWords>(s, t, kw, o, is_rep);
}

// a slot's outputs, then the pick by the first 32 NW threads: the largest
// confidence of a kept slot, the first such slot on ties (slot 0 when none
// is kept)
template <int NW>
__device__ __forceinline__ void finish(Shared& s, int t, int64_t n,
                                       int n_streams, int cap,
                                       const float (&o)[6], bool keep,
                                       float* __restrict__ slots,
                                       uint8_t* __restrict__ kept,
                                       float* __restrict__ best,
                                       uint8_t* __restrict__ found) {
  const int lane = t & 31;
  const int64_t plane = static_cast<int64_t>(n_streams) * cap;
  const int64_t at = n * cap + t;
  if (t < cap) {
#pragma unroll
    for (int f = 0; f < 6; ++f) slots[f * plane + at] = o[f];
    kept[at] = keep;
  }
  const unsigned key = t < cap ? ukey(keep ? o[5] : -CUDART_INF_F) : 0u;
  const unsigned top = __reduce_max_sync(kAll, key);
  int i = (t & ~31) + __ffs(__ballot_sync(kAll, key == top)) - 1;
  bool any;
  if (NW == 1) {
    any = __any_sync(kAll, keep);
  } else {
    if (lane == 0) s.wkey[t >> 5] = top, s.widx[t >> 5] = i;
    any = __syncthreads_or(keep) != 0;
    const unsigned wk = lane < NW ? s.wkey[lane] : 0u;
    const unsigned all = __reduce_max_sync(kAll, wk);
    i = s.widx[__ffs(__ballot_sync(kAll, lane < NW && wk == all)) - 1];
  }
  if (t == i) {
#pragma unroll
    for (int f = 0; f < 4; ++f) best[f * n_streams + n] = o[f];
    best[4 * n_streams + n] = o[5];
    found[n] = any;
  }
}

__global__ void __launch_bounds__(kThreads)
group_kernel(const float* __restrict__ px, const float* __restrict__ py,
             const float* __restrict__ pw, const float* __restrict__ ph,
             const float* __restrict__ pc, const uint8_t* __restrict__ pv,
             int n_streams, int cap, int min_neighbors,
             float* __restrict__ slots, uint8_t* __restrict__ kept,
             float* __restrict__ best, uint8_t* __restrict__ found) {
  __shared__ Shared s;
  const int64_t n = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t at = n * cap + t;
  const bool in = t < cap;
  // every warp reads the stream's whole valid row, so each finds k (the
  // last valid slot + 1) and the path alone, with no barrier
  uint32_t vm = 0;  // this warp's valid slots
  int k = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int j = 32 * q + lane;
    const uint32_t word = __ballot_sync(kAll, j < cap && pv[n * cap + j]);
    if (q == warp) vm = word;
    if (word) k = 32 * q + 32 - __clz(word);
  }
  const bool v = (vm >> lane) & 1u;
  const float x = in ? px[at] : 0.0f, y = in ? py[at] : 0.0f;
  const float w = in ? pw[at] : 0.0f, h = in ? ph[at] : 0.0f;
  const float c = in ? pc[at] : 0.0f;
  float o[6];
  bool keep;
  if (min_neighbors <= 0) {  // every valid candidate as it is
    o[0] = x, o[1] = y, o[2] = w, o[3] = h, o[4] = v ? 1.0f : 0.0f, o[5] = c;
    finish<kWords>(s, t, n, n_streams, cap, o, v, slots, kept, best, found);
    return;
  }
  if (k <= 32 && warp != 0) {  // warp 0 groups alone: an empty slot
    if (in) {
      const float z[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -CUDART_INF_F};
      const int64_t plane = static_cast<int64_t>(n_streams) * cap;
#pragma unroll
      for (int f = 0; f < 6; ++f) slots[f * plane + at] = z[f];
      kept[at] = 0;
    }
    return;
  }
  const float d = floorf(__fadd_rn(__fmul_rn(w, 0.25f), 0.5f));
  const float wide = floorf(__fadd_rn(__fmul_rn(w, 1.5f), 0.5f));
  s.box[t] = make_float4(x, y, w, wide);
  s.win[t] = make_float4(__fsub_rn(x, d), __fadd_rn(x, d), __fsub_rn(y, d),
                         __fadd_rn(y, d));
  const float vals[4] = {x, y, w, h};
  int e[4];  // each plane's smallest exponent of a valid nonzero value
#pragma unroll
  for (int f = 0; f < 4; ++f)
    e[f] = static_cast<int>(__reduce_min_sync(
        kAll, static_cast<unsigned>(v ? binade(vals[f]) : 255)));
  if (k <= 32) {  // every valid slot is warp 0's
    __syncwarp();
    group_warp(s, lane, vm, x, y, w, h, c, e, min_neighbors, o, keep);
    finish<1>(s, t, n, n_streams, cap, o, keep, slots, kept, best, found);
    return;
  }
  if (lane == 0) {
    s.vmask[warp] = vm;
#pragma unroll
    for (int f = 0; f < 4; ++f) s.emin[f][warp] = e[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 4; ++f)
    e[f] = static_cast<int>(__reduce_min_sync(
        kAll, static_cast<unsigned>(lane < kWords ? s.emin[f][lane] : 255)));
  group_cta(s, t, v, k, x, y, w, h, c, e, min_neighbors, o, keep);
  finish<kWords>(s, t, n, n_streams, cap, o, keep, slots, kept, best, found);
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

// x, y, width, height, confidence (n, cap) f32 and valid (n, cap) u8, each
// contiguous; slots (6, n, cap) f32 (x, y, width, height, neighbors,
// confidence), kept (n, cap) u8, best (5, n) f32 (x, y, width, height,
// confidence), found (n,) u8.  cap <= 256.
extern "C" int group_launch(const void* x, const void* y, const void* w,
                            const void* h, const void* conf,
                            const void* valid, void* slots, void* kept,
                            void* best, void* found, int n, int cap,
                            int min_neighbors, void* stream) {
  if (cap < 1 || cap > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  group_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const float*>(conf), static_cast<const uint8_t*>(valid), n,
      cap, min_neighbors, static_cast<float*>(slots),
      static_cast<uint8_t*>(kept), static_cast<float*>(best),
      static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of group's grid (n CTAs of 256 threads): the floor of one
// device operation, which measurements set beside group's time.
extern "C" int group_floor_launch(int n, void* stream) {
  if (n <= 0) return 0;
  empty_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
