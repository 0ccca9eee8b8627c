// group for Hopper (sm_90a): ccv's grouping of each stream's candidates, the
// containment filter and facetrackr's pick, one CTA a stream.
//
// It replaces headtrackr_tpu/models/detector.py group_candidates (a K x K
// transitive closure by repeated boolean matmuls on the TPU) and the pick of
// detect_best, and the port's plain twin (ops/detect.py group_plain).
//   - Semantics (src/ccv.js:249-331, the twin's): slots i, j are neighbours
//     when both are valid and gfunc(i, j) or gfunc(j, i) holds (|x, y
//     offsets| <= floor(w_i / 4 + 0.5) and the widths within a factor
//     floor(1.5 w + 0.5)); a component's label is its smallest member slot.
//     A component's count n and its member sums of x, y, w, h are summed in
//     f64 (exact in any order) and rounded once to f32, so a stream's boxes
//     do not depend on its batch; its confidence is its members' max.  A
//     representative (label == slot, n >= min_neighbors) is kept unless it
//     lies within (+- dist) a representative with more neighbours
//     (src/ccv.js:305-331).  The pick: the kept slot of the largest
//     confidence, the first such slot on ties (slot 0 when none is kept).
//     min_neighbors <= 0 skips the grouping: every valid candidate is kept
//     as it is, with 1 neighbour.  Every f32 operation is an _rn intrinsic
//     (no fused multiply-add).
//   - Design: a thread a slot (C <= 256).  The neighbour predicate goes into
//     shared memory as C x C bits (8 KB at C = 256); the labels come from
//     min-label propagation with pointer jumping over the bit rows until no
//     label changes (a label stays a member of its component, so it ends at
//     the component's smallest slot: the union-find root rule); member sums
//     by each representative over the slots; the containment test by each
//     representative over the others; the pick by a warp-shuffle argmax.
//     Work stops at the last valid slot.
//   - Bound: latency.  A stream moves ~6 KB; the work is ~C^2 predicate
//     evaluations, a handful of label rounds and ~C^2 sums at most.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // also the most slots
constexpr int kWords = kThreads / 32;

__device__ __forceinline__ bool gfunc(float xi, float yi, float wi,
                                      float di, float wide_i, float xj,
                                      float yj, float wj, float wide_j) {
  return xj <= __fadd_rn(xi, di) && xj >= __fsub_rn(xi, di) &&
         yj <= __fadd_rn(yi, di) && yj >= __fsub_rn(yi, di) &&
         wj <= wide_i && wide_j >= wi;
}

__device__ __forceinline__ void better(float& s, int& i, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
group_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ valid,
             int n_streams, int cap, int min_neighbors,
             float* __restrict__ slots, uint8_t* __restrict__ kept,
             float* __restrict__ best, uint8_t* __restrict__ found) {
  __shared__ float sx[kThreads], sy[kThreads], sw[kThreads], sd[kThreads],
      swide[kThreads];
  __shared__ float gx[kThreads], gy[kThreads], gw[kThreads], gh[kThreads],
      gn[kThreads], gd[kThreads];
  __shared__ int lab[kThreads], nxt[kThreads];
  __shared__ uint8_t rep[kThreads];
  __shared__ uint32_t adj[kThreads * kWords];
  __shared__ int kmax;
  __shared__ float res[6][kThreads];  // a slot's outputs
  __shared__ float wscore[kWords];
  __shared__ int widx[kWords];

  const int64_t n = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(n_streams) * cap;
  const int64_t at = n * cap + t;
  const bool in = t < cap;
  const bool v = in && valid[at] != 0;
  const float x = in ? cand[at] : 0.0f;
  const float y = in ? cand[plane + at] : 0.0f;
  const float w = in ? cand[2 * plane + at] : 0.0f;
  const float h = in ? cand[3 * plane + at] : 0.0f;
  const float c = in ? cand[4 * plane + at] : 0.0f;
  if (t == 0) kmax = 0;
  __syncthreads();
  if (v) atomicMax(&kmax, t + 1);

  float ox, oy, ow, oh, on, oc;
  bool keep;
  if (min_neighbors <= 0) {
    ox = x, oy = y, ow = w, oh = h, on = v ? 1.0f : 0.0f, oc = c;
    keep = v;
    __syncthreads();
  } else {
    const float d = floorf(__fadd_rn(__fmul_rn(w, 0.25f), 0.5f));
    const float wide = floorf(__fadd_rn(__fmul_rn(w, 1.5f), 0.5f));
    sx[t] = x, sy[t] = y, sw[t] = w, sd[t] = d, swide[t] = wide;
    __syncthreads();
    const int k = kmax;
    const int kw = (k + 31) >> 5;
    for (int wi = 0; wi < kw; ++wi) {  // row t of the neighbour bits
      uint32_t bitsw = 0;
      if (v) {
        for (int b = 0; b < 32; ++b) {
          const int j = wi * 32 + b;
          if (j >= k) break;
          const bool vj = valid[n * cap + j] != 0;
          const bool nb =
              vj && (j == t ||
                     gfunc(x, y, w, d, wide, sx[j], sy[j], sw[j], swide[j]) ||
                     gfunc(sx[j], sy[j], sw[j], sd[j], swide[j], x, y, w, wide));
          bitsw |= static_cast<uint32_t>(nb) << b;
        }
      }
      adj[t * kWords + wi] = bitsw;
    }
    lab[t] = v ? t : cap;
    __syncthreads();
    for (;;) {  // min-label propagation with pointer jumping
      int m = lab[t];
      if (v) {
        for (int wi = 0; wi < kw; ++wi) {
          uint32_t bw = adj[t * kWords + wi];
          while (bw) {
            const int j = wi * 32 + __ffs(bw) - 1;
            bw &= bw - 1;
            m = min(m, lab[j]);
          }
        }
      }
      nxt[t] = m;
      __syncthreads();
      if (v) m = min(m, nxt[m]);
      const bool changed = m != lab[t];
      __syncthreads();
      lab[t] = m;
      if (!__syncthreads_or(changed)) break;
    }
    // member sums at each representative, exact in f64
    const bool root = v && lab[t] == t;
    double cnt = 0.0, ax = 0.0, ay = 0.0, aw = 0.0, ah = 0.0;
    float mc = -CUDART_INF_F;
    if (root) {
      for (int j = t; j < k; ++j) {
        if (lab[j] == t) {
          cnt += 1.0;
          ax += sx[j];
          ay += sy[j];
          aw += sw[j];
          ah += static_cast<double>(cand[3 * plane + n * cap + j]);
          mc = fmaxf(mc, cand[4 * plane + n * cap + j]);
        }
      }
    }
    on = static_cast<float>(cnt);
    const bool is_rep = root && on >= static_cast<float>(min_neighbors);
    const float ns = fmaxf(on, 1.0f);
    const float two_n = __fmul_rn(2.0f, ns);
    ox = __fdiv_rn(__fadd_rn(__fmul_rn(__double2float_rn(ax), 2.0f), on), two_n);
    oy = __fdiv_rn(__fadd_rn(__fmul_rn(__double2float_rn(ay), 2.0f), on), two_n);
    ow = __fdiv_rn(__fadd_rn(__fmul_rn(__double2float_rn(aw), 2.0f), on), two_n);
    oh = __fdiv_rn(__fadd_rn(__fmul_rn(__double2float_rn(ah), 2.0f), on), two_n);
    oc = mc;
    gx[t] = ox, gy[t] = oy, gw[t] = ow, gh[t] = oh, gn[t] = on;
    gd[t] = floorf(__fadd_rn(__fmul_rn(ow, 0.25f), 0.5f));
    rep[t] = is_rep;
    __syncthreads();
    bool inside = false;
    if (is_rep) {  // contained (+- dist) in a representative with more
      const float xr = __fadd_rn(ox, ow), yb = __fadd_rn(oy, oh);
      for (int j = 0; j < k && !inside; ++j) {
        if (j == t || !rep[j]) continue;
        inside = ox >= __fsub_rn(gx[j], gd[j]) &&
                 oy >= __fsub_rn(gy[j], gd[j]) &&
                 xr <= __fadd_rn(__fadd_rn(gx[j], gw[j]), gd[j]) &&
                 yb <= __fadd_rn(__fadd_rn(gy[j], gh[j]), gd[j]) &&
                 (gn[j] > fmaxf(on, 3.0f) || on < 3.0f);
      }
    }
    keep = is_rep && !inside;
  }
  res[0][t] = ox, res[1][t] = oy, res[2][t] = ow, res[3][t] = oh;
  res[4][t] = on, res[5][t] = oc;
  if (in) {
    for (int f = 0; f < 6; ++f) slots[f * plane + at] = res[f][t];
    kept[at] = keep;
  }
  // the pick: the largest confidence of a kept slot, the first on ties
  float s = keep ? oc : -CUDART_INF_F;
  int i = in ? t : cap;
  for (int o = 16; o > 0; o >>= 1) {
    better(s, i, __shfl_down_sync(0xffffffffu, s, o),
           __shfl_down_sync(0xffffffffu, i, o));
  }
  if ((t & 31) == 0) wscore[t >> 5] = s, widx[t >> 5] = i;
  const int any = __syncthreads_or(keep);
  if (t == 0) {
    for (int q = 1; q < kWords; ++q) better(s, i, wscore[q], widx[q]);
    // no kept slot: every score is -inf and slot 0 wins the tie
    best[n] = res[0][i];
    best[n_streams + n] = res[1][i];
    best[2 * n_streams + n] = res[2][i];
    best[3 * n_streams + n] = res[3][i];
    best[4 * n_streams + n] = res[5][i];
    found[n] = any != 0;
  }
}

}  // namespace

// cand (5, n, cap) f32 (x, y, width, height, confidence), valid (n, cap) u8;
// slots (6, n, cap) f32 (x, y, width, height, neighbors, confidence), kept
// (n, cap) u8, best (5, n) f32 (x, y, width, height, confidence), found (n,)
// u8.  cap <= 256.
extern "C" int group_launch(const void* cand, const void* valid, void* slots,
                            void* kept, void* best, void* found, int n,
                            int cap, int min_neighbors, void* stream) {
  if (cap < 1 || cap > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  group_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const uint8_t*>(valid), n,
      cap, min_neighbors, static_cast<float*>(slots),
      static_cast<uint8_t*>(kept), static_cast<float*>(best),
      static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}
