// The serving tick scheduled on the card, for Hopper (sm_90a): the branch
// of each tick, the served streams, the escape fallback and the K ticks of
// a scan chosen by kernels that set CUDA graph conditional handles, in one
// graph launch (runtime/serving.py _Program builds it around the tick
// bodies that PyTorch captures).
//
// It replaces no Pallas kernel.  The reference runs the same choices as
// XLA control flow inside one program:
//   tick_select    headtrackr_tpu/runtime/serving.py:326 auto_step: the
//                  pending counts, the branch rule (lax.switch, :408-424)
//                  and the oldest-first top_k of the served streams with
//                  their new pend_age (:366-383, _aged); and the scan's
//                  tick count k and its loop's handle (:426 lax.scan);
//   escape_select  :225 _escape_checked: the escaped count, none / few /
//                  many (lax.switch) and the top_k of the escaped streams;
//   scan_step      :426 scan_steps (lax.scan): tick k's frames into the
//                  bodies' frame buffer;
//   scan_commit    the scan's carry and stacked outputs: the tick's
//                  outputs into row k of the (fields, K, N) output packs,
//                  the new state into the state every body reads.
// What bounds them: none moves more than the tick's frames (scan_step,
// bytes: N x H x W x 3 read and written, 0.0352 ms at 256 x 240 x 320 on
// an H100 SXM at 3.35 TB/s) or the state (scan_commit, ~4.3 MB at 256
// streams); the two selects read 8 bytes a stream and are a chain of
// latencies (one CTA, a bitonic sort of at most 4,096 keys in shared
// memory, ~78 barrier steps at 4,096, 36 at 256).  A graph launch costs
// one host call where a tick of host scheduling cost a launch a body and a
// host read; that, not these kernels' time, is what they are for.
//
// Design:
//   - One CTA (a thread a compare-exchange pair of the sort: 128 threads
//     at 256 streams, 1,024 from 2,048) selects over N <= 4,096 streams:
//     keys in shared memory as one 64-bit word each, (1 + pend_age) << 32
//     | ~i for a pending stream and 0 otherwise, sorted descending, so the
//     oldest pending streams come first and ties go to the lower index
//     (top_k's order); only a bucket tick (or an escape tick with few
//     escapes) sorts.  Every handle is set, the chosen one to 1, so no
//     handle keeps a value from another tick.
//   - The single-CTA tick_select, which runs after scan_step has copied
//     tick k's frames, advances k and sets the loop's handle: in scan_step
//     that needed its last CTA to count the others in with an atomic, one
//     a CTA on one word, which cost more than the copy's gap to its bound.
//     scan_commit reads the advanced k and writes row k - 1.
//   - The parameter block (Params) lives in device memory; the host writes
//     it before each launch (k = 0, K, the frames' and output packs'
//     addresses) and reads it back with the last tick's modes: each kernel
//     counts its own runs there (tick_select and escape_select by the body
//     each chose), and the launch counters take those counts, not K: a
//     kernel node's arguments are fixed when the graph is built, the
//     block's contents are not.
//   - sched_program_build assembles the graph: a WHILE node whose body is
//     scan_step -> tick_select -> one IF node a tick body -> escape_select
//     -> IF few, IF many -> scan_commit, each IF node's body a child graph
//     node of a PyTorch-captured body.  It walks each body's nodes first
//     and refuses a node type a conditional body cannot hold.
//
// The launchers run on the caller's stream, allocate nothing and return the
// CUDA error of the launch; sched_program_* return a CUDA error, -1 for a
// driver older than 12.4 (sched_driver_version gives it), or
// -(1000 + 100 * body + node type) for a body holding a refused node.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or later"
#endif

namespace {

constexpr int kMaxN = 4096;       // streams a select kernel takes
constexpr int kSelThreads = 1024;
constexpr int kCopyThreads = 256;
constexpr int kMaxHandles = 8;
constexpr int kModeVJ = 1;
constexpr int kModeCS = 2;
constexpr int kMinDriver = 12040;

// The parameter block, 32 64-bit words (kernels/schedule.py PARAM_WORDS
// and its word indices mirror it).
struct Params {
  long long k;           // 0: the tick scan_step copies next
  long long K;           // 1: ticks this launch
  long long force;       // 2: 1 + the host's bucket slots (0: schedule)
  long long steps;       // 3: scan_step's runs this launch
  long long branch;      // 4: the last tick's body
  long long esel;        // 5: the last tick's escape body (0, 1, 2)
  long long frames_src;  // 6: tick 0's frames
  long long out[4];      // 7-10: the output packs, (rows, K, N) each
  long long commits;     // 11: scan_commit's runs this launch
  long long pad[4];      // 12-15
  long long runs[16];    // 16-31: runs this launch: tick_select's by the
                         // body it chose (0..), escape_select's at 8 + esel
};
static_assert(sizeof(Params) == 32 * 8, "Params is 32 words");

// handle j stands for selection value first + j
struct Handles {
  unsigned long long h[kMaxHandles];
  int n;
  int first;
};

// One copy of scan_commit: src -> dst (slot < 0) or -> row (row * K + k)
// of output pack ``slot`` (rows of ``stride`` bytes).
struct Seg {
  long long src, dst, bytes, slot, row, stride;
};

__device__ void set_handles(const Handles& h, int value) {
  for (int j = 0; j < h.n; ++j) {
    cudaGraphSetConditional(h.h[j], h.first + j == value ? 1u : 0u);
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums of a and b over the block (every thread gets them).
__device__ int2 block_sum(int a, int b, int* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (threadIdx.x == 0) scratch[0] = scratch[1] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&scratch[0], a);
    atomicAdd(&scratch[1], b);
  }
  __syncthreads();
  return make_int2(scratch[0], scratch[1]);
}

// A select kernel's threads for n streams: one a compare-exchange pair of
// the sort (fewer warps at each barrier), at least a warp, at most 1,024.
int select_threads(int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  return n2 / 2 < 32 ? 32 : n2 / 2 > kSelThreads ? kSelThreads : n2 / 2;
}

// Bitonic sort of key[0, n2), n2 a power of two, descending.
__device__ void sort_desc(unsigned long long* key, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = key[lo], b = key[hi];
        if ((a < b) == desc) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ unsigned long long sched_key(unsigned v, int i) {
  return (static_cast<unsigned long long>(v) << 32) | (0xFFFFFFFFu - i);
}

__device__ __forceinline__ int key_stream(unsigned long long k) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k));
}

__device__ int pow2_at_least(int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  return n2;
}

// The tick's body: 0 track, 1..m the bucket at s * kb slots, m + 1
// wbtrack, m + 2 full (overload "full"); m = cap / kb.  Writes the served
// slots (cap of them, oldest first, padded with n) and the new pend_age.
// force = 1 + slots (the host's own bucket, step_bucket): the bucket over
// that many slots (0: track) on the host's idx, pend_age kept.  Then k
// advanced and the loop's handle (loop.n == 0: none) set to k < K.
__global__ void __launch_bounds__(kSelThreads)
    tick_select_kernel(const int* __restrict__ mode,
                       const int* __restrict__ age, int n, int kb, int cap,
                       int rotate, long long* __restrict__ idx,
                       int* __restrict__ age_out, Params* p, Handles h,
                       Handles loop) {
  __shared__ unsigned long long key[kMaxN];
  __shared__ unsigned char served[kMaxN];
  __shared__ int scratch[2];
  const int n2 = pow2_at_least(n);
  int pend = 0, vj = 0;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    unsigned long long k = 0;
    if (i < n) {
      const int m = mode[i];
      if (m != kModeCS) {
        ++pend;
        k = sched_key(static_cast<unsigned>(1 + age[i]), i);
      }
      vj += m == kModeVJ;
      served[i] = 0;
    }
    key[i] = k;
  }
  const int2 sums = block_sum(pend, vj, scratch);
  const int npend = sums.x, npend_vj = sums.y;
  const int m = cap / kb;
  const int force = static_cast<int>(p->force);
  int branch;
  if (force > 0) {
    branch = (force - 1) / kb;
  } else if (npend == 0) {
    branch = 0;
  } else if (npend_vj == 0) {
    branch = m + 1;
  } else if (npend <= cap || rotate) {
    branch = min((npend + kb - 1) / kb, m);
  } else {
    branch = m + 2;
  }
  const bool bucket = branch >= 1 && branch <= m;
  if (force > 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) age_out[i] = age[i];
  } else {
    const int nserved = bucket ? min(npend, cap) : 0;
    if (bucket) sort_desc(key, n2);
    for (int t = threadIdx.x; t < cap; t += blockDim.x) {
      const int s = t < nserved ? key_stream(key[t]) : n;
      idx[t] = s;
      if (s < n) served[s] = 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      age_out[i] = bucket && mode[i] != kModeCS && !served[i] ? age[i] + 1
                                                               : 0;
    }
  }
  if (threadIdx.x == 0) {
    p->branch = branch;
    p->runs[branch] += 1;
    set_handles(h, branch);
    p->k += 1;
    if (loop.n) cudaGraphSetConditional(loop.h[0], p->k < p->K ? 1u : 0u);
  }
}

// The escape fallback's body: 0 none, 1 few (the escaped streams' slots,
// lowest index first, padded with n: eb of them), 2 many.  few only when
// eb < n, as the reference.
__global__ void __launch_bounds__(kSelThreads)
    escape_select_kernel(const unsigned char* __restrict__ esc, int n, int eb,
                         long long* __restrict__ eidx, Params* p, Handles h) {
  __shared__ unsigned long long key[kMaxN];
  __shared__ int scratch[2];
  const int n2 = pow2_at_least(n);
  int count = 0;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const bool e = i < n && esc[i] != 0;
    count += e;
    key[i] = e ? sched_key(1u, i) : 0ull;
  }
  const int nesc = block_sum(count, 0, scratch).x;
  const int sel = nesc == 0 ? 0 : (eb < n && nesc <= eb) ? 1 : 2;
  if (sel == 1) sort_desc(key, n2);
  for (int t = threadIdx.x; t < eb; t += blockDim.x) {
    eidx[t] = sel == 1 && t < nesc ? key_stream(key[t]) : n;
  }
  if (threadIdx.x == 0) {
    p->esel = sel;
    p->runs[8 + sel] += 1;
    set_handles(h, sel);
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          long long bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(bytes)) & 15) == 0;
}

// dst[0, bytes) = src[0, bytes), the grid's x CTAs striding over it; on
// the 16-byte grid four vectors a thread loaded before any is stored.
__device__ void copy_bytes(unsigned char* __restrict__ dst,
                           const unsigned char* __restrict__ src,
                           long long bytes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  if (aligned16(dst, src, bytes)) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const long long nv = bytes / 16;
    long long i = t;
    for (; i + 3 * step < nv; i += 4 * step) {
      const int4 a = s[i], b = s[i + step], c = s[i + 2 * step],
                 e = s[i + 3 * step];
      d[i] = a;
      d[i + step] = b;
      d[i + 2 * step] = c;
      d[i + 3 * step] = e;
    }
    for (; i < nv; i += step) d[i] = s[i];
  } else {
    for (long long i = t; i < bytes; i += step) dst[i] = src[i];
  }
}

constexpr int kTileVectors = 4;  // scan_step's 16-byte vectors a thread

// The grid that gives each of scan_step's threads kTileVectors vectors.
int step_ctas(long long bytes) {
  const long long tile = kCopyThreads * kTileVectors * 16ll;
  const long long c = (bytes + tile - 1) / tile;
  return c < 1 ? 1 : c > (1 << 30) ? (1 << 30) : static_cast<int>(c);
}

// Tick k's frames into the bodies' buffer (no copy when they are it, as a
// single tick's own frames may be); a CTA a tile of kTileVectors vectors
// a thread, each loaded before any is stored (one pass over the grid, as
// step_ctas sizes it; off the 16-byte grid, bytes strided over it).
__global__ void __launch_bounds__(kCopyThreads)
    scan_step_kernel(Params* p, unsigned char* __restrict__ frames,
                     long long frame_bytes) {
  const long long k = p->k;
  if (blockIdx.x == 0 && threadIdx.x == 0) p->steps += 1;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(p->frames_src) + k * frame_bytes;
  if (src != frames && aligned16(frames, src, frame_bytes)) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(frames);
    const long long nv = frame_bytes / 16;
    const long long base =
        static_cast<long long>(blockIdx.x) * kCopyThreads * kTileVectors +
        threadIdx.x;
    int4 v[kTileVectors];
#pragma unroll
    for (int j = 0; j < kTileVectors; ++j) {
      const long long i = base + j * kCopyThreads;
      if (i < nv) v[j] = s[i];
    }
#pragma unroll
    for (int j = 0; j < kTileVectors; ++j) {
      const long long i = base + j * kCopyThreads;
      if (i < nv) d[i] = v[j];
    }
  } else if (src != frames) {
    copy_bytes(frames, src, frame_bytes);
  }
}

// The tick's copies (blockIdx.y a segment): outputs into row k of their
// pack, the new state over the state every body reads; k = p->k - 1.
__global__ void __launch_bounds__(kCopyThreads)
    scan_commit_kernel(Params* p, const Seg* __restrict__ segs) {
  const Seg s = segs[blockIdx.y];
  const long long k = p->k - 1;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    p->commits += 1;
  }
  unsigned char* dst =
      s.slot < 0 ? reinterpret_cast<unsigned char*>(s.dst)
                 : reinterpret_cast<unsigned char*>(p->out[s.slot]) +
                       (s.row * p->K + k) * s.stride;
  copy_bytes(dst, reinterpret_cast<const unsigned char*>(s.src), s.bytes);
}

constexpr int kCommitCtas = 32;  // a segment's CTAs

bool check_n(int n) { return n >= 1 && n <= kMaxN; }

Handles no_handles() {
  Handles h;
  memset(&h, 0, sizeof h);
  return h;
}

// The node types a conditional body may hold: kernel, memcpy, memset,
// child graph, empty, conditional.
bool allowed(cudaGraphNodeType t) {
  return t == cudaGraphNodeTypeKernel || t == cudaGraphNodeTypeMemcpy ||
         t == cudaGraphNodeTypeMemset || t == cudaGraphNodeTypeGraph ||
         t == cudaGraphNodeTypeEmpty || t == cudaGraphNodeTypeConditional;
}

// 0, a CUDA error, or -(1000 + 100 * body + type) for a refused node.
int check_body(cudaGraph_t g, int body) {
  size_t count = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &count);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (count == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[count];
  e = cudaGraphGetNodes(g, nodes, &count);
  int rc = static_cast<int>(e);
  for (size_t i = 0; rc == 0 && i < count; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) {
      rc = static_cast<int>(e);
    } else if (!allowed(t)) {
      rc = -(1000 + 100 * body + static_cast<int>(t));
    }
  }
  delete[] nodes;
  return rc;
}

struct Program {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

#define TRY(x)                                   \
  do {                                           \
    cudaError_t e_ = (x);                        \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

int add_kernel(cudaGraphNode_t* node, cudaGraph_t g,
               const cudaGraphNode_t* deps, size_t ndeps, void* fn, dim3 grid,
               dim3 block, void** args) {
  cudaKernelNodeParams kp;
  memset(&kp, 0, sizeof kp);
  kp.func = fn;
  kp.gridDim = grid;
  kp.blockDim = block;
  kp.kernelParams = args;
  TRY(cudaGraphAddKernelNode(node, g, deps, ndeps, &kp));
  return 0;
}

// A conditional node of ``type`` on ``handle`` after deps; *body its graph.
int add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                    const cudaGraphNode_t* deps, size_t ndeps,
                    cudaGraphConditionalHandle handle,
                    cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  // zeroed storage: the struct's union has no default constructor
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  memset(raw, 0, sizeof raw);
  cudaGraphNodeParams& np = *reinterpret_cast<cudaGraphNodeParams*>(raw);
  np.type = cudaGraphNodeTypeConditional;
  np.conditional.handle = handle;
  np.conditional.type = type;
  np.conditional.size = 1;
  TRY(cudaGraphAddNode(node, g, deps, ndeps, &np));
  *body = np.conditional.phGraph_out[0];
  return 0;
}

// Word indices of sched_program_build's argument array (kernels/schedule.py
// BUILD_ARGS mirrors them).
enum BuildArg {
  kMode, kAge, kIdx, kAgeOut, kParams, kN, kKb, kCap, kRotate, kEsc, kEidx,
  kEb, kFrames, kFrameBytes, kSegs, kNseg, kFew, kMany, kNumArgs
};

int build(Program* prog, const long long* a, const unsigned long long* bodies,
          int nb) {
  cudaGraph_t g;
  TRY(cudaGraphCreate(&g, 0));
  prog->graph = g;
  cudaGraphConditionalHandle loop;
  TRY(cudaGraphConditionalHandleCreate(&loop, g, 1,
                                       cudaGraphCondAssignDefault));
  cudaGraphNode_t wnode;
  cudaGraph_t body;
  int rc = add_conditional(&wnode, g, nullptr, 0, loop,
                           cudaGraphCondTypeWhile, &body);
  if (rc) return rc;

  Params* p = reinterpret_cast<Params*>(a[kParams]);
  unsigned char* frames = reinterpret_cast<unsigned char*>(a[kFrames]);
  long long frame_bytes = a[kFrameBytes];
  Handles hl = no_handles();
  hl.n = 1;
  hl.h[0] = loop;
  void* step_args[] = {&p, &frames, &frame_bytes};
  cudaGraphNode_t step;
  rc = add_kernel(&step, body, nullptr, 0,
                  reinterpret_cast<void*>(scan_step_kernel),
                  dim3(step_ctas(frame_bytes)),
                  dim3(kCopyThreads), step_args);
  if (rc) return rc;

  // the tick's bodies: IF nodes after the select kernel, which the
  // handles need to exist before it is added
  cudaGraphConditionalHandle hb[kMaxHandles];
  cudaGraphNode_t ifs[kMaxHandles];
  for (int b = 0; b < nb; ++b) {
    TRY(cudaGraphConditionalHandleCreate(&hb[b], body, 0,
                                         cudaGraphCondAssignDefault));
  }
  const int* mode = reinterpret_cast<const int*>(a[kMode]);
  const int* age = reinterpret_cast<const int*>(a[kAge]);
  int n = static_cast<int>(a[kN]), kb = static_cast<int>(a[kKb]);
  int cap = static_cast<int>(a[kCap]), rotate = static_cast<int>(a[kRotate]);
  long long* idx = reinterpret_cast<long long*>(a[kIdx]);
  int* age_out = reinterpret_cast<int*>(a[kAgeOut]);
  Handles hs = no_handles();
  hs.n = nb;
  for (int b = 0; b < nb; ++b) hs.h[b] = hb[b];
  void* sel_args[] = {&mode, &age, &n, &kb, &cap, &rotate, &idx, &age_out,
                      &p, &hs, &hl};
  cudaGraphNode_t sel;
  rc = add_kernel(&sel, body, &step, 1,
                  reinterpret_cast<void*>(tick_select_kernel), dim3(1),
                  dim3(select_threads(n)), sel_args);
  if (rc) return rc;
  for (int b = 0; b < nb; ++b) {
    cudaGraph_t bb;
    rc = add_conditional(&ifs[b], body, &sel, 1, hb[b], cudaGraphCondTypeIf,
                         &bb);
    if (rc) return rc;
    cudaGraphNode_t inner;
    TRY(cudaGraphAddChildGraphNode(&inner, bb, nullptr, 0,
                                   reinterpret_cast<cudaGraph_t>(bodies[b])));
  }

  // the escape fallback, where a band is on
  cudaGraphNode_t tail[2];
  const cudaGraphNode_t* last = ifs;
  size_t nlast = nb;
  if (a[kEsc] != 0) {
    const unsigned char* esc = reinterpret_cast<const unsigned char*>(a[kEsc]);
    long long* eidx = reinterpret_cast<long long*>(a[kEidx]);
    int eb = static_cast<int>(a[kEb]);
    Handles he = no_handles();
    const bool few = a[kFew] != 0;
    cudaGraphConditionalHandle hf = 0, hm = 0;
    if (few) {
      TRY(cudaGraphConditionalHandleCreate(&hf, body, 0,
                                           cudaGraphCondAssignDefault));
    }
    TRY(cudaGraphConditionalHandleCreate(&hm, body, 0,
                                         cudaGraphCondAssignDefault));
    he.first = few ? 1 : 2;
    he.n = few ? 2 : 1;
    he.h[0] = few ? hf : hm;
    he.h[1] = hm;
    void* esel_args[] = {&esc, &n, &eb, &eidx, &p, &he};
    cudaGraphNode_t esel;
    rc = add_kernel(&esel, body, ifs, nb,
                    reinterpret_cast<void*>(escape_select_kernel), dim3(1),
                    dim3(select_threads(n)), esel_args);
    if (rc) return rc;
    nlast = 0;
    if (few) {
      cudaGraph_t bb;
      rc = add_conditional(&tail[nlast], body, &esel, 1, hf,
                           cudaGraphCondTypeIf, &bb);
      if (rc) return rc;
      cudaGraphNode_t inner;
      TRY(cudaGraphAddChildGraphNode(&inner, bb, nullptr, 0,
                                     reinterpret_cast<cudaGraph_t>(a[kFew])));
      ++nlast;
    }
    cudaGraph_t bb;
    rc = add_conditional(&tail[nlast], body, &esel, 1, hm,
                         cudaGraphCondTypeIf, &bb);
    if (rc) return rc;
    cudaGraphNode_t inner;
    TRY(cudaGraphAddChildGraphNode(&inner, bb, nullptr, 0,
                                   reinterpret_cast<cudaGraph_t>(a[kMany])));
    ++nlast;
    last = tail;
  }

  const Seg* segs = reinterpret_cast<const Seg*>(a[kSegs]);
  void* commit_args[] = {&p, &segs};
  cudaGraphNode_t commit;
  rc = add_kernel(&commit, body, last, nlast,
                  reinterpret_cast<void*>(scan_commit_kernel),
                  dim3(kCommitCtas, static_cast<unsigned>(a[kNseg])),
                  dim3(kCopyThreads), commit_args);
  if (rc) return rc;
  TRY(cudaGraphInstantiate(&prog->exec, g, 0));
  return 0;
}

void destroy(Program* prog) {
  if (prog->exec) cudaGraphExecDestroy(prog->exec);
  if (prog->graph) cudaGraphDestroy(prog->graph);
  delete prog;
}

}  // namespace

extern "C" int tick_select_launch(const void* mode, const void* age,
                                  void* idx, void* age_out, void* params,
                                  int n, int kb, int cap, int rotate,
                                  void* stream) {
  if (!check_n(n) || kb < 1 || cap < kb || cap % kb || cap > n ||
      cap / kb + 3 > kMaxHandles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tick_select_kernel<<<1, select_threads(n), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mode), static_cast<const int*>(age), n, kb, cap,
      rotate, static_cast<long long*>(idx), static_cast<int*>(age_out),
      static_cast<Params*>(params), no_handles(), no_handles());
  return static_cast<int>(cudaGetLastError());
}

extern "C" int escape_select_launch(const void* esc, void* eidx, void* params,
                                    int n, int eb, void* stream) {
  if (!check_n(n) || eb < 1) return static_cast<int>(cudaErrorInvalidValue);
  escape_select_kernel<<<1, select_threads(n), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(esc), n, eb,
      static_cast<long long*>(eidx), static_cast<Params*>(params),
      no_handles());
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scan_step_launch(void* params, void* frames,
                                long long frame_bytes, void* stream) {
  if (frame_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  scan_step_kernel<<<step_ctas(frame_bytes), kCopyThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<Params*>(params), static_cast<unsigned char*>(frames),
      frame_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scan_commit_launch(void* params, const void* segs,
                                  int nseg, void* stream) {
  if (nseg < 1 || nseg > 65535) return static_cast<int>(cudaErrorInvalidValue);
  scan_commit_kernel<<<dim3(kCommitCtas, nseg), kCopyThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<Params*>(params), static_cast<const Seg*>(segs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sched_driver_version(void* out) {
  return static_cast<int>(cudaDriverGetVersion(static_cast<int*>(out)));
}

extern "C" int sched_program_build(const void* args, int nargs,
                                   const void* bodies, int nb, void* out) {
  const long long* a = static_cast<const long long*>(args);
  if (nargs != kNumArgs || nb < 1 || nb > kMaxHandles ||
      !check_n(static_cast<int>(a[kN]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int version = 0;
  TRY(cudaDriverGetVersion(&version));
  if (version < kMinDriver) return -1;
  const unsigned long long* b = static_cast<const unsigned long long*>(bodies);
  for (int i = 0; i < nb + 2; ++i) {
    const unsigned long long g = i < nb ? b[i] : a[kFew + i - nb];
    if (g == 0) continue;
    const int rc = check_body(reinterpret_cast<cudaGraph_t>(g), i);
    if (rc) return rc;
  }
  Program* prog = new Program;
  const int rc = build(prog, a, b, nb);
  if (rc) {
    destroy(prog);
    return rc;
  }
  *static_cast<void**>(out) = prog;
  return 0;
}

extern "C" int sched_program_launch(void* prog, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<Program*>(prog)->exec,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int sched_program_destroy(void* prog) {
  destroy(static_cast<Program*>(prog));
  return 0;
}

extern "C" int sched_error_string(int code, void* buf, int len) {
  const char* s = cudaGetErrorString(static_cast<cudaError_t>(code));
  strncpy(static_cast<char*>(buf), s, len - 1);
  static_cast<char*>(buf)[len - 1] = 0;
  return 0;
}
