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
//                  many (lax.switch) and the top_k of the escaped streams
//                  (few), or all of them in chunks (many);
//   scan_step      :426 scan_steps (lax.scan), whose tick k reads its
//                  slice of the frames: tick k's frames (or some of their
//                  rows) copied into a buffer.  The program runs none: all
//                  of its bodies' frame readers read tick k's frames in
//                  place;
//   scan_commit    the scan's carry and stacked outputs: the tick body's
//                  results, its outputs into row k of the (fields, K, N)
//                  output packs and its new state over the state every
//                  body reads; a sub-batch's rows merged by its slot map
//                  (:210-223 _scatter_subbatch: rows kept and not padding
//                  written, the rest dropped): a bucket body's into its
//                  own table, an escape body's as a table of rows alone
//                  written after the tick body's (the many body's a chunk
//                  at a time, after a tick commit that holds the escaped
//                  streams' state rows: :264-274 many's tree_where);
//   slot_gather    :299-320 _apply_bucket's and :249-274 the escape
//                  branches' gathers (a[safe] over the state): every leaf's
//                  rows at min(idx, N - 1) into the sub-batch, and the
//                  kept flags (idx < N, and under the bucket's rule not in
//                  CS), one launch over a by-value table of leaves, its
//                  grid sized by the rows' bytes.
// What bounds them: none moves more than the tick's frames (scan_step's
// whole mode, bytes: N x H x W x 3 read and written, 0.0352 ms at 256 x
// 240 x 320 on an H100 SXM at 3.35 TB/s; its rows mode s rows of H x W x
// 3, 0.0011 ms at 8 rows) or the state (scan_commit: the leaves a
// body changed, ~0.08 MB at 256 streams on an all-CS tick, whose camshift
// passes its 4.2 MB model histograms through, ~4.3 MB on a tick that
// changes them); the two selects read 4 to 8 bytes a stream and write 4, and
// are a chain of latencies (a count, an atomic ticket, a merge in one
// CTA).  A graph launch costs one host call where a tick of host
// scheduling cost a launch a body and a host read; that, not these
// kernels' time, is what they are for.
//
// Design:
//   - A select is a grid of CTAs of kSelThreads threads (select_grid: at
//     most kMaxSelCtas), CTA b over the streams [b * span, (b + 1) * span),
//     span a multiple of kSelThreads and at most kSelKeys, in passes of
//     kSelThreads.  Each CTA counts its pending (or escaped) streams and
//     appends their keys, in stream order, to shared memory (a warp ballot
//     and __popc a pass): for tick_select one 64-bit word each, (1 +
//     pend_age) << 32 | ~i, so that the oldest pending streams sort first
//     and ties go to the lower index (top_k's order); for escape_select the
//     index.  Its candidates are those keys; past cap of them, under
//     overload "rotate" its cap largest (a bitonic sort), else none (the
//     tick cannot be a bucket tick).  It writes its counts and candidates
//     to a scratch buffer (select_scratch_bytes; the program allocates one
//     a batch size) and takes an atomic ticket.  The CTA that finishes
//     last resets the ticket for the next launch (a replayed graph runs no
//     memset of it), sums the counts, chooses the body, merges the
//     candidates in shared memory (in the scratch buffer past kSelKeys of
//     them), sorts them descending and serves the min(npend, cap) first.
//     Keys are unique, so the result does not depend on which CTA finishes
//     last.  One thread of that CTA sets every handle, the chosen one to 1,
//     after every count has landed, so no handle keeps a value from another
//     tick.  The grid keeps ctas x cap <= kSelKeys where the streams allow,
//     so that a bucket tick's merge fits in shared memory.
//   - pend_age: every CTA writes 0 (forced: the entry pend_age) for its
//     streams; only a rotation that leaves pending streams unserved has the
//     last CTA write age + 1 to the pending streams whose key is below the
//     cap-th.  A steady tick (no stream pending) is the count alone.
//   - tick_select's last CTA, the tick's first node, writes where tick
//     k's frames lie (frame_at: frames_src + k x frame bytes), advances k
//     and sets the loop's handle.  scan_commit reads the advanced k and
//     writes row k - 1.
//   - The frames stay where the caller put them.  Every frame reader of
//     every body (histpdf_band, hist_mma, hist4096, the backprojections,
//     frame_prep, handoff, and the escape bodies' slot_gather) reads tick
//     k's frames at frame_at (the kernel loads the address from the
//     parameter block), so no body copies a frame.
//   - Each body keeps its own results (the tensors its capture returned,
//     held for the graph's lifetime), so no body writes a shared buffer.
//     scan_commit reads a table a body (kernels/schedule.py segments):
//     the body's state leaves over the state every body reads (a leaf the
//     body passed through, the very tensor, has no entry; pend_age comes
//     from tick_select's age_out), its outputs into their pack rows (a
//     1-D strided output gathered).  It picks the tick body's table
//     (p->branch); on a tick whose escape body ran (p->esel) it skips,
//     since that body's IF graph committed.  The copy is balanced by
//     bytes, not by entry: a table's entries are one flat run of 16-byte chunks (an
//     entry's first chunk in its row), the grid a wave of CTAs over the
//     largest table striding over the chosen one, so one large leaf gets the
//     whole card; a chunk whose source or destination is off the 16-byte
//     grid (a row of N bools) is copied byte by byte.  escape_select reads
//     the tick body's own escaped flags (their address in esc_at, by
//     p->branch).  The few body reads the state every body reads, before
//     anything commits: its IF graph runs the body, which
//     gathers its slots' rows (slot_gather) and returns them and its
//     step's results on them, then scan_commit of the tick body's table,
//     then scan_commit of the few body's, each changed leaf's kept rows
//     alone, so an escape within escape_bucket copies no leaf whole.
//   - The many body computes the escaped streams alone, in chunks: on
//     many escape_select lists every escaped stream (lowest first, padded
//     with n) and plans its chunks (chunk_plan): big ones of mb slots,
//     then at most kTailChunks small ones of m for the rest.  Its IF
//     graph runs scan_commit of the tick body's table with the escaped
//     streams' rows of every state leaf but pend_age held (their flags by
//     p->branch), so those rows stay the pre-step state's, then a WHILE
//     node over the big chunks and one over the small: a chunk body
//     gathers its chunk's slots of the list (slot_gather, the state's
//     rows and tick k's frames read in place), runs the full-frame
//     "track" step on them, and scan_commit writes the kept rows of what
//     it changed and of its outputs (escaped excepted), advances the
//     loop's chunk and sets its handle.  No leaf is staged or copied
//     whole, and the device work grows with the escaped streams.
//   - The parameter block (Params) lives in device memory; the host writes
//     it before each launch (k = 0, K, the frames' and output packs'
//     addresses) and reads it back with the last tick's modes: each kernel
//     counts its own runs there (tick_select and escape_select by the body
//     each chose), and the launch counters take those counts, not K: a
//     kernel node's arguments are fixed when the graph is built, the
//     block's contents are not.
//   - sched_program_build assembles the graph: a WHILE node whose body is
//     tick_select -> one IF node a tick body -> escape_select -> IF few,
//     IF many -> scan_commit, each tick body's and the few body's IF node
//     a child graph node of a PyTorch-captured body (the
//     few body's followed by its two scan_commits), the many body's IF
//     node the held tick commit -> WHILE (chunk body -> scan_commit):
//     conditional nodes nested three deep.  It walks each body's nodes
//     first and refuses a node type a conditional body cannot hold.
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

constexpr int kSelThreads = 256;  // a select CTA's threads: a pass of streams
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelKeys = 4096;    // a select CTA's shared keys
constexpr int kMaxSelCtas = 256;  // the last CTA reads a CTA's counts a thread
constexpr int kCopyThreads = 256;
constexpr int kMaxHandles = 8;
constexpr int kModeVJ = 1;
constexpr int kModeCS = 2;
constexpr int kMinDriver = 12040;

// The parameter block, 38 64-bit words (kernels/schedule.py PARAM_WORDS
// and its word indices mirror it).
struct Params {
  long long k;           // 0: the tick tick_select selects next
  long long K;           // 1: ticks this launch
  long long force;       // 2: 1 + the host's bucket slots (0: schedule)
  long long steps;       // 3: scan_step's runs this launch
  long long branch;      // 4: the last tick's body
  long long esel;        // 5: the last tick's escape body (0, 1, 2)
  long long frames_src;  // 6: tick 0's frames
  long long out[4];      // 7-10: the output packs, (rows, K, N) each
  long long commits;     // 11: scan_commit's runs this launch
  long long frame_at;    // 12: the tick's frames (tick_select writes it)
  long long unused[2];   // 13-14
  long long chunks;      // 15: the many escape body's big chunks this tick
  long long runs[16];    // 16-31: runs this launch: tick_select's by the
                         // body it chose (0..), escape_select's at 8 + esel
  long long chunk;       // 32: the many body's big chunk that runs
  long long chunk_runs;  // 33: its big chunks run this launch
  long long tail;        // 34: its small chunk that runs (from tail0)
  long long tails;       // 35: the end of its small chunks this tick
  long long tail_runs;   // 36: its small chunks run this launch
  long long pad;         // 37
};
static_assert(sizeof(Params) == 38 * 8, "Params is 38 words");

// The many body's chunks for nesc escaped streams, big chunks of mb slots
// and small ones of m (mb a multiple of m): nesc / mb big chunks, one more
// where the rest exceeds kTailChunks small chunks, then the small chunks
// [tail0, tails) of what is left (kernels/schedule.py chunk_plan mirrors
// it).
constexpr long long kTailChunks = 2;

struct ChunkPlan {
  long long big, tail0, tails;
};

__host__ __device__ ChunkPlan chunk_plan(long long nesc, long long m,
                                         long long mb) {
  ChunkPlan c;
  c.big = nesc / mb;
  if (nesc - c.big * mb > kTailChunks * m) c.big += 1;
  c.tail0 = c.big * (mb / m);
  const long long end = (nesc + m - 1) / m;
  c.tails = end > c.tail0 ? end : c.tail0;
  return c;
}

// handle j stands for selection value first + j
struct Handles {
  unsigned long long h[kMaxHandles];
  int n;
  int first;
};

// One entry of a scan_commit table: ``bytes`` from src to dst (slot < 0)
// or to row (row * K + k) of output pack ``slot`` (rows of ``bytes``);
// ``chunk``: its first 16-byte chunk in its table's run of chunks.  A
// source of ``elem``-byte elements ``pitch`` bytes apart (a 1-D strided
// view, such as a column of a row-major (N, 5) tensor; 0: contiguous) is
// gathered element by element into the contiguous destination.
struct Seg {
  long long src, dst, bytes, slot, row, chunk, pitch, elem;
};
static_assert(sizeof(Seg) == 8 * 8, "Seg is 8 words");

// A table's entries: segs[first, first + count), ``chunks`` in all.
struct Table {
  long long first, count, chunks, pad;
};

// An entry's merge of a sub-batch's rows (kernels/schedule.py segments;
// beside each Seg): kind 0 none; kind 1 (merged) the entry's copy with
// each row r that its table's slot map names taken from row j of ``sub``
// (rows of ``rb`` bytes, the slot j with idx[j] == r kept); kind 2 (rows)
// only those rows, the entry's chunks running over the S sub rows, each
// ceil(rb / 16) chunks (the leaf the body passed through whole: no copy
// but of its served rows).  ``pitch``: a 1-D strided sub's element stride
// in bytes (0: contiguous).  The flag kHold (with ``rb`` set) marks a
// state leaf whose held streams' rows a commit with held rows leaves as
// they are.
struct Merge {
  long long sub, rb, pitch, kind;
};
static_assert(sizeof(Merge) == 4 * 8, "Merge is 4 words");
constexpr long long kMergeNone = 0, kMerged = 1, kMergeRows = 2, kHold = 4;

// A table's slot map: row j of its merges lands on row idx[j] where
// keep[j] and idx[j] < n (slots padded with n are dropped); slots 0: none.
struct SlotMap {
  long long idx, keep, slots, n;
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

// A select's grid: ``ctas`` CTAs, CTA b over the streams [b * span,
// (b + 1) * span).  At most kSelKeys / cap CTAs (a bucket tick's merge in
// shared memory), at least n / kSelKeys (a CTA's keys in shared memory),
// at most one a pass of kSelThreads streams; ctas > kMaxSelCtas (past
// 1,048,576 streams) is refused.  kernels/schedule.py select_blocks
// mirrors it.
struct SelGrid {
  int ctas;
  int span;
};

SelGrid select_grid(int n, int cap) {
  const int tiles = (n + kSelThreads - 1) / kSelThreads;
  int g = kSelKeys / cap;
  g = g < 1 ? 1 : g;
  g = g > tiles ? tiles : g;
  g = g > kMaxSelCtas ? kMaxSelCtas : g;
  const int least = (n + kSelKeys - 1) / kSelKeys;
  g = g < least ? least : g;
  SelGrid s;
  s.span = (tiles + g - 1) / g * kSelThreads;
  s.ctas = (n + s.span - 1) / s.span;
  return s;
}

__host__ __device__ int pow2_at_least(int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  return n2;
}

// The scratch buffer's bytes (grid_of lays it out): the ticket (one 64-bit
// word), each CTA's (pending, pending VJ, candidates) as i32, each CTA's
// candidates (span 64-bit words a CTA), then pow2(n) words for a merge
// past kSelKeys.
long long select_scratch(int n, int cap) {
  const SelGrid g = select_grid(n, cap);
  return 8 + (12ll * g.ctas + 7) / 8 * 8 + 8ll * g.ctas * g.span +
         8ll * pow2_at_least(n);
}

bool select_ok(int n, int cap) {
  return n >= 1 && cap >= 1 && select_grid(n, cap).ctas <= kMaxSelCtas;
}

// Bitonic sort of key[0, n2), n2 a power of two, descending (shared or
// global memory: only this CTA touches it).
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

// key[0, n) zero-padded to a power of two and sorted descending.
__device__ void pad_sort(unsigned long long* key, int n) {
  const int n2 = pow2_at_least(n);
  for (int j = n + threadIdx.x; j < n2; j += blockDim.x) key[j] = 0;
  __syncthreads();
  sort_desc(key, n2);
}

// One pass: the keys of the threads that take theirs appended, in thread
// order, at key[base ..].  Returns how many (every thread).
__device__ int append(unsigned long long* key, int base, bool take,
                      unsigned long long k, int* wsum) {
  const unsigned ball = __ballot_sync(0xffffffffu, take);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wsum[warp] = __popc(ball);
  __syncthreads();
  int off = base, total = 0;
  for (int w = 0; w < kSelWarps; ++w) {
    off += w < warp ? wsum[w] : 0;
    total += wsum[w];
  }
  if (take) key[off + __popc(ball & ((1u << lane) - 1u))] = k;
  __syncthreads();
  return total;
}

// The exclusive prefix of v over the CTA's threads in thread order;
// *total gets the sum.
__device__ int block_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int off = 0, t = 0;
  for (int w = 0; w < kSelWarps; ++w) {
    off += w < warp ? wsum[w] : 0;
    t += wsum[w];
  }
  __syncthreads();
  *total = t;
  return off + x - v;
}

// What a select's CTAs leave for the last one, and the last one's merge.
struct Grid {
  unsigned* ticket;
  int* counts;               // (pending, pending VJ, candidates) a CTA
  unsigned long long* cand;  // span a CTA
  unsigned long long* merge;
};

__device__ Grid grid_of(unsigned char* scratch, int span) {
  Grid g;
  g.ticket = reinterpret_cast<unsigned*>(scratch);
  g.counts = reinterpret_cast<int*>(scratch + 8);
  const long long cands = 8 + (12ll * gridDim.x + 7) / 8 * 8;
  g.cand = reinterpret_cast<unsigned long long*>(scratch + cands);
  g.merge = g.cand + static_cast<long long>(gridDim.x) * span;
  return g;
}

// The CTA's counts and its ``keep`` candidates (key[0, keep)) written out,
// then its ticket.  True in the CTA that finished last, which resets the
// ticket, sums the counts into a, b (every thread) and finds each CTA's
// offset in the merged candidates (offs[], *total: their number).
__device__ bool gather_counts(const Grid& g, const unsigned long long* key,
                              int span, int a_cta, int b_cta, int keep,
                              int* a, int* b, int* offs, int* total,
                              int* wsum, int* flag) {
  const long long base = static_cast<long long>(blockIdx.x) * span;
  for (int j = threadIdx.x; j < keep; j += blockDim.x) {
    g.cand[base + j] = key[j];
  }
  if (threadIdx.x == 0) {
    g.counts[3 * blockIdx.x] = a_cta;
    g.counts[3 * blockIdx.x + 1] = b_cta;
    g.counts[3 * blockIdx.x + 2] = keep;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(g.ticket, 1u);
    *flag = t == gridDim.x - 1;
    if (*flag) atomicExch(g.ticket, 0u);
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  const int c = threadIdx.x;  // gridDim.x <= kMaxSelCtas == kSelThreads
  int ca = 0, cb = 0, ck = 0;
  if (c < gridDim.x) {
    ca = __ldcg(g.counts + 3 * c);
    cb = __ldcg(g.counts + 3 * c + 1);
    ck = __ldcg(g.counts + 3 * c + 2);
  }
  int sa, sb;
  const int off = block_scan(ck, wsum, total);
  block_scan(ca, wsum, &sa);
  block_scan(cb, wsum, &sb);
  if (c < gridDim.x) offs[c] = off;
  if (c == 0) offs[gridDim.x] = *total;
  *a = sa;
  *b = sb;
  __syncthreads();
  return true;
}

// The merged candidates into dst[0, total): CTA c's at offs[c], a warp a
// CTA.
template <typename T>
__device__ void merge_cands(const Grid& g, int span, const int* offs,
                            T* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < gridDim.x; c += kSelWarps) {
    const unsigned long long* src =
        g.cand + static_cast<long long>(c) * span;
    const int o = offs[c], len = offs[c + 1] - o;
    for (int j = lane; j < len; j += 32) {
      dst[o + j] = static_cast<T>(__ldcg(src + j));
    }
  }
  __syncthreads();
}

static_assert(kMaxSelCtas == kSelThreads, "a CTA's counts a thread");


// The tick's body: 0 track, 1..m the bucket at s * kb slots, m + 1
// wbtrack, m + 2 full (overload "full"); m = cap / kb.  Writes the served
// slots (cap of them, oldest first, padded with n) and the new pend_age.
// force = 1 + slots (the host's own bucket, step_bucket): the bucket over
// that many slots (0: track) on the host's idx, pend_age kept.  Then tick
// k's frames' address written (frame_at), k advanced and the loop's handle
// (loop.n == 0: none) set to k < K.
__global__ void __launch_bounds__(kSelThreads)
    tick_select_kernel(const int* __restrict__ mode,
                       const int* __restrict__ age, int n, int kb, int cap,
                       int rotate, int span, long long* __restrict__ idx,
                       int* __restrict__ age_out, Params* p,
                       unsigned char* scratch, long long frame_bytes,
                       Handles h, Handles loop) {
  __shared__ unsigned long long key[kSelKeys];
  __shared__ int wsum[kSelWarps];
  __shared__ int offs[kMaxSelCtas + 1];
  __shared__ int sums[2];
  __shared__ int flag;
  const int force = static_cast<int>(p->force);
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, n);
  int pend = 0, vj = 0, r = 0;
  for (int s0 = lo; s0 < hi; s0 += kSelThreads) {
    const int i = s0 + threadIdx.x;
    bool take = false;
    unsigned long long k = 0;
    if (i < hi) {
      const int m = mode[i];
      take = m != kModeCS;
      const int a = take || force > 0 ? age[i] : 0;
      if (take) k = sched_key(static_cast<unsigned>(1 + a), i);
      vj += m == kModeVJ;
      age_out[i] = force > 0 ? a : 0;
    }
    pend += take;
    r += append(key, r, take, k, wsum);
  }
  // the CTA's candidates: its pending streams; past cap of them its cap
  // oldest under "rotate", else none (more than cap pending: no bucket)
  int keep = force > 0 ? 0 : r;
  bool sorted = false;
  if (keep > cap) {
    if (rotate) {
      pad_sort(key, r);
      sorted = true;
    }
    keep = rotate ? cap : 0;
  }
  const int2 cta = block_sum(pend, vj, sums);
  int npend = cta.x, npend_vj = cta.y, total = keep;
  unsigned long long* buf = key;
  const Grid g = grid_of(scratch, span);
  if (gridDim.x > 1 &&
      !gather_counts(g, key, span, cta.x, cta.y, keep, &npend, &npend_vj,
                     offs, &total, wsum, &flag)) {
    return;
  }
  const int m = cap / kb;
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
  const bool bucket = force == 0 && branch >= 1 && branch <= m;
  if (bucket && gridDim.x > 1) {  // the grid's candidates, merged
    buf = total <= kSelKeys ? key : g.merge;
    merge_cands(g, span, offs, buf);
    sorted = false;
  }
  if (bucket && !sorted) pad_sort(buf, total);
  if (force == 0) {
    const int served = bucket ? min(npend, cap) : 0;
    for (int t = threadIdx.x; t < cap; t += kSelThreads) {
      idx[t] = t < served ? key_stream(buf[t]) : n;
    }
    if (bucket && npend > cap) {  // a rotation: the unserved pending age
      const unsigned long long last = buf[served - 1];
      for (int i = threadIdx.x; i < n; i += kSelThreads) {
        if (mode[i] != kModeCS) {
          const int a = age[i];
          if (sched_key(static_cast<unsigned>(1 + a), i) < last) {
            age_out[i] = a + 1;
          }
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    p->branch = branch;
    p->runs[branch] += 1;
    set_handles(h, branch);
    p->frame_at = p->frames_src + p->k * frame_bytes;
    p->k += 1;
    if (loop.n) cudaGraphSetConditional(loop.h[0], p->k < p->K ? 1u : 0u);
  }
}

// The escape fallback's body: 0 none, 1 few (the escaped streams' slots,
// lowest index first, padded with n: eb of them), 2 many.  few only when
// eb < n, as the reference.  With a list (``elist``, ``len`` slots, a
// multiple of the big chunk ``mb``, itself one of the small chunk ``m``):
// on many every escaped stream, lowest index first, padded with n, and
// the chunks of chunk_plan (else none): p->chunks big, p->chunk = 0, the
// small ones p->tail = tail0 to p->tails.
// esc_at: null, or the escaped flags' address a tick body, read at
// p->branch in place of ``esc`` (the program: each body's own results).
__global__ void __launch_bounds__(kSelThreads)
    escape_select_kernel(const unsigned char* esc,
                         const long long* __restrict__ esc_at, int n, int eb,
                         int span, long long* __restrict__ eidx, Params* p,
                         unsigned char* scratch, Handles h,
                         long long* __restrict__ elist, int m, int mb,
                         long long len) {
  __shared__ unsigned long long key[kSelKeys];
  if (esc_at) esc = reinterpret_cast<const unsigned char*>(esc_at[p->branch]);
  __shared__ int wsum[kSelWarps];
  __shared__ int offs[kMaxSelCtas + 1];
  __shared__ int sums[2];
  __shared__ int flag;
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, n);
  int count = 0, r = 0;
  for (int s0 = lo; s0 < hi; s0 += kSelThreads) {
    const int i = s0 + threadIdx.x;
    const bool e = i < hi && esc[i] != 0;
    count += e;
    r += append(key, r, e, static_cast<unsigned long long>(i), wsum);
  }
  // the CTA's escaped streams in order; without a list past eb of them
  // none ("many")
  const int keep = elist || r <= eb ? r : 0;
  int nesc = block_sum(count, 0, sums).x, unused, total = keep;
  const Grid g = grid_of(scratch, span);
  if (gridDim.x > 1 &&
      !gather_counts(g, key, span, nesc, 0, keep, &nesc, &unused, offs,
                     &total, wsum, &flag)) {
    return;
  }
  const int sel = nesc == 0 ? 0 : (eb < n && nesc <= eb) ? 1 : 2;
  const int few = sel == 1 ? nesc : 0;
  for (int t = few + threadIdx.x; t < eb; t += kSelThreads) eidx[t] = n;
  if (few && gridDim.x == 1) {
    for (int t = threadIdx.x; t < few; t += kSelThreads) eidx[t] = key[t];
  } else if (few) {
    merge_cands(g, span, offs, eidx);
  }
  const bool listed = elist && sel == 2;
  if (listed && gridDim.x == 1) {
    for (int t = threadIdx.x; t < nesc; t += kSelThreads) elist[t] = key[t];
  } else if (listed) {
    merge_cands(g, span, offs, elist);
  }
  if (listed) {
    for (long long t = nesc + threadIdx.x; t < len; t += kSelThreads) {
      elist[t] = n;
    }
  }
  if (threadIdx.x == 0) {
    if (elist) {
      const ChunkPlan c = chunk_plan(listed ? nesc : 0, m, mb);
      p->chunks = c.big;
      p->chunk = 0;
      p->tail = c.tail0;
      p->tails = c.tails;
    }
    p->esel = sel;
    p->runs[8 + sel] += 1;
    set_handles(h, sel);
  }
}

// An empty kernel at a select's grid: the floor of one device operation.
__global__ void __launch_bounds__(kSelThreads) select_floor_kernel() {}
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

// scan_step's 16-byte vectors a thread.  One, with streaming loads and
// stores (evict first: the copy is read once, by the body), matched
// copy_ (a device-to-device cudaMemcpy) on an H100 where 2, 4 or 8
// vectors, plain loads and stores, 128 or 512 threads a CTA or a
// grid-stride loop were 0.3-6% slower (tools/torch_copy_variants.py,
// PERF.md).
constexpr int kTileVectors = 1;

// The grid.x that gives each of scan_step's threads kTileVectors vectors
// of a copy of ``bytes``.
int step_ctas(long long bytes) {
  const long long tile = kCopyThreads * kTileVectors * 16ll;
  const long long c = (bytes + tile - 1) / tile;
  return c < 1 ? 1 : c > (1 << 30) ? (1 << 30) : static_cast<int>(c);
}

// Tick k's frames, at p->frame_at, into the buffer ``frames``.
// Whole mode (rows null): ``bytes`` bytes.  Rows mode: blockIdx.y a slot,
// the row rows[y] of ``bytes`` bytes to the same row (a slot outside [0,
// n) is padding: skipped).  A CTA a tile of kTileVectors vectors a thread,
// each loaded before any is stored (one pass over the grid, as step_ctas
// sizes it), streamed; off the 16-byte grid, bytes strided over the CTAs.
// Nothing is copied where source and buffer are one.  Each run counts in
// p->steps.
__global__ void __launch_bounds__(kCopyThreads)
    scan_step_kernel(Params* p, unsigned char* __restrict__ frames,
                     long long bytes, const long long* __restrict__ rows,
                     int n) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    p->steps += 1;
  }
  long long off = 0;
  if (rows) {
    const long long r = rows[blockIdx.y];
    if (r < 0 || r >= n) return;
    off = r * bytes;
  }
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(p->frame_at) + off;
  unsigned char* dst = frames + off;
  if (src == dst) return;
  if (aligned16(dst, src, bytes)) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const long long nv = bytes / 16;
    const long long base =
        static_cast<long long>(blockIdx.x) * kCopyThreads * kTileVectors +
        threadIdx.x;
    int4 v[kTileVectors];
#pragma unroll
    for (int j = 0; j < kTileVectors; ++j) {
      const long long i = base + j * kCopyThreads;
      if (i < nv) v[j] = __ldcs(s + i);
    }
#pragma unroll
    for (int j = 0; j < kTileVectors; ++j) {
      const long long i = base + j * kCopyThreads;
      if (i < nv) __stcs(d + i, v[j]);
    }
  } else {
    copy_bytes(dst, src, bytes);
  }
}

// scan_commit's table arguments below 0: the program's pick, and the
// tick body's table (kernels/schedule.py TABLE_PICK, TABLE_TICK).
constexpr int kTablePick = -1;
constexpr int kTableTick = -2;
// scan_commit's step of the many escape body's chunk loops
// (kernels/schedule.py CHUNK_START, CHUNK_NEXT, TAIL_NEXT): none; both
// loops' handles set, to whether each has a chunk (the held tick commit
// ahead of the loops); p->chunk advanced, counted in p->chunk_runs, and
// the big loop's handle set to whether a big chunk is left (a big chunk's
// commit); the same for p->tail and the small loop.
constexpr int kChunkNone = 0, kChunkStart = 1, kChunkNext = 2, kTailNext = 3;

// The table of what ran this tick: ``table`` when >= 0; the tick body's
// (p->branch) for kTableTick; else (kTablePick) the tick body's when no
// escape body ran, none when one did (its IF graph committed the tick
// body's table and then its own rows).  -1: nothing.
__device__ __forceinline__ long long commit_table(const Params* p,
                                                  int table) {
  if (table >= 0) return table;
  if (table == kTableTick || p->esel == 0) return p->branch;
  return -1;
}

// The row slot j of a slot map lands on, or -1 (not kept, or padding).
__device__ __forceinline__ long long slot_row(const SlotMap& m, long long j) {
  const long long r = reinterpret_cast<const long long*>(m.idx)[j];
  const bool kept = reinterpret_cast<const unsigned char*>(m.keep)[j] != 0;
  return kept && r >= 0 && r < m.n ? r : -1;
}

// The slot of the slot map whose row is r, or -1.
__device__ __forceinline__ long long slot_of(const SlotMap& m, long long r) {
  for (long long j = 0; j < m.slots; ++j) {
    if (slot_row(m, j) == r) return j;
  }
  return -1;
}

// Byte o of sub row j.
__device__ __forceinline__ unsigned char sub_byte(const Merge& g,
                                                  long long j, long long o) {
  const unsigned char* sub = reinterpret_cast<const unsigned char*>(g.sub);
  return g.pitch ? sub[j * g.pitch + o] : sub[j * g.rb + o];
}

// Whether a row in [r0, r1] is held (its flag in ``held`` set).
__device__ __forceinline__ bool any_held(const unsigned char* held,
                                         long long r0, long long r1) {
  bool any = false;
  for (long long r = r0; r <= r1 && !any; ++r) any = held[r] != 0;
  return any;
}

// A table's copies, k = p->k - 1: each entry's bytes to its destination (a
// pack row: row * K + k of its pack).  The table's entries are one run of
// 16-byte chunks, thread t taking chunks t, t + the grid's threads, ...: a
// thread finds its first chunk's entry by bisection and walks on from it.
// A chunk copies as one vector where its entry's source and destination
// are 16-byte aligned and it is whole, else byte by byte (a strided
// source: element by element, an element's bytes each).  With a slot map
// (maps, the table's; a bucket body's sub-batch) an entry may merge rows
// (merges: a merged entry's chunk takes the bytes of a row the map names
// from the sub row, the rows entry's chunks run over the sub rows alone),
// so no two chunks write one byte and the copy needs no order.  With held
// rows (``hold``: the escaped flags' address a tick body, read at
// p->branch; the many escape body's tick) an entry flagged kHold leaves
// the rows of the escaped streams as they are, for that body's chunks to
// gather them from the pre-step state.  One run counts in p->commits; a
// run that picks no table (an escape body's tick, which its own IF graph
// committed) copies and counts nothing.  ``chunk`` steps the many body's
// chunk loops (their handles ``loop``, ``loop2``; 0: none).
__global__ void __launch_bounds__(kCopyThreads)
    scan_commit_kernel(Params* p, const Table* __restrict__ tables,
                       const Seg* __restrict__ segs,
                       const Merge* __restrict__ merges,
                       const SlotMap* __restrict__ maps,
                       const long long* __restrict__ hold, int table,
                       cudaGraphConditionalHandle loop,
                       cudaGraphConditionalHandle loop2, int chunk) {
  const long long ti = commit_table(p, table);
  if (ti < 0) return;
  const Table t = tables[ti];
  SlotMap m = {0, 0, 0, 0};
  if (maps && merges) m = maps[ti];
  const unsigned char* held =
      hold && merges ? reinterpret_cast<const unsigned char*>(hold[p->branch])
                     : nullptr;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p->commits += 1;
    if (chunk == kChunkNext) {
      p->chunk += 1;
      p->chunk_runs += 1;
    } else if (chunk == kTailNext) {
      p->tail += 1;
      p->tail_runs += 1;
    }
    const bool big = p->chunk < p->chunks, small = p->tail < p->tails;
    if (loop && (chunk == kChunkStart || chunk == kChunkNext)) {
      cudaGraphSetConditional(loop, big ? 1u : 0u);
    }
    if (loop && chunk == kTailNext) {
      cudaGraphSetConditional(loop, small ? 1u : 0u);
    }
    if (loop2 && chunk == kChunkStart) {
      cudaGraphSetConditional(loop2, small ? 1u : 0u);
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= t.chunks) return;
  const long long k = p->k - 1, K = p->K;
  long long lo = t.first, hi = t.first + t.count - 1;
  while (lo < hi) {  // the last entry whose first chunk is <= c
    const long long mid = (lo + hi + 1) / 2;
    if (__ldg(&segs[mid].chunk) <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long end = t.first + t.count;
  long long e = lo;
  for (; c < t.chunks; c += stride) {
    while (e + 1 < end && __ldg(&segs[e + 1].chunk) <= c) ++e;
    const Seg& g = segs[e];
    const long long bytes = __ldg(&g.bytes), slot = __ldg(&g.slot);
    const Merge mg =
        m.slots || held ? merges[e] : Merge{0, 0, 0, kMergeNone};
    const long long kind = mg.kind & ~kHold;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(__ldg(&g.src));
    const long long pitch = __ldg(&g.pitch);
    if (kind == kMergeRows) {  // the sub rows alone
      const long long cpr = (mg.rb + 15) / 16;
      const long long local = c - __ldg(&g.chunk);
      const long long j = local / cpr, o = (local % cpr) * 16;
      const long long r = slot_row(m, j);
      if (r < 0) continue;
      unsigned char* dst =
          slot < 0 ? reinterpret_cast<unsigned char*>(__ldg(&g.dst))
                   : reinterpret_cast<unsigned char*>(p->out[slot]) +
                         (__ldg(&g.row) * K + k) * m.n * mg.rb;
      dst += r * mg.rb;
      const long long last = min(o + 16, mg.rb);
      const unsigned char* sub =
          reinterpret_cast<const unsigned char*>(mg.sub) +
          (mg.pitch ? j * mg.pitch : j * mg.rb);
      if (!mg.pitch && last - o == 16 && aligned16(sub + o, dst + o, 0)) {
        *reinterpret_cast<int4*>(dst + o) =
            *reinterpret_cast<const int4*>(sub + o);
      } else {
        for (long long i = o; i < last; ++i) dst[i] = sub[i];
      }
      continue;
    }
    unsigned char* dst =
        slot < 0 ? reinterpret_cast<unsigned char*>(__ldg(&g.dst))
                 : reinterpret_cast<unsigned char*>(p->out[slot]) +
                       (__ldg(&g.row) * K + k) * bytes;
    const long long off = (c - __ldg(&g.chunk)) * 16;
    const long long last = min(off + 16, bytes);
    const bool holds = held && (mg.kind & kHold);
    if (kind == kMerged || holds) {
      // rows the map names come from the sub rows; held rows stay
      const long long r0 = off / mg.rb, r1 = (last - 1) / mg.rb;
      bool hit = holds && any_held(held, r0, r1);
      for (long long j = 0; kind == kMerged && j < m.slots && !hit; ++j) {
        const long long r = slot_row(m, j);
        hit = r >= r0 && r <= r1;
      }
      if (hit) {
        const long long elem = pitch ? __ldg(&g.elem) : 1;
        for (long long i = off; i < last; ++i) {
          const long long r = i / mg.rb;
          if (holds && held[r]) continue;
          const long long js = kind == kMerged ? slot_of(m, r) : -1;
          dst[i] = js >= 0 ? sub_byte(mg, js, i % mg.rb)
                           : src[pitch ? i / elem * pitch + i % elem : i];
        }
        continue;
      }
    }
    if (pitch != 0) {  // elements of elem bytes (dividing 16), pitch apart
      const long long elem = __ldg(&g.elem);
      for (long long i = off; i < last; i += elem) {
        const unsigned char* s = src + i / elem * pitch;
        for (long long j = 0; j < elem; ++j) dst[i + j] = s[j];
      }
    } else if (off + 16 <= bytes && aligned16(src, dst, 0)) {
      *reinterpret_cast<int4*>(dst + off) =
          __ldcs(reinterpret_cast<const int4*>(src + off));
    } else {
      for (long long i = off; i < last; ++i) dst[i] = src[i];
    }
  }
}

// slot_gather's leaves a launch (kernels/schedule.py SLOT_LEAVES).
constexpr int kMaxLeaves = 32;
// slot_gather's grid (kernels/schedule.py GATHER_*): a warp-unit is a
// lane's 16 bytes across a warp, 512 bytes of one leaf's row; a warp takes
// kGatherSpan of them, a CTA kGatherWarps warps' worth.
constexpr int kWarpBytes = 32 * 16;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherSpan = 1;

// slot_gather's arguments, by value (kernels/schedule.py _GatherArgs
// mirrors it): the slots, the mode leaf (i32, ``mode_pitch`` elements a
// stream), the keep flags written and their rule (escape: idx < n alone,
// the escape fallback's; else also not in CS, the bucket's); a leaf each:
// its source, its sub rows, its row bytes and, for a 1-D strided source,
// its element stride in bytes (0: contiguous).  ``warps`` and ``first``
// (leaf e's first warp-unit in a slot's run) the launcher fills.  ``at``
// (or null): a word holding the chunk c, the slots then being idx[c *
// slots, (c + 1) * slots), which ``slots_out`` (or null) receives;
// ``src_at`` (or null: every leaf at ``src``): a word holding leaf
// ``src_leaf``'s source address when the kernel runs (the tick's frames,
// read in place).
struct GatherArgs {
  const long long* idx;
  const int* mode;
  unsigned char* keep;
  long long n, mode_pitch;
  int slots, leaves, escape, warps;
  const unsigned char* src[kMaxLeaves];
  unsigned char* dst[kMaxLeaves];
  long long rb[kMaxLeaves];
  long long pitch[kMaxLeaves];
  int first[kMaxLeaves];
  const long long* at;
  long long* slots_out;
  const long long* src_at;
  long long src_leaf;
};

// One lane's unit: up to 16 bytes of a row, as one vector (16-aligned,
// whole), 4-byte words (4-aligned) or bytes, held in registers between
// the loads and the stores.
struct Unit {
  unsigned w[4];
  unsigned char* dst;
  int bytes, kind;  // kind 2 vector, 1 words, 0 bytes; bytes 0: none
};

__device__ __forceinline__ void unit_load(Unit& u,
                                          const unsigned char* src) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(u.dst);
  if (u.bytes == 16 && (align & 15) == 0) {
    u.kind = 2;
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    u.w[0] = v.x;
    u.w[1] = v.y;
    u.w[2] = v.z;
    u.w[3] = v.w;
  } else if ((u.bytes & 3) == 0 && (align & 3) == 0) {
    u.kind = 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * k < u.bytes) u.w[k] = reinterpret_cast<const unsigned*>(src)[k];
    }
  } else {
    u.kind = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) u.w[k] = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < u.bytes) u.w[k >> 2] |= static_cast<unsigned>(src[k])
                                      << (8 * (k & 3));
    }
  }
}

__device__ __forceinline__ void unit_store(const Unit& u) {
  if (u.kind == 2) {
    *reinterpret_cast<uint4*>(u.dst) =
        make_uint4(u.w[0], u.w[1], u.w[2], u.w[3]);
  } else if (u.kind == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * k < u.bytes) reinterpret_cast<unsigned*>(u.dst)[k] = u.w[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < u.bytes) u.dst[k] =
          static_cast<unsigned char>(u.w[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// The grid: x over a slot's run of warp-units (every leaf's row cut into
// warp-units of kWarpBytes, a leaf starting a warp-unit of its own, so a
// warp's lanes share a leaf), y the slot.  Each warp finds its units'
// leaves while idx[j] loads (a binary search for the last leaf whose first
// warp-unit is at or before the unit, a leaf of no bytes passed over),
// then loads every unit of its span before it stores any.  Row
// min(idx[j], n - 1) of each leaf goes to row j of its sub rows; CTA
// (0, j) also writes keep[j]: idx[j] < n and, under the bucket's rule,
// that row's mode not CS (the reference's ``valid``).
__global__ void __launch_bounds__(kGatherThreads)
    slot_gather_kernel(const __grid_constant__ GatherArgs a) {
  const long long j = blockIdx.y;
  const long long* idx = a.at ? a.idx + *a.at * a.slots : a.idx;
  const long long i = idx[j];
  const int lane = threadIdx.x & 31;
  const int q0 =
      (blockIdx.x * kGatherWarps + (threadIdx.x >> 5)) * kGatherSpan;
  int leaf[kGatherSpan];
  long long off[kGatherSpan];
#pragma unroll
  for (int v = 0; v < kGatherSpan; ++v) {
    const int q = q0 + v;
    int lo = 0, hi = a.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.first[mid] <= q) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    leaf[v] = q < a.warps ? lo : -1;
    off[v] = leaf[v] < 0 ? 0
                         : static_cast<long long>(q - a.first[leaf[v]]) *
                                   kWarpBytes + 16 * lane;
  }
  const long long r = i < a.n - 1 ? i : a.n - 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.keep[j] = i < a.n && (a.escape || a.mode[r * a.mode_pitch] != kModeCS);
    if (a.slots_out) a.slots_out[j] = i;
  }
  Unit u[kGatherSpan];
#pragma unroll
  for (int v = 0; v < kGatherSpan; ++v) {
    u[v].bytes = 0;
    const int e = leaf[v];
    if (e < 0) continue;
    const long long rb = a.rb[e];
    if (off[v] >= rb) continue;
    u[v].bytes = static_cast<int>(rb - off[v] < 16 ? rb - off[v] : 16);
    u[v].dst = a.dst[e] + j * rb + off[v];
    const unsigned char* src =
        a.src_at && e == a.src_leaf
            ? reinterpret_cast<const unsigned char*>(*a.src_at)
            : a.src[e];
    unit_load(u[v], src + (a.pitch[e] ? r * a.pitch[e] : r * rb) + off[v]);
  }
#pragma unroll
  for (int v = 0; v < kGatherSpan; ++v) {
    if (u[v].bytes) unit_store(u[v]);
  }
}

// The launcher's side of ``a``: each leaf's first warp-unit and a slot's
// warp-units.  Returns the grid's x (kernels/schedule.py gather_ctas
// mirrors it), or -1 where a row's bytes are negative or too many.
int gather_layout(GatherArgs* a) {
  long long w = 0;
  for (int e = 0; e < a->leaves; ++e) {
    if (a->rb[e] < 0) return -1;
    a->first[e] = static_cast<int>(w);
    w += (a->rb[e] + kWarpBytes - 1) / kWarpBytes;
    if (w > (1 << 30)) return -1;
  }
  a->warps = static_cast<int>(w);
  const long long per = kGatherWarps * kGatherSpan;
  const long long x = (w + per - 1) / per;
  return static_cast<int>(x < 1 ? 1 : x);
}

// A select's arguments: n streams, cap slots, a scratch buffer of
// ``bytes`` (select_scratch_bytes).
bool check_select(int n, int cap, const void* scratch, long long bytes) {
  return select_ok(n, cap) && scratch != nullptr &&
         bytes >= select_scratch(n, cap);
}

bool check_tick(int n, int kb, int cap) {
  return kb >= 1 && cap >= kb && cap % kb == 0 && cap <= n &&
         cap / kb + 3 <= kMaxHandles;
}

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
  kMode, kAge, kIdx, kAgeOut, kParams, kN, kKb, kCap, kRotate, kEscAt, kEidx,
  kEb, kFrameBytes, kTables, kSegs, kCommitCtas, kFew, kMany, kSelScratch,
  kSelBytes, kEscScratch, kEscBytes, kMerges, kMaps, kElist, kChunkRows,
  kListLen, kTail, kTailRows, kNumArgs
};

// scan_commit's arguments: its tables and their entries, the held rows'
// flags (or null) and its grid.
struct Commit {
  const Table* tables;
  const Seg* segs;
  const Merge* merges;
  const SlotMap* maps;
  const long long* hold;
  int ctas;
};

int add_commit(cudaGraphNode_t* node, cudaGraph_t g,
               const cudaGraphNode_t* deps, size_t ndeps, Params* p,
               Commit c, int table, cudaGraphConditionalHandle loop = 0,
               cudaGraphConditionalHandle loop2 = 0, int chunk = kChunkNone) {
  void* args[] = {&p,      &c.tables, &c.segs, &c.merges, &c.maps,
                  &c.hold, &table,    &loop,   &loop2,    &chunk};
  return add_kernel(node, g, deps, ndeps,
                    reinterpret_cast<void*>(scan_commit_kernel),
                    dim3(c.ctas), dim3(kCopyThreads), args);
}

// What a body's IF graph runs: the body ``g``, then (``after``, the few
// body's) scan_commit of the tick body's table and of table
// ``after_table``, the body's sub-batch rows.
int add_body(cudaGraphNode_t* node, cudaGraph_t parent,
             const cudaGraphNode_t* dep, cudaGraphConditionalHandle h,
             cudaGraph_t g, Params* p, const Commit* after, int after_table) {
  cudaGraph_t bb;
  int rc = add_conditional(node, parent, dep, 1, h, cudaGraphCondTypeIf, &bb);
  if (rc) return rc;
  cudaGraphNode_t inner;
  TRY(cudaGraphAddChildGraphNode(&inner, bb, nullptr, 0, g));
  if (after) {
    cudaGraphNode_t tick, rows;
    rc = add_commit(&tick, bb, &inner, 1, p, *after, kTableTick);
    if (rc) return rc;
    rc = add_commit(&rows, bb, &tick, 1, p, *after, after_table);
    if (rc) return rc;
  }
  return 0;
}

// A WHILE node on ``loop`` after ``dep`` whose body runs the chunk body
// ``g`` and then scan_commit of table ``table`` (its kept rows), which
// steps the loop (``chunk``: kChunkNext or kTailNext).
int add_chunks(cudaGraphNode_t* node, cudaGraph_t parent,
               const cudaGraphNode_t* dep, cudaGraphConditionalHandle loop,
               cudaGraph_t g, Params* p, const Commit& rows, int table,
               int chunk) {
  cudaGraph_t cb;
  int rc = add_conditional(node, parent, dep, 1, loop,
                           cudaGraphCondTypeWhile, &cb);
  if (rc) return rc;
  cudaGraphNode_t inner, commit;
  TRY(cudaGraphAddChildGraphNode(&inner, cb, nullptr, 0, g));
  return add_commit(&commit, cb, &inner, 1, p, rows, table, loop, 0, chunk);
}

// The many escape body's IF graph: scan_commit of the tick body's table
// with the escaped streams' state rows held (``held``), which starts the
// chunk loops, then a WHILE node over the big chunks (the body ``g``,
// gathering chunk p->chunk of escape_select's list from the state and
// tick k's frames, and scan_commit of table ``table``, its kept rows),
// then one over the small chunks (``gs``, chunk p->tail, table ``table``
// + 1).
int add_many(cudaGraphNode_t* node, cudaGraph_t parent,
             const cudaGraphNode_t* dep, cudaGraphConditionalHandle h,
             cudaGraph_t g, cudaGraph_t gs, Params* p, const Commit& held,
             const Commit& rows, int table) {
  cudaGraph_t bb;
  int rc = add_conditional(node, parent, dep, 1, h, cudaGraphCondTypeIf, &bb);
  if (rc) return rc;
  cudaGraphConditionalHandle big, small;
  TRY(cudaGraphConditionalHandleCreate(&big, bb, 0,
                                       cudaGraphCondAssignDefault));
  TRY(cudaGraphConditionalHandleCreate(&small, bb, 0,
                                       cudaGraphCondAssignDefault));
  cudaGraphNode_t tick, wbig, wsmall;
  rc = add_commit(&tick, bb, nullptr, 0, p, held, kTableTick, big, small,
                  kChunkStart);
  if (rc) return rc;
  rc = add_chunks(&wbig, bb, &tick, big, g, p, rows, table, kChunkNext);
  if (rc) return rc;
  return add_chunks(&wsmall, bb, &wbig, small, gs, p, rows, table + 1,
                    kTailNext);
}

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
  long long frame_bytes = a[kFrameBytes];
  Handles hl = no_handles();
  hl.n = 1;
  hl.h[0] = loop;

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
  unsigned char* sel_scratch =
      reinterpret_cast<unsigned char*>(a[kSelScratch]);
  const SelGrid sg = select_grid(n, cap);
  int span = sg.span;
  void* sel_args[] = {&mode, &age, &n, &kb, &cap, &rotate, &span, &idx,
                      &age_out, &p, &sel_scratch, &frame_bytes, &hs, &hl};
  cudaGraphNode_t sel;
  rc = add_kernel(&sel, body, nullptr, 0,
                  reinterpret_cast<void*>(tick_select_kernel), dim3(sg.ctas),
                  dim3(kSelThreads), sel_args);
  if (rc) return rc;
  for (int b = 0; b < nb; ++b) {
    rc = add_body(&ifs[b], body, &sel, hb[b],
                  reinterpret_cast<cudaGraph_t>(bodies[b]), p, nullptr, 0);
    if (rc) return rc;
  }

  const Commit commit_args = {reinterpret_cast<const Table*>(a[kTables]),
                              reinterpret_cast<const Seg*>(a[kSegs]),
                              reinterpret_cast<const Merge*>(a[kMerges]),
                              reinterpret_cast<const SlotMap*>(a[kMaps]),
                              nullptr, static_cast<int>(a[kCommitCtas])};
  // the escape fallback, where a band is on
  cudaGraphNode_t tail[2];
  const cudaGraphNode_t* last = ifs;
  size_t nlast = nb;
  if (a[kEscAt] != 0) {
    const unsigned char* esc = nullptr;
    const long long* esc_at = reinterpret_cast<const long long*>(a[kEscAt]);
    Commit held = commit_args;
    held.hold = esc_at;
    long long* eidx = reinterpret_cast<long long*>(a[kEidx]);
    long long* elist = reinterpret_cast<long long*>(a[kElist]);
    int chunk_rows = static_cast<int>(a[kChunkRows]);
    int tail_rows = static_cast<int>(a[kTailRows]);
    long long list_len = a[kListLen];
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
    unsigned char* esc_scratch =
        reinterpret_cast<unsigned char*>(a[kEscScratch]);
    const SelGrid eg = select_grid(n, eb);
    int espan = eg.span;
    void* esel_args[] = {&esc,   &esc_at, &n,           &eb,
                         &espan, &eidx,   &p, &esc_scratch, &he,
                         &elist, &tail_rows, &chunk_rows, &list_len};
    cudaGraphNode_t esel;
    rc = add_kernel(&esel, body, ifs, nb,
                    reinterpret_cast<void*>(escape_select_kernel),
                    dim3(eg.ctas), dim3(kSelThreads), esel_args);
    if (rc) return rc;
    nlast = 0;
    if (few) {
      rc = add_body(&tail[nlast], body, &esel, hf,
                    reinterpret_cast<cudaGraph_t>(a[kFew]), p, &commit_args,
                    nb);
      if (rc) return rc;
      ++nlast;
    }
    rc = add_many(&tail[nlast], body, &esel, hm,
                  reinterpret_cast<cudaGraph_t>(a[kMany]),
                  reinterpret_cast<cudaGraph_t>(a[kTail]), p, held,
                  commit_args, nb + 1);
    if (rc) return rc;
    ++nlast;
    last = tail;
  }

  cudaGraphNode_t commit;
  rc = add_commit(&commit, body, last, nlast, p, commit_args, kTablePick);
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

// The scratch bytes a select of n streams and cap slots needs (under 17
// MB: 1,048,576 streams at most), or -1 if the select takes no such n.
extern "C" int select_scratch_bytes(int n, int cap) {
  return select_ok(n, cap) ? static_cast<int>(select_scratch(n, cap)) : -1;
}

extern "C" int tick_select_launch(const void* mode, const void* age,
                                  void* idx, void* age_out, void* params,
                                  void* scratch, long long scratch_bytes,
                                  int n, int kb, int cap, int rotate,
                                  long long frame_bytes, void* stream) {
  if (!check_tick(n, kb, cap) ||
      !check_select(n, cap, scratch, scratch_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SelGrid g = select_grid(n, cap);
  tick_select_kernel<<<g.ctas, kSelThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mode), static_cast<const int*>(age), n, kb, cap,
      rotate, g.span, static_cast<long long*>(idx), static_cast<int*>(age_out),
      static_cast<Params*>(params), static_cast<unsigned char*>(scratch),
      frame_bytes, no_handles(), no_handles());
  return static_cast<int>(cudaGetLastError());
}

// elist: null, or ``len`` slots (a multiple of the big chunk mb, itself
// one of the small chunk m >= 1; at least n) for the many body's list.
extern "C" int escape_select_launch(const void* esc, void* eidx, void* params,
                                    void* scratch, long long scratch_bytes,
                                    int n, int eb, void* elist, int m, int mb,
                                    long long len, void* stream) {
  if (!check_select(n, eb, scratch, scratch_bytes) ||
      (elist && (m < 1 || mb < m || mb % m || len < n || len % mb))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SelGrid g = select_grid(n, eb);
  escape_select_kernel<<<g.ctas, kSelThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(esc), nullptr, n, eb, g.span,
      static_cast<long long*>(eidx), static_cast<Params*>(params),
      static_cast<unsigned char*>(scratch), no_handles(),
      static_cast<long long*>(elist), m, mb, len);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel at the grid of a select of n streams and cap slots.
extern "C" int select_floor_launch(int n, int cap, void* stream) {
  if (!select_ok(n, cap)) return static_cast<int>(cudaErrorInvalidValue);
  select_floor_kernel<<<select_grid(n, cap).ctas, kSelThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Whole mode (rows null, nrows 0): ``bytes`` of the tick's frames; rows
// mode: rows[0, nrows) of ``bytes`` each, slots outside [0, n) skipped.
extern "C" int scan_step_launch(void* params, void* frames, long long bytes,
                                const void* rows, int nrows, int n,
                                void* stream) {
  if (bytes < 0 || (rows != nullptr) != (nrows > 0) || nrows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scan_step_kernel<<<dim3(step_ctas(bytes), rows ? nrows : 1), kCopyThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Params*>(params), static_cast<unsigned char*>(frames),
      bytes, static_cast<const long long*>(rows), n);
  return static_cast<int>(cudaGetLastError());
}

// tables (T, 4), segs (S, 8), merges (S, 4) and maps (T, 4) i64
// (kernels/schedule.py segments; merges and maps null: no merge or held
// leaf); hold: null, or the escaped flags' address a tick body (held rows,
// read at p->branch); table: the one to copy (>= 0), kTablePick to pick
// it as the program does from p->branch and p->esel, or kTableTick for the
// tick body's (p->branch); chunk: the chunk loops' step (kChunkNone,
// kChunkStart, kChunkNext, kTailNext; no handle set); ctas: the grid (a
// wave over the largest table).
extern "C" int scan_commit_launch(void* params, const void* tables,
                                  const void* segs, const void* merges,
                                  const void* maps, const void* hold,
                                  int table, int chunk, int ctas,
                                  void* stream) {
  if (tables == nullptr || segs == nullptr || ctas < 1 ||
      table < kTableTick || (merges == nullptr) != (maps == nullptr) ||
      chunk < kChunkNone || chunk > kTailNext) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scan_commit_kernel<<<ctas, kCopyThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<Params*>(params), static_cast<const Table*>(tables),
      static_cast<const Seg*>(segs), static_cast<const Merge*>(merges),
      static_cast<const SlotMap*>(maps),
      static_cast<const long long*>(hold), table, 0, 0, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slot_gather_args_bytes() { return sizeof(GatherArgs); }

// ``args`` (GatherArgs) valid for a launch: the grid's x (> 0), else -1.
int gather_check(GatherArgs* a) {
  if (a->slots < 1 || a->slots > 65535 || a->leaves < 1 ||
      a->leaves > kMaxLeaves || a->n < 1 || a->idx == nullptr ||
      a->mode == nullptr || a->keep == nullptr ||
      (a->src_at && (a->src_leaf < 0 || a->src_leaf >= a->leaves))) {
    return -1;
  }
  return gather_layout(a);
}

// The grid's x that slot_gather_launch takes for ``args``, or -1.
extern "C" int slot_gather_ctas(const void* args) {
  GatherArgs a = *static_cast<const GatherArgs*>(args);
  return gather_check(&a);
}

// The sub-batch rows of ``leaves`` leaves at ``slots`` slots, from ``args``
// (GatherArgs): a grid of (gather_layout's x, slots) CTAs.
extern "C" int slot_gather_launch(const void* args, void* stream) {
  GatherArgs a = *static_cast<const GatherArgs*>(args);
  const int x = gather_check(&a);
  if (x < 0) return static_cast<int>(cudaErrorInvalidValue);
  slot_gather_kernel<<<dim3(x, a.slots), kGatherThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sched_driver_version(void* out) {
  return static_cast<int>(cudaDriverGetVersion(static_cast<int*>(out)));
}

extern "C" int sched_program_build(const void* args, int nargs,
                                   const void* bodies, int nb, void* out) {
  const long long* a = static_cast<const long long*>(args);
  const int n = static_cast<int>(a[kN]);
  if (nargs != kNumArgs || nb < 1 || nb > kMaxHandles ||
      !check_tick(n, static_cast<int>(a[kKb]), static_cast<int>(a[kCap])) ||
      !check_select(n, static_cast<int>(a[kCap]),
                    reinterpret_cast<const void*>(a[kSelScratch]),
                    a[kSelBytes]) ||
      a[kTables] == 0 || a[kSegs] == 0 || a[kCommitCtas] < 1 ||
      (a[kEscAt] != 0 &&
       (a[kMerges] == 0 || a[kMaps] == 0 || a[kMany] == 0 ||
        a[kElist] == 0 || a[kTail] == 0 || a[kTailRows] < 1 ||
        a[kChunkRows] < a[kTailRows] || a[kChunkRows] % a[kTailRows] ||
        a[kListLen] < n || a[kListLen] % a[kChunkRows] ||
        !check_select(n, static_cast<int>(a[kEb]),
                      reinterpret_cast<const void*>(a[kEscScratch]),
                      a[kEscBytes])))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int version = 0;
  TRY(cudaDriverGetVersion(&version));
  if (version < kMinDriver) return -1;
  const unsigned long long* b = static_cast<const unsigned long long*>(bodies);
  for (int i = 0; i < nb + 3; ++i) {
    const unsigned long long g =
        i < nb ? b[i] : i < nb + 2 ? a[kFew + i - nb] : a[kTail];
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
