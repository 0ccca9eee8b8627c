// A toy CUDA graph with conditional nodes nested three deep, as the serving
// program nests them (csrc/schedule.cu build): a WHILE node over ticks, an
// IF node in its body, a WHILE node over chunks in the IF node's body.
//
//   tick kernel   counts the tick, sets the IF handle (even ticks) and the
//                 outer loop's handle (ticks < K)
//   IF body       a start kernel sets the inner loop's handle (created in
//                 the IF body) to 1 and the chunk to 0, then the inner
//                 WHILE node, whose body's kernel counts a chunk and sets
//                 its handle (chunk < CHUNKS)
//   tail kernel   counts the ticks after the IF node
//
// Two launches of K ticks; prints what each counter holds against what
// it should and exits 1 if one differs or a call fails.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 \
//     tools/nested_conditionals.cu -o build/nested_conditionals && \
//     build/nested_conditionals

#include <cstdio>
#include <cstring>
#include <cuda_runtime.h>

struct Counts {
  long long ticks, K, chunk, chunk_runs, tails, ifs;
};

constexpr long long kChunks = 3;

__global__ void tick_kernel(Counts* c, cudaGraphConditionalHandle hif,
                            cudaGraphConditionalHandle hloop) {
  const long long t = c->ticks++;
  cudaGraphSetConditional(hif, t % 2 == 0 ? 1u : 0u);
  cudaGraphSetConditional(hloop, c->ticks < c->K ? 1u : 0u);
}

__global__ void start_kernel(Counts* c, cudaGraphConditionalHandle hin) {
  c->ifs += 1;
  c->chunk = 0;
  cudaGraphSetConditional(hin, 1u);
}

__global__ void chunk_kernel(Counts* c, cudaGraphConditionalHandle hin) {
  c->chunk_runs += 1;
  c->chunk += 1;
  cudaGraphSetConditional(hin, c->chunk < kChunks ? 1u : 0u);
}

__global__ void tail_kernel(Counts* c) { c->tails += 1; }

#define CHECK(x)                                                       \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      printf("%s failed: %s\n", #x, cudaGetErrorString(e_));           \
      return 1;                                                        \
    }                                                                  \
  } while (0)

static cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t g,
                            const cudaGraphNode_t* deps, size_t ndeps,
                            cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  memset(raw, 0, sizeof raw);
  cudaGraphNodeParams& np = *reinterpret_cast<cudaGraphNodeParams*>(raw);
  np.type = cudaGraphNodeTypeConditional;
  np.conditional.handle = h;
  np.conditional.type = type;
  np.conditional.size = 1;
  cudaError_t e = cudaGraphAddNode(node, g, deps, ndeps, &np);
  if (e == cudaSuccess) *body = np.conditional.phGraph_out[0];
  return e;
}

static cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g,
                              const cudaGraphNode_t* deps, size_t ndeps,
                              void* fn, void** args) {
  cudaKernelNodeParams kp;
  memset(&kp, 0, sizeof kp);
  kp.func = fn;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, deps, ndeps, &kp);
}

int main() {
  int driver = 0, runtime = 0;
  CHECK(cudaDriverGetVersion(&driver));
  CHECK(cudaRuntimeGetVersion(&runtime));
  printf("driver %d, runtime %d\n", driver, runtime);
  Counts* c;
  CHECK(cudaMalloc(&c, sizeof(Counts)));
  cudaGraph_t g, loop_body, if_body, chunk_body;
  CHECK(cudaGraphCreate(&g, 0));
  cudaGraphConditionalHandle hloop, hif, hin;
  CHECK(cudaGraphConditionalHandleCreate(&hloop, g, 1,
                                         cudaGraphCondAssignDefault));
  cudaGraphNode_t wnode, tick, ifnode, start, inner, chunk, tail;
  CHECK(add_cond(&wnode, g, nullptr, 0, hloop, cudaGraphCondTypeWhile,
                 &loop_body));
  CHECK(cudaGraphConditionalHandleCreate(&hif, loop_body, 0,
                                         cudaGraphCondAssignDefault));
  void* tick_args[] = {&c, &hif, &hloop};
  CHECK(add_kernel(&tick, loop_body, nullptr, 0,
                   reinterpret_cast<void*>(tick_kernel), tick_args));
  CHECK(add_cond(&ifnode, loop_body, &tick, 1, hif, cudaGraphCondTypeIf,
                 &if_body));
  CHECK(cudaGraphConditionalHandleCreate(&hin, if_body, 0,
                                         cudaGraphCondAssignDefault));
  void* start_args[] = {&c, &hin};
  CHECK(add_kernel(&start, if_body, nullptr, 0,
                   reinterpret_cast<void*>(start_kernel), start_args));
  CHECK(add_cond(&inner, if_body, &start, 1, hin, cudaGraphCondTypeWhile,
                 &chunk_body));
  void* chunk_args[] = {&c, &hin};
  CHECK(add_kernel(&chunk, chunk_body, nullptr, 0,
                   reinterpret_cast<void*>(chunk_kernel), chunk_args));
  void* tail_args[] = {&c};
  CHECK(add_kernel(&tail, loop_body, &ifnode, 1,
                   reinterpret_cast<void*>(tail_kernel), tail_args));
  cudaGraphExec_t exec;
  CHECK(cudaGraphInstantiate(&exec, g, 0));
  const long long K = 5, launches = 2;
  Counts h;
  memset(&h, 0, sizeof h);
  CHECK(cudaMemcpy(c, &h, sizeof h, cudaMemcpyHostToDevice));
  for (int l = 0; l < launches; ++l) {
    Counts start_counts;
    CHECK(cudaMemcpy(&start_counts, c, sizeof h, cudaMemcpyDeviceToHost));
    start_counts.ticks = 0;
    start_counts.K = K;
    CHECK(cudaMemcpy(c, &start_counts, sizeof h, cudaMemcpyHostToDevice));
    CHECK(cudaGraphLaunch(exec, 0));
    CHECK(cudaDeviceSynchronize());
  }
  CHECK(cudaMemcpy(&h, c, sizeof h, cudaMemcpyDeviceToHost));
  const long long ifs = launches * ((K + 1) / 2);
  printf("ticks %lld (want %lld), tails %lld (want %lld), IF bodies %lld "
         "(want %lld), chunks %lld (want %lld)\n",
         h.ticks, K, h.tails, launches * K, h.ifs, ifs, h.chunk_runs,
         ifs * kChunks);
  const bool ok = h.ticks == K && h.tails == launches * K && h.ifs == ifs &&
                  h.chunk_runs == ifs * kChunks;
  printf("%s\n", ok ? "nested conditionals: OK" : "nested conditionals: FAIL");
  return ok ? 0 : 1;
}
