// One CUDA graph a step, composed from captured segments with conditional
// nodes: the counterpart of the device-side control flow of rso's jitted
// step (lax.while_loop for the GN and LM loops, lax.cond for
// detect_every's branch).
//
// rso_torch/graphs.py captures a step as segments (PyTorch CUDA graphs kept
// as cudaGraph_t: pre, a loop's block, mid, ...) and calls the entries
// below to build one graph from them: each segment becomes a child-graph
// node; a loop becomes a WHILE node whose body is the block's child node
// followed by `set_cond_kernel`, which sets the node's handle from the flag
// the block computed on the device (true while the loop runs); a branch of
// the step becomes an IF node, its handle set from a predicate computed on
// the device.  The composed graph is instantiated once and launched once a
// step on PyTorch's current stream: no host read inside the step.
//
// Each set_cond_kernel may also add one to a 64-bit counter where the
// handle's new value is true: the number of blocks a loop ran, or the times
// a branch was taken.  rso_torch.graphs.settle_launches reads the counters
// (not a step's control flow) to add the kernel launches inside the
// conditional nodes to rso_torch.kernels.LAUNCHES.
//
// The graph's stage clock is here too: `stage_mark_kernel`, a one-thread
// kernel that rso_torch.metrics.profiler.StageClock launches at the stage
// boundaries of a step captured while marks are on (rso_torch.engine and
// robust_gn name the stages).  A mark reads %globaltimer, charges the
// nanoseconds since the previous mark to the previous mark's stage and
// counts one for its own; the `end` mark (stage -1) charges the last
// interval and opens nothing, so the time between two launches of the graph
// is never charged.  A kernel node, it goes anywhere a kernel can: into a
// WHILE node's body too, where an event-record node cannot.
//
// Needs CUDA 12.4 or later (conditional WHILE nodes, child graphs in a
// conditional body) in the toolkit and in libcuda.  Every entry returns the
// cudaError_t of its last call.  The graphs PyTorch captured are cudaGraph_t
// handles of the same CUDA context; a child-graph node clones its
// graph, so the memory its nodes address (PyTorch's graph pool) must
// outlive the composed graph, which the caller ensures.
#include <cuda_runtime.h>

namespace {

// Sets a conditional node's handle.  Where flag is null: handle = 1 (a
// loop's first block, or a node always taken) and *iter = 1.  Else handle =
// *flag, and where iter is not null also *iter < limit, counting *iter up
// where the handle stays set: a loop runs at most `limit` blocks whatever
// its flag says.  One more on *count where the handle is set.
__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const bool* flag, unsigned long long* count,
                                int* iter, int limit) {
  unsigned int value = 1u;
  if (flag == nullptr) {
    if (iter != nullptr) *iter = 1;
  } else {
    value = *flag ? 1u : 0u;
    if (iter != nullptr && value != 0u) {
      if (*iter >= limit) {
        value = 0u;
      } else {
        *iter += 1;
      }
    }
  }
  cudaGraphSetConditional(handle, value);
  if (count != nullptr && value != 0u) *count += 1ull;
}

// One mark of the stage clock.  clock is int64 [2, n + 1]: row 0 the
// nanoseconds of each of the n stages, row 1 its marks; column n holds the
// open stage's start (row 0, %globaltimer ns) and its index + 1 (row 1, 0
// where none is open).  stage -1 is the `end` mark.
__global__ void stage_mark_kernel(long long* clock, int n, int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* ns = clock;
  long long* marks = clock + n + 1;
  const long long open = marks[n];
  if (open > 0) ns[open - 1] += static_cast<long long>(now) - ns[n];
  if (stage >= 0) {
    marks[stage] += 1;
    ns[n] = static_cast<long long>(now);
    marks[n] = stage + 1;
  } else {
    marks[n] = 0;
  }
}

inline size_t n_deps(void* dep) { return dep == nullptr ? 0 : 1; }

// the entry's result; a failure is also cleared from cudaGetLastError, so
// that it does not surface again at the next kernel launch
int result(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int rso_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return result(e);
}

int rso_graph_destroy(void* graph) {
  return result(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
}

// a child-graph node of `child` (cloned) after `dep` (a node or null)
int rso_graph_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), dep ? &d : nullptr, n_deps(dep),
      static_cast<cudaGraph_t>(child));
  *node = n;
  return result(e);
}

// a new conditional handle of `graph` (default 0, set by a kernel before
// each use)
int rso_graph_add_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  const cudaError_t e = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), 0, 0);
  *handle = h;
  return result(e);
}

// a conditional node on `handle` (a handle of `graph`; IF, or WHILE where
// is_while) after `dep`; returns the node and its body graph
int rso_graph_add_cond(void* graph, void* dep, unsigned long long handle,
                       int is_while, void** node, void** body) {
  const cudaGraphConditionalHandle h = handle;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile
                                     : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e = cudaGraphAddNode(
      &n, static_cast<cudaGraph_t>(graph), dep ? &d : nullptr, n_deps(dep),
      &params);
  *node = n;
  *body = e == cudaSuccess ? params.conditional.phGraph_out[0] : nullptr;
  return result(e);
}

// a one-thread set_cond_kernel node after `dep` (flag, count and iter may
// be null)
int rso_graph_add_set(void* graph, void* dep, unsigned long long handle,
                      void* flag, void* count, void* iter, int limit,
                      void** node) {
  cudaGraphConditionalHandle h = handle;
  const bool* f = static_cast<const bool*>(flag);
  unsigned long long* c = static_cast<unsigned long long*>(count);
  int* it = static_cast<int*>(iter);
  int lim = limit;
  void* args[] = {&h, &f, &c, &it, &lim};
  cudaKernelNodeParams params = {};
  params.func = reinterpret_cast<void*>(set_cond_kernel);
  params.gridDim = dim3(1, 1, 1);
  params.blockDim = dim3(1, 1, 1);
  params.sharedMemBytes = 0;
  params.kernelParams = args;
  params.extra = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n = nullptr;
  const cudaError_t e = cudaGraphAddKernelNode(
      &n, static_cast<cudaGraph_t>(graph), dep ? &d : nullptr, n_deps(dep),
      &params);
  *node = n;
  return result(e);
}

int rso_graph_instantiate(void* graph, void** exec) {
  cudaGraphExec_t x = nullptr;
  const cudaError_t e =
      cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph), 0);
  *exec = x;
  return result(e);
}

// one stage_mark_kernel on `stream` (recorded where the stream captures)
int rso_stage_mark(void* clock, int n, int stage, void* stream) {
  stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), n, stage);
  return result(cudaGetLastError());
}

int rso_graph_exec_destroy(void* exec) {
  return result(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

int rso_graph_launch(void* exec, void* stream) {
  return result(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                static_cast<cudaStream_t>(stream)));
}

// counts[t] += the nodes of type t (cudaGraphNodeType) in `graph` and,
// recursively, in its child graphs; types past n - 1 count in counts[n - 1]
int rso_graph_node_types(void* graph, int* counts, int n) {
  size_t num = 0;
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr,
                                    &num);
  if (e != cudaSuccess || num == 0) return result(e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[num];
  e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nodes, &num);
  for (size_t i = 0; e == cudaSuccess && i < num; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    counts[(int)t < n ? (int)t : n - 1] += 1;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) {
        e = static_cast<cudaError_t>(rso_graph_node_types(child, counts, n));
      }
    }
  }
  delete[] nodes;
  return result(e);
}

}  // extern "C"
